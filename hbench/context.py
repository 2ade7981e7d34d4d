"""What a metric's reader (``metrics/<name>.py``) can read.

* ``run``: the harness's own readings on the host clock: ``answered``
  (answers handed out in the window), ``window_s``, ``latencies`` (seconds
  from submit to answer of each request submitted in the window),
  ``build_s``, ``peak_bytes`` (the allocator's peak; None off a card) and
  ``setup_s``;
* ``spans``: the program's counters at both ends of each span, as
  ``(before, after)`` snapshots: ``"window"``, the measured window, and in
  a traced run ``"stretch"``, the traced stretch. A snapshot is the serving
  engine's whole ``telemetry()`` as a plain dict (``calls``,
  ``wave_calls``, ``latency``, ``paths``, ``pruning``, ``plan_cache``,
  ``serving``, ...) with each kernel wrapper's ``launches`` (by wrapper
  name) and ``launches_by`` (by wrapper name, then its own key);
* ``trace``: ``trace.summarize``'s reading of the stretch, or None in an
  untraced run;
* ``shape``: the cell's sizes (``slots``, ``rows``, ``n``, ``scan_block``,
  and for an index ``sax_words``, the iSAX sidecar's rows, and
  ``sax_segments``).
"""
from __future__ import annotations

from pathlib import Path

from hbench import peaks, spec, trace as trace_mod


def _at(snap, keys):
    for key in keys:
        snap = snap.get(key, 0) if isinstance(snap, dict) else 0
    return snap


class Context:
    def __init__(self, run: dict, spans: dict, trace: dict | None, shape: dict,
                 root: Path = spec.ROOT):
        self.run = run
        self.spans = spans
        self.trace = trace
        self.shape = shape
        self.root = root

    def delta(self, span: str, *keys):
        """A counter's growth over ``span``: its value at the path ``keys``
        in the closing snapshot less that in the opening one (a counter
        missing at one end counts 0)."""
        before, after = self.spans[span]
        return _at(after, keys) - _at(before, keys)

    def after(self, span: str, *keys):
        """A reading at the path ``keys`` in ``span``'s closing snapshot."""
        return _at(self.spans[span][1], keys)

    def roofline(self, kernel: str):
        return spec.roofline(kernel, self.root)

    def kernel_seconds(self, names: tuple[str, ...]) -> float:
        return trace_mod.kernel_seconds(self.trace, names) if self.trace else 0.0

    @staticmethod
    def bound_seconds(nbytes: float, ops: float) -> float:
        return peaks.bound_seconds(nbytes, ops)

    def scan_calls(self) -> tuple[int, int] | None:
        """(k=1 calls, k>1 calls) of the dense scan in the traced stretch,
        from its launches: one ``ed_min`` a k=1 call, one ``ed_matrix`` a
        ``scan_block`` rows a k>1 call. None where they do not add up to
        the stretch's calls, or nothing was traced."""
        if "stretch" not in self.spans:
            return None
        blocks = -(-self.shape["rows"] // self.shape["scan_block"])
        k1 = self.delta("stretch", "launches", "ed_min")
        mat = self.delta("stretch", "launches", "ed_matrix")
        if mat % blocks or k1 + mat // blocks != self.delta("stretch", "calls"):
            return None
        return k1, mat // blocks
