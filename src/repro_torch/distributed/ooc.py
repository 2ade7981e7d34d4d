"""Sharded out-of-core serving: one on-disk index, one reader a shard.

Port of ``repro/distributed/ooc.py``. ``DistOutOfCoreBackend`` (registry
name ``dist-ooc``) serves one committed base generation from several
shards at once. The shard plan (``repro_torch.storage.partition``) cuts
the file into contiguous leaf-run row ranges balanced by row count; each
shard then

* reads **only its own** LRD/LSD/enc row range: the :class:`_ShardRows`
  views translate shard-local row slices to absolute file rows, *refuse*
  anything outside the shard's range, and record the absolute rows touched
  (``stats()["dist"]["rows_touched"]``), so tests assert residency
  confinement instead of trusting it;
* descends the shared resident tree and streams its own leaf runs as a full
  :class:`~repro_torch.core.engine.OutOfCoreLocalBackend` over its range
  view, on its own device, so the codec-certified stream and the wave
  plan's run schedule come along;
* runs on its own worker thread (name prefix ``repro-dist-shard``) and, on
  a CUDA device, its own ``torch.cuda.Stream``; the worker synchronizes
  that stream before it hands its answer back, so the merge never reads a
  tensor another stream is still writing.

The per-shard (dists, positions, ids) answers merge through
:func:`repro_torch.distributed.search.merge_shard_topk`: a stable sort of
the shard-major concatenation. Shards partition the file into ascending
contiguous ranges and each shard's answer is the exact top-k of its range
in the difference form of every other backend, so equal distances resolve
toward the lower file position, as the single-host fold does: distances,
positions and ids equal ``LocalBackend``'s and ``ooc-local``'s bit for bit
for every shard count, codec, reader and wave flag. Only telemetry differs.
"""
from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.analysis.sanitize import lockdep_task
from repro_torch.core import summaries as S
from repro_torch.core.engine import OutOfCoreLocalBackend, _OutOfCoreBase
from repro_torch.core.search import INF, SearchConfig
from repro_torch.device import shard_devices
from repro_torch.distributed.search import merge_shard_topk
from repro_torch.storage.partition import ShardPlan, shard_plan

THREAD_PREFIX = "repro-dist-shard"


class _ShardRows:
    """Row-range view of one mapped base file, in shard-local coordinates.

    The chunk readers only take contiguous row slices
    (``rows[start:start+count]``); this proxy translates them to absolute
    file rows, raises on anything outside ``[row_lo, row_hi)``, and records
    the absolute extremes touched into ``audit`` (a shared two-element
    ``[lo, hi)`` list). ``take`` is the copying gather the codec re-check
    needs (``np.take`` dispatches to it; advanced indexing on a memmap
    always copies).
    """

    def __init__(self, base, row_lo: int, row_hi: int, audit: list):
        self._base = base
        self._lo = int(row_lo)
        self._hi = int(row_hi)
        self._audit = audit

    @property
    def shape(self) -> tuple:
        return (self._hi - self._lo,) + tuple(self._base.shape[1:])

    @property
    def dtype(self):
        return self._base.dtype

    def __len__(self) -> int:
        return self._hi - self._lo

    def _record(self, a: int, b: int) -> None:
        if b > a:
            self._audit[0] = min(self._audit[0], a)
            self._audit[1] = max(self._audit[1], b)

    def _absolute(self, start: int, stop: int) -> tuple[int, int]:
        rows = self._hi - self._lo
        if not 0 <= start <= stop <= rows:
            raise IndexError(
                f"rows [{start}, {stop}) escape the shard's range view "
                f"(local rows [0, {rows}) = file rows [{self._lo}, {self._hi}))")
        a, b = self._lo + start, self._lo + stop
        self._record(a, b)
        return a, b

    def __getitem__(self, idx):
        if not isinstance(idx, slice):
            raise TypeError(f"_ShardRows supports contiguous row slices, got {idx!r}")
        start, stop, step = idx.indices(self._hi - self._lo)
        if step != 1:
            raise IndexError(f"_ShardRows slices must be contiguous (step={step})")
        a, b = self._absolute(start, stop)
        return self._base[a:b]

    def take(self, indices, axis: int = 0, out=None, mode: str = "raise"):
        """Copying gather of shard-local rows (``np.take`` dispatches here):
        the result never aliases the file."""
        if axis != 0 or out is not None or mode != "raise":
            raise ValueError(
                f"_ShardRows.take supports axis=0/out=None/mode='raise'; got "
                f"axis={axis}, out={out!r}, mode={mode!r}")
        idx = np.asarray(indices, np.int64)
        rows = self._hi - self._lo
        if idx.size:
            lo, hi = int(idx.min()), int(idx.max())
            if lo < 0 or hi >= rows:
                raise IndexError(f"take indices [{lo}, {hi}] escape the shard's "
                                 f"{rows}-row range view")
            self._record(self._lo + lo, self._lo + hi + 1)
        return self._base[idx + self._lo]


@dataclasses.dataclass
class _ShardView:
    """A ``SavedIndex``-shaped window onto one shard of an opened index.

    Leaf tables are sliced to the shard's leaf run and re-based to
    shard-local rows and ranks; the tree stays the shared one (the
    node -> leaf-rank table maps out-of-shard leaves to -1, so a query
    whose home leaf another shard owns seeds nothing here). The big files
    surface as :class:`_ShardRows` range views: "this reader cannot leave
    its shard" is a property of the structure, not a convention.
    """
    path: str
    manifest: dict
    config: object
    max_depth: int
    tree: object
    small: dict
    codec: str
    series_len: int
    max_leaf: int
    num_leaves: int
    num_series: int
    row_lo: int
    row_hi: int
    _parent: object = dataclasses.field(repr=False, default=None)
    _audit: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def of(cls, saved, plan: ShardPlan, shard: int) -> "_ShardView":
        leaf_lo, leaf_hi = plan.leaf_range(shard)
        row_lo, row_hi = plan.row_range(shard)
        s = saved.small
        lr = np.asarray(s["leaf_rank"])
        local_rank = np.where((lr >= leaf_lo) & (lr < leaf_hi),
                              lr - leaf_lo, -1).astype(lr.dtype)
        small = {
            "perm": np.asarray(s["perm"])[row_lo:row_hi],
            "leaf_rank": local_rank,
            "leaf_start": np.asarray(s["leaf_start"])[leaf_lo:leaf_hi] - row_lo,
            "leaf_count": np.asarray(s["leaf_count"])[leaf_lo:leaf_hi],
            "leaf_synopsis": np.asarray(s["leaf_synopsis"])[leaf_lo:leaf_hi],
            "leaf_endpoints": np.asarray(s["leaf_endpoints"])[leaf_lo:leaf_hi],
            "leaf_seg_lens": np.asarray(s["leaf_seg_lens"])[leaf_lo:leaf_hi],
            "series_leaf_rank": np.asarray(s["series_leaf_rank"])[row_lo:row_hi]
            - leaf_lo,
        }
        return cls(
            path=saved.path, manifest=saved.manifest, config=saved.config,
            max_depth=saved.max_depth, tree=saved.tree, small=small,
            codec=saved.codec, series_len=saved.series_len,
            # max_leaf stays global: every shard pads its fetches to the
            # same bucket shapes
            max_leaf=saved.max_leaf,
            num_leaves=leaf_hi - leaf_lo, num_series=row_hi - row_lo,
            row_lo=row_lo, row_hi=row_hi, _parent=saved)

    @property
    def n_pad(self) -> int:
        return self.row_hi - self.row_lo

    def _mapped(self, name: str) -> _ShardRows:
        audit = self._audit.setdefault(name, [self.row_hi, self.row_lo])
        return _ShardRows(self._parent._mapped(name), self.row_lo, self.row_hi,
                          audit)

    def rows_touched(self) -> tuple[int, int] | None:
        """Absolute ``[lo, hi)`` file rows this shard's readers touched so
        far, across lrd/lsd/enc; ``None`` before the first read."""
        lo = min((a[0] for a in self._audit.values()), default=self.row_hi)
        hi = max((a[1] for a in self._audit.values()), default=self.row_lo)
        if hi <= lo:
            return None
        return lo, hi


class DistOutOfCoreBackend(_OutOfCoreBase):
    """Sharded out-of-core serving over one saved index (see the module
    docs).

    The shards are ``devices`` (one entry a shard, repeats allowed), or
    ``shards`` shards placed round-robin over the visible CUDA devices, or
    all on the CPU when ``device`` is the CPU (default: one shard a visible
    card, one on the CPU). ``memory_budget_mb`` is **per shard**: each
    shard's readers keep their own two blocks in flight. The merged answer
    lives on the first shard's device.
    """

    name = "dist-ooc"

    def __init__(self, saved, config: SearchConfig | None = None,
                 memory_budget_mb: float = 64.0, *, shards: int | None = None,
                 devices=None, device: str | torch.device | None = None):
        devs = shard_devices(shards, devices, device)
        super().__init__(saved, config, memory_budget_mb, devs[0])
        self.devices = devs
        self.num_shards = len(devs)
        self.plan = shard_plan(saved, self.num_shards)
        self._views = [_ShardView.of(saved, self.plan, i)
                       for i in range(self.num_shards)]
        self._subs = [OutOfCoreLocalBackend(v, self._config, memory_budget_mb, dev)
                      for v, dev in zip(self._views, devs)]
        self._streams = [torch.cuda.Stream(dev) if dev.type == "cuda" else None
                         for dev in devs]
        # folded into the engine's plan-cache key: a plan bound for one
        # shard layout must not serve another
        self.plan_signature = (self.name, self.num_shards,
                               tuple(str(d) for d in devs))

    # -- plans ---------------------------------------------------------------

    def _validate(self, cfg: SearchConfig) -> None:
        for sub in self._subs:
            sub._validate(cfg)

    def _bind(self, cfg):
        return self._fan_plan(cfg, wave=False)

    def make_wave_plan(self, cfg: SearchConfig, bucket: int):
        return self._fan_plan(cfg, wave=True, bucket=bucket)

    def _fan_plan(self, cfg: SearchConfig, wave: bool, bucket: int = 0):
        plans = [(i, sub.make_wave_plan(cfg, bucket) if wave else sub._bind(cfg))
                 for i, sub in enumerate(self._subs)
                 if self._views[i].num_series > 0]
        valid_aware = any(getattr(p, "valid_aware", False) for _, p in plans)

        def run(q, valid_rows=None):
            return self._fan_out(q, cfg, plans, valid_rows)

        run.valid_aware = valid_aware
        return run

    def estimate_difficulty(self, queries: torch.Tensor) -> np.ndarray | None:
        scores = [sub.estimate_difficulty(queries.to(sub.device))
                  for i, sub in enumerate(self._subs)
                  if self._views[i].num_leaves > 0]
        if not scores:
            return None
        return np.max(np.stack([np.asarray(s) for s in scores]), axis=0)

    # -- the fan-out and the merge ------------------------------------------

    def _run_shard(self, shard: int, plan, q, valid_rows):
        """One shard's stream on its device and its own CUDA stream; the
        stream is synchronized before the answer is handed back."""
        stream = self._streams[shard]
        with contextlib.ExitStack() as ctx:
            if stream is not None:
                ctx.enter_context(torch.cuda.stream(stream))
            if getattr(plan, "valid_aware", False):
                res = plan(q, valid_rows=valid_rows)
            else:
                res = plan(q)
            if stream is not None:
                stream.synchronize()
        return res

    def _fan_out(self, q: torch.Tensor, cfg: SearchConfig, plans, valid_rows):
        k = cfg.k
        qn = q.shape[0]
        dev = self.device
        q_on = {}
        for i, _ in plans:
            d = self.devices[i]
            if d not in q_on:
                q_on[d] = q.to(d)
            if self._streams[i] is not None:
                # the shard's stream starts after everything queued so far
                # on its device (the queries, freed blocks it may reuse)
                self._streams[i].wait_stream(torch.cuda.current_stream(d))
        jobs = [(i, p, q_on[self.devices[i]]) for i, p in plans]
        if len(jobs) > 1:
            # one worker a shard: the shards' reads and refines overlap.
            # Under REPRO_SANITIZE=1 lockdep asserts each work item enters
            # and leaves lock-free: pool threads are recycled, so a carried
            # lock would deadlock a later, unrelated item
            run = lockdep_task(lambda job: self._run_shard(job[0], job[1], job[2],
                                                           valid_rows),
                               name="dist-ooc-shard")
            with ThreadPoolExecutor(max_workers=len(jobs),
                                    thread_name_prefix=THREAD_PREFIX) as pool:
                results = list(pool.map(run, jobs))
        else:
            results = [self._run_shard(i, p, qs, valid_rows) for i, p, qs in jobs]

        by_shard = dict(zip((i for i, _ in plans), results))
        parts = []
        for s in range(self.num_shards):
            res = by_shard.get(s)
            if res is None:
                empty = torch.full((qn, k), -1, dtype=torch.int32, device=dev)
                parts.append((torch.full((qn, k), INF, device=dev), empty, empty))
                continue
            p = torch.where(res.positions >= 0,
                            res.positions + self._views[s].row_lo, -1)
            parts.append((res.dists, p, res.ids))
        md, mp, mi = merge_shard_topk(parts, k, dev)
        self._t["calls"] += 1

        # per-query telemetry: exact counters sum; pruning ratios recombine
        # from per-shard fractions weighted by what each shard could prune
        accessed = torch.zeros((qn,), dtype=torch.int32, device=dev)
        visited = torch.zeros((qn,), dtype=torch.int32, device=dev)
        alive_rows = torch.zeros((qn,), dtype=torch.float32, device=dev)
        alive_leaves = torch.zeros((qn,), dtype=torch.float32, device=dev)
        tot_rows = tot_leaves = 0
        for (i, _), res in zip(plans, results):
            v = self._views[i]
            accessed = accessed + res.accessed.to(dev)
            visited = visited + res.visited_leaves.to(dev)
            alive_rows = alive_rows + (1.0 - res.sax_pr.to(dev)) * v.num_series
            alive_leaves = alive_leaves + (1.0 - res.eapca_pr.to(dev)) * v.num_leaves
            tot_rows += v.num_series
            tot_leaves += v.num_leaves
        res = self._fill_result(md, mp, mi, path=2)
        return res._replace(
            accessed=accessed, visited_leaves=visited,
            eapca_pr=1.0 - S.div_rn(alive_leaves, max(tot_leaves, 1)),
            sax_pr=1.0 - S.div_rn(alive_rows, max(tot_rows, 1)))

    # -- introspection -------------------------------------------------------

    @staticmethod
    def _ratio(values) -> float:
        """max/min over per-shard counts, JSON-safe: an empty shard counts
        as one row, so a starved shard reads as a large finite ratio."""
        vals = [int(v) for v in values]
        if not vals or max(vals) == 0:
            return 1.0
        return max(vals) / max(min(vals), 1)

    def stats(self) -> dict:
        agg = dict(self._t)
        for sub in self._subs:
            for key, val in sub._t.items():
                agg[key] = agg.get(key, 0) + val
        agg["calls"] = self._t["calls"]  # one dist call, not one a shard
        per = lambda key: [sub._t[key] for sub in self._subs]  # noqa: E731
        streamed = per("rows_streamed")
        return {
            "num_series": self.saved.num_series,
            "series_len": self.saved.series_len,
            "memory_budget_mb": self.memory_budget_mb,
            "codec": self.saved.codec,
            **agg,
            "dist": {
                "shards": self.num_shards,
                "rows_streamed": streamed,
                "read_wait_seconds": per("read_wait_seconds"),
                "bytes_streamed": per("bytes_streamed"),
                "imbalance": self._ratio(streamed),
                "plan_rows": list(self.plan.shard_rows),
                "plan_imbalance": self._ratio(self.plan.shard_rows),
                "balance_warning": not self.plan.balanced,
                "row_range": [list(self.plan.row_range(s))
                              for s in range(self.num_shards)],
                "rows_touched": [list(t) if (t := v.rows_touched()) else None
                                 for v in self._views],
            },
        }

    def describe(self) -> dict:
        d = super().describe()
        d["devices"] = [str(dev) for dev in self.devices]
        return d
