#!/usr/bin/env python3
"""Hold an older build of one of the port's CUDA sources against this
checkout's on one CUDA card.

    python3 tools/kernel_ab.py --kernel ed|lb_sax|wkv6|wkv6_bwd|rg_lru --baseline OLD.cu \
        [--trial LABEL=WORDS ...] [--baseline-trial LABEL=WORDS ...] [--out FILE]
    python3 tools/kernel_ab.py --kernel dtw [--out FILE]

``--baseline`` is an older ``csrc/<kernel>.cu`` with the same C entry
points, for example the parent commit's (``git show
HEAD~1:src/repro_torch/kernels/csrc/lb_sax.cu`` into a gitignored
``build/`` path). It is compiled with the package's flags into a temporary
directory; the checkout's own build is the package's. Both are launched
through the package's wrappers (``repro_torch.kernels.ed``, ``.lb_sax``
or ``.wkv6``), the baseline by standing in for the package's loaded
library of that name. Each ``--trial LABEL=WORDS`` also builds the
checkout's source, a trial state that joins every bits check and timing:
a word that starts with ``-`` is an extra ``nvcc`` flag (``A=-DED_MIN_
TILES_ONLY``, ``C16=-DWKV_CHUNK=16``), a word ``NAME=VALUE`` sets the
source's ``constexpr int NAME`` in a copy of it (``c4=CK=4``; the copy
must hold exactly one such line). ``--baseline-trial LABEL=WORDS`` builds
the baseline's source so (``--kernel wkv6_bwd`` only; it and the v1
caller below serve the v1 baseline, and go with the next change to this
file).

``--kernel ed`` (the squared-ED kernels):

1. Bits: ``ed_matrix`` (float32 and bf16 series) and
   ``decode_bf16_ed_matrix`` (distances and row norms, on a payload view at
   the bf16 codec's 2n + 4 byte pitch) of the checkout equal the
   baseline's bit for bit: at the main path's shapes (Q=128 x 4096 and
   131,072 rows, n=256), at ``chip_smoke.py``'s adversarial shapes, at
   every Q in {1, 127, 129} x N in {1, 31, 4096, 4097, 131,073} x n in
   {1, 7, 255, 256}, and on views whose base is one row in. ``ed_min``
   (distances as int32 words, and indices; float32 and bf16 series, at
   ``valid_n`` N and N // 2) at its main shapes (Q=128 x 4,194,304 and
   131,072 rows, n=256) and the same edge grid, also one row in.
2. Witness: ``chip_smoke.hold_witness`` (row minima and first argmins
   against ``ed_min``) on the checkout's build at the main shapes.
3. Times at the main shapes, the builds in turns (baseline, checkout,
   trials, then back): ``chip_smoke.time_ms`` (launched from a host loop,
   as the engine does: the ``ms`` of ``chip_smoke.py``'s kernels line) and
   ``chip_smoke.device_ms`` (a CUDA graph of back-to-back launches: its
   ``device_ms``). At 4096 rows twice: "hot" relaunches on one block,
   "stream" walks consecutive blocks of a 131,072-row collection, as the
   k>1 scan and ``ooc-local``'s folds meet them. First a 1x1x1 launch, the
   floor. ``ed_min`` at Q=128 x 4,194,304 and 131,072 rows.

``--kernel lb_sax`` (``lb_sax_matrix``):

1. Bits: the checkout's output equals the baseline's and the plain
   version's (``kernels/ref.py::lb_sax_matrix_ref``) in every bit (compared
   as int32 words, so -0.0 and +0.0 differ): at the main path's shapes
   (Q=1 x 4,198,400 codes, ``exact_knn`` phase 3; Q=128 x 131,072,
   ``ooc-local``'s LSD filter; m=16, codes of random walks), at every Q in
   {1, 7, 8, 9, 127, 128, 129} x N in {1, 255, 256, 257, 131,073} x m in
   {8, 16} x alphabet in {2, 4, 16, 256} (uniform random codes, PAA values
   spread past the outer breakpoints), on views whose base is one row in,
   and with PAA rows at +-1e15.
2. Times at the two main shapes, baseline and checkout in turns, by both
   yardsticks as for ``ed``.

``--kernel wkv6`` (the RWKV-6 recurrence):

1. Bits: out and final state of every build (the baseline too) equal
   ``kernels/ref.py::wkv6_fma_ref`` (the kernel's fmaf chains through a
   correctly rounded fmaf), and each build's equal the baseline's, as int32
   words (bf16 zero-extended, NaNs as one word): at every T in {0, 1, C - 1,
   C, C + 1, 2C + 3, 512} (C = 32, the source's default chunk) x K, V in
   {1, 4, 17, 33, 64}, float32 and bf16 r/k/v/out, B = H = 2, on
   contiguous tensors and on views whose base is one row in (K = 33 or a
   bf16 view of K = 4 is not 16-byte aligned: the element path), at K = V =
   64 also one element in (the element path by pointer alone); the extreme
   decays (w = 0, 1e-38, 1e-6, 1 - 1e-6, 1 and one of each per channel),
   w == 0 in one chunk only (the select there, the reset-free loop
   elsewhere), the overflow-then-reset case, and the served shapes (B=4, T=512 and
   T=1, H=64, K=V=64, both dtypes). Prints how many cases took each path.
2. Times at the prefill (B=4, T=512, H=64, K=V=64) and decode (T=1)
   shapes, bf16 and float32, and at the prefill shape (bf16) with a w == 0
   in every chunk (the kernel's select in every step), by both yardsticks
   as for ``ed``. The trial flags of ``csrc/wkv6.cu``: ``-DWKV_CHUNK=``
   (steps a chunk), ``-DWKV_COLS=`` (columns a thread),
   ``-DWKV_STEP_UNROLL=``.

``--kernel wkv6_bwd`` (the RWKV-6 gradient, ``csrc/wkv6_bwd.cu``). Each
build runs through the package's wrapper, which sizes the checkpoint
scratch by ``kernels/wkv6.py::BWD_CHUNK``: that is set to the build's own
``constexpr int CK`` while it runs (``CK=N`` words change it). The first
kernel's source (v1: a ``states`` scratch after ``ckpt``) has another C
interface, and runs through a caller here that allocates v1's scratch.

1. Bits and contract: every build's gradients within 1e-5 (float32) or
   8e-3 (bf16 r, k, v) of each tensor's largest magnitude from
   ``wkv6_bwd_ref``, dw exactly 0 at reset rows of a finite state; each
   build of the checkout's source (trials too: the chunk changes no sum)
   equal to ``wkv6_bwd_fma_ref`` as words (NaNs as one word). At every T in
   {0, 1, C - 1, C, C + 1, 2C + 3, 512} (C = ``BWD_CHUNK``) x K, V
   in {1, 17, 33, 64}, float32 and bf16, B = H = 2, at K = V = 64 also one
   element in (the element path); w == 0 in one chunk only; the extreme
   decays of ``--kernel wkv6``; overflow-then-reset (held where both are
   finite: the plain version forms k v^T, which overflows where the
   kernels' factored u k (v . do) does not; every gradient finite from the
   step after the reset on); the check shape (2, 67, 3, 64, 64) and the training shape (4, 512, 64, 64,
   64), both dtypes.
2. Distance from float64: each build's largest error in each gradient
   against ``wkv6_bwd_ref(..., dtype=torch.float64)``, over that
   gradient's largest magnitude, with the float32 plain version's beside
   them: float32 at the check and training shapes.
3. Times at the training shape, bf16 and float32, in turns by both
   yardsticks as for ``ed``; the bound is ``chip_smoke.py``'s. The trial
   word of either source: ``CK=N`` (steps a checkpoint covers).

``--kernel dtw`` (``dtw_band``; no ``--baseline``: v1 stays in the
checkout's ``csrc/dtw.cu`` for wide bands, so both are launched by
``kernels/dtw.py::dtw_band_as``):

1. Bits: every kernel (v1; v2 with one thread a pair; v2 with each lane
   count of ``LANES`` where the band allows) equals ``dtw_band_ref`` as
   int32 words at 1 x 4,096, 16 x 256 (a ``dtw_knn`` round) and 4 x 256 (a
   late round), n = 256, bands 0, 13, 31, 32 and 40, plus ragged pair
   counts (1, 31, 33, 63, 65, 129 rows: a warp's and a group's edge); at
   1 x 4,194,304 (the brute force) each kernel equals v1 and the first
   4,096 rows equal ``dtw_band_ref``.
2. Times at those four shapes and bands, every kernel in turns (forward,
   then back), by both yardsticks as for ``ed``, the bound as
   ``chip_smoke.py``'s (5 operations a cell at the non-FMA issue rate);
   and at 1 query x 8,192 .. 131,072 rows, band 13, v2's one thread a pair
   against its lanes: where the two meet sets ``kernels/dtw.py``'s
   ``LANE_PAIRS``. Each row names the kernel ``_plan`` picks there.

``--kernel rg_lru`` (``rg_lru_scan`` and ``rg_lru_scan_bwd``, one source).
The baseline is an older ``rg_lru.cu`` whose C entry points are v1's (the
parent commit's: ``git show HEAD~1:src/repro_torch/kernels/csrc/rg_lru.cu >
build/ab/rg_lru_v1.cu``), launched as v1 by the package's private launch
helpers (``kernels/rg_lru.py::_launch_scan``, ``_launch_scan_bwd``, which
the wrappers call with ``_plan``'s choice); the checkout's build (``v2``)
and its trials (``kSteps=16``, ``kStages=3``, ``kBwdStages=4``) go through
the wrappers, so through ``_plan``.

1. Bits: every build's forward (y, hT) and gradient (da, dg, dh0), and the
   checkout's v1 and v2 through the launch helpers where they apply, equal
   ``rg_lru_scan_ref``
   and ``rg_lru_scan_bwd_ref`` as int32 words, at every shape of
   ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phases 19 and 23
   (prefill and decode, a tile tail at T = 515, R = 36, 37, 77, 8 and 1,
   T = 0) and more edges, on contiguous operands and on views one float in
   (not 16-byte aligned: the plan takes v1).
2. Times of both kernels at the prefill (4, 512, 2560), decode (4, 1,
   2560) and a ragged (4, 515, 2563) shape, the builds in turns, by both
   yardsticks as for ``ed``, each with the bound (``chip_smoke.py``'s),
   its share and the TB/s reached: "hot" relaunches one operand set (as
   ``chip_smoke.py``'s CUDA graph does), "stream" walks ~150 MB of sets
   in turn, so that L2 holds none of a call's operands (not at the ragged
   shape); beside the forward, ``torch.add(a, g, out=y)``, the same bytes
   without the chain, as a yardstick of what the card streams at that
   mix. Then the checkout's v1 against its v2 at (4, T, 2560) for T in
   1 .. 256, hot and streamed: where they meet sets
   ``kernels/rg_lru.py``'s ``V2_MIN_STEPS``.

Prints one line per timed case and a JSON line; ``--out`` also writes the
JSON there. Exits 1 if any bit differs (2 without a card); a failed ED
witness ends the run as ``chip_smoke.py``'s checks do.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402  (the repo root, put on the path above)

ED_MAIN = [(128, 4096, 256), (128, 131072, 256)]
ED_EDGES = [(1, 1, 1), (1, 100, 128), (5, 77, 48), (8, 129, 33), (130, 4097, 256),
         (127, 31, 7), (1, 4097, 256), (129, 131073, 255)]


def patched(text: str, pairs, what: str) -> str:
    """``text`` with each ``old`` of ``pairs`` (old, new) replaced by its
    ``new``; ends the run if an ``old`` is not in it (``what`` names the
    source)."""
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"kernel_ab: anchor not found in {what}: {old!r}")
        text = text.replace(old, new)
    return text


def with_constexprs(text: str, sets, what: str) -> str:
    """``text`` with ``constexpr int NAME = VALUE;`` for each ``NAME=VALUE``
    of ``sets``; ends the run unless exactly one such line holds NAME."""
    for word in sets:
        name, _, value = word.partition("=")
        text, n = re.subn(rf"(constexpr int {re.escape(name)} = )[^;]+;", rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"kernel_ab: {n} lines 'constexpr int {name} = ...;' in {what}")
    return text


def compile_text(name: str, text: str, workdir: Path, label: str,
                 flags=()) -> ctypes.CDLL:
    """Compile ``text`` (a ``csrc/<name>.cu``, as a copy in ``workdir``)
    with the package's flags and ``flags``."""
    from repro_torch.kernels import _build
    src = workdir / f"{name}_{label}.cu"
    src.write_text(text)
    lib = workdir / f"lib{name}_{label}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name} {label}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def trial_text(src: Path, words: str) -> tuple[str, list]:
    """A trial's source text (``NAME=VALUE`` words set) and nvcc flags
    (words that start with ``-``)."""
    words = words.split()
    sets = [w for w in words if not w.startswith("-")]
    return with_constexprs(src.read_text(), sets, str(src)), [w for w in words if w not in sets]


def load_baseline(name: str, src: Path, workdir: Path, label: str = "baseline",
                  words: str = "") -> ctypes.CDLL:
    """Compile ``src`` with the package's flags, as ``words`` say, and
    declare it as library ``name``."""
    from repro_torch.kernels import _build
    text, flags = trial_text(src, words)
    loaded = compile_text(name, text, workdir, label, flags)
    _build._declare(name, loaded)
    return loaded


@contextlib.contextmanager
def using(name: str, lib):
    """The package's wrappers of library ``name`` launch ``lib`` inside the
    block (None: the checkout's own build)."""
    from repro_torch.kernels import _build
    own = _build.library(name)
    _build._libs[name] = lib or own
    try:
        yield
    finally:
        _build._libs[name] = own


def walks(num: int, n: int, seed: int):
    """Random walks, not z-normalized (so n = 1 is not all zeros)."""
    from repro_torch.data.synthetic import random_walks
    return random_walks(num, n, seed=seed, znorm=False, device="cuda")


def ed_outputs(q, s, sb, payload) -> list:
    from repro_torch.kernels import ed as ked
    return [ked.ed_matrix(q, s), ked.ed_matrix(q, sb), *ked.decode_bf16_ed_matrix(q, payload)]


ED_EDGE_GRID = list(itertools.product((1, 127, 129), (1, 31, 4096, 4097, 131073),
                                     (1, 7, 255, 256)))
MIN_MAIN = [(128, 4194304, 256), (128, 131072, 256)]


def ed_min_outputs(q, s, sb) -> list:
    """``ed_min`` over float32 and bf16 series at valid_n N and N // 2:
    distances as int32 words, then indices."""
    import torch
    from repro_torch.kernels import ed as ked
    out = []
    for series in (s, sb):
        for valid in (s.shape[0], s.shape[0] // 2):
            dmin, amin = ked.ed_min(q, series, valid_n=valid)
            out += [dmin.view(torch.int32), amin]
    return out


def check_ed_bits(builds: dict) -> list:
    """Every output of the checkout's build and of each trial against the
    baseline's; returns the differing cases (empty when all are
    bit-identical)."""
    import torch
    names = ("ed_matrix f32", "ed_matrix bf16", "decode dists", "decode norms")
    min_names = [f"ed_min {dt} valid {v} {what}" for dt in ("f32", "bf16")
                 for v in ("N", "N//2") for what in ("dists", "indices")]
    cases = [(shape, True) for shape in ED_MAIN + ED_EDGES + ED_EDGE_GRID]
    cases += [(shape, False) for shape in MIN_MAIN + ED_EDGE_GRID]
    bad, count = [], 0
    for idx, ((qn, num, n), matrix) in enumerate(cases):
        q, s = walks(qn + 1, n, 2 * idx), walks(num + 1, n, 2 * idx + 1)
        sb = s.to(torch.bfloat16)
        if matrix:
            payload = cs.bf16_payload(s)
            views = {"": (q[:qn], s[:num], sb[:num], payload[:num]),
                     " +1 row": (q[1:], s[1:], sb[1:], payload[1:])}
            fn, labels = ed_outputs, names
        else:
            views = {"": (q[:qn], s[:num], sb[:num]), " +1 row": (q[1:], s[1:], sb[1:])}
            fn, labels = ed_min_outputs, min_names
        for tag, view in views.items():
            outs = {}
            for label, lib in builds.items():
                with using("ed", lib):
                    outs[label] = fn(*view)
            want = outs.pop("v1")
            for label, got in outs.items():
                for name, a, b in zip(labels, got, want):
                    count += 1
                    if not torch.equal(a, b):
                        bad.append(f"{label}: {name} {qn}x{num}x{n}{tag}")
        del q, s, sb
    print(f"[bits] {count} comparisons over {len(cases)} shapes: {len(bad)} differ "
          f"{bad[:10] if bad else ''}", flush=True)
    return bad


def ed_timings(builds: dict) -> list:
    from repro_torch.kernels import ed as ked
    q, coll = walks(128, 256, 50), walks(131072, 256, 51)
    payload, one = cs.bf16_payload(coll), walks(2, 1, 53)

    def stream(fn, rows):
        blocks = itertools.cycle([rows[i:i + 4096] for i in range(0, 32 * 4096, 4096)])
        return lambda: fn(q, next(blocks))

    cases = [
        ("ed_matrix", (1, 1, 1), "floor", lambda: ked.ed_matrix(one[:1], one[1:]), 500),
        ("ed_matrix", ED_MAIN[0], "hot", lambda: ked.ed_matrix(q, coll[:4096]), 500),
        ("ed_matrix", ED_MAIN[0], "stream", stream(ked.ed_matrix, coll), 512),
        ("ed_matrix", ED_MAIN[1], "hot", lambda: ked.ed_matrix(q, coll), 40),
        ("decode_bf16_ed_matrix", ED_MAIN[0], "hot",
         lambda: ked.decode_bf16_ed_matrix(q, payload[:4096]), 500),
        ("decode_bf16_ed_matrix", ED_MAIN[0], "stream", stream(ked.decode_bf16_ed_matrix, payload),
         512),
        ("decode_bf16_ed_matrix", ED_MAIN[1], "hot", lambda: ked.decode_bf16_ed_matrix(q, payload),
         40),
    ]
    rows = []
    for kname, shape, mode, fn, reps in cases:
        qn, num, n = shape
        f32 = kname == "ed_matrix"
        nbytes = qn * n * 4 + num * n * (4 if f32 else 2) + qn * num * 4 + (0 if f32 else num * 4)
        bound = 1e3 * max(nbytes / cs.HBM_BYTES_PER_S, 2 * qn * num * n / cs.FP32_FLOPS)
        rows.append(in_turns("ed", builds, kname, shape, mode, fn, reps, bound))
    big = walks(MIN_MAIN[0][1], 256, 52)
    for (qn, num, n), series, reps in ((MIN_MAIN[1], coll, 40), (MIN_MAIN[0], big, 5)):
        nbytes = (qn * n + num * n) * 4 + qn * 8
        bound = 1e3 * max(nbytes / cs.HBM_BYTES_PER_S, 2 * qn * num * n / cs.FP32_FLOPS)
        rows.append(in_turns("ed", builds, "ed_min", (qn, num, n), "hot",
                             lambda: ked.ed_min(q, series), reps, bound))
    return rows


def in_turns(lib: str, builds: dict, kname: str, shape, mode: str, fn, reps: int,
             bound: float) -> dict:
    """``fn`` timed on each build (the baseline v1, the checkout v2, the
    trials) in turns, forward and back (v1, v2, trials, trials, v2, v1), by
    the host loop and by a CUDA graph; prints and returns the row."""
    runs: dict = {label: [] for label in builds}
    for label in [*builds, *reversed(builds)]:
        with using(lib, builds[label]):
            runs[label].append((cs.time_ms(fn, reps, warmup=2), cs.device_ms(fn, reps)))
    return turns_row(kname, shape, mode, reps, bound, runs)


def turns_row(kname: str, shape, mode: str, reps: int, bound: float, runs: dict) -> dict:
    """The row of timings in turns (``runs``: label -> [(host loop ms,
    graph ms), ...]), printed."""
    row = {"kernel": kname, "shape": list(shape), "mode": mode, "reps": reps,
           "bound_ms": bound, "runs": runs,
           "ms": {k: sum(e for e, _ in v) / 2 for k, v in runs.items()},
           "device_ms": {k: sum(d for _, d in v) / 2 for k, v in runs.items()}}
    print(f"[time] {kname} {'x'.join(map(str, shape))} {mode}: bound {bound:.4f} ms; "
          "host loop " + "; ".join(f"{k} {v:.4f}" for k, v in row["ms"].items())
          + "; device "
          + "; ".join(f"{k} {v:.4f} ({bound / v:.1%})" for k, v in row["device_ms"].items()),
          flush=True)
    return row


LB_MAIN = [(1, 4198400, 16), (128, 131072, 16)]
LB_EDGES = list(itertools.product((1, 7, 8, 9, 127, 128, 129), (1, 255, 256, 257, 131073),
                                  (8, 16), (2, 4, 16, 256)))


def lb_main_inputs(qn: int, num: int, m: int, seed: int):
    """qn + 1 query PAA rows and num + 1 iSAX codes of z-normalized random
    walks of length 256, as the index's LSD sidecar holds them."""
    from repro_torch.core import summaries as S
    from repro_torch.data.synthetic import random_walks
    codes = S.isax(random_walks(num + 1, 256, seed=seed, device="cuda"), m)
    return S.paa(random_walks(qn + 1, 256, seed=seed + 1, device="cuda"), m), codes


def lb_edge_inputs(qn: int, num: int, m: int, alphabet: int, seed: int):
    """qn + 1 PAA rows spread past the outer breakpoints (+-3) and num + 1
    uniform random codes of the alphabet."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q_paa = torch.randn((qn + 1, m), generator=g, device="cuda") * 2.0
    codes = torch.randint(0, alphabet, (num + 1, m), generator=g, device="cuda",
                          dtype=torch.uint8)
    return q_paa, codes


def check_lb_bits(builds: dict) -> list:
    """The checkout's ``lb_sax_matrix`` (and each trial's) against the
    baseline's and the plain version's, as int32 words; returns the
    differing cases."""
    import torch
    from repro_torch.kernels import lb_sax as klb, ref

    def bits(x):
        return x.view(torch.int32)

    inputs = [((qn, num, m, 256), lb_main_inputs(qn, num, m, 60 + 2 * i))
              for i, (qn, num, m) in enumerate(LB_MAIN)]
    inputs += [(shape, lb_edge_inputs(*shape, seed=idx)) for idx, shape in enumerate(LB_EDGES)]
    bad, cases = [], 0
    for (qn, num, m, alphabet), (q_paa, codes) in inputs:
        length = 4 * m
        big = q_paa[1:].clone()
        big[::2], big[1::2] = 1e15, -1e15
        views = {"": (q_paa[:qn], codes[:num]), " +1 row": (q_paa[1:], codes[1:]),
                 " +-1e15": (big, codes[:num])}
        for tag, (q, c) in views.items():
            outs = {}
            for label, lib in builds.items():
                with using("lb_sax", lib):
                    outs[label] = klb.lb_sax_matrix(q, c, length, alphabet)
            want = outs.pop("v1")
            plain = ref.lb_sax_matrix_ref(q, c, length, alphabet)
            for label, got in outs.items():
                for what, other in (("baseline", want), ("plain", plain)):
                    cases += 1
                    if not torch.equal(bits(got), bits(other)):
                        bad.append(f"{label}: lb_sax vs {what} {qn}x{num}x{m} "
                                   f"a={alphabet}{tag}")
    print(f"[bits] {cases} comparisons over {len(inputs)} shapes: {len(bad)} differ "
          f"{bad[:10] if bad else ''}", flush=True)
    return bad


def lb_timings(builds: dict) -> list:
    from repro_torch.kernels import lb_sax as klb
    rows = []
    for i, (qn, num, m) in enumerate(LB_MAIN):
        q_paa, codes = (x[:-1] for x in lb_main_inputs(qn, num, m, 80 + 2 * i))
        nbytes = qn * m * 4 + num * m + qn * num * 4
        bound = 1e3 * max(nbytes / cs.HBM_BYTES_PER_S, qn * num * (6 * m + 1) / cs.FP32_FLOPS)
        rows.append(in_turns("lb_sax", builds, "lb_sax_matrix", (qn, num, m), "hot",
                             lambda: klb.lb_sax_matrix(q_paa, codes, 256), 200, bound))
        del q_paa, codes
    return rows


WKV_CHUNK = 32                          # csrc/wkv6.cu's default chunk of steps
WKV_TS = (0, 1, WKV_CHUNK - 1, WKV_CHUNK, WKV_CHUNK + 1, 2 * WKV_CHUNK + 3, 512)
WKV_DIMS = (1, 4, 17, 33, 64)
WKV_MAIN = {"prefill": (4, 512, 64, 64, 64), "decode": (4, 1, 64, 64, 64)}


def wkv_place(x, dtype, offset: int):
    """``x`` in ``dtype``, ``offset`` elements into a new flat buffer."""
    import torch
    buf = torch.empty(x.numel() + offset, dtype=dtype, device=x.device)
    buf[offset:] = x.reshape(-1).to(dtype)
    return buf[offset:].view(x.shape)


def wkv_aligned(r, k, v, w) -> bool:
    """Whether ``csrc/wkv6.cu``'s launcher takes its aligned (cp.async) path."""
    es, dk, dv = r.element_size(), r.shape[-1], v.shape[-1]
    return ((dk * es) % 16 == 0 and dk % 4 == 0 and (dv * es) % 16 == 0
            and all(x.data_ptr() % 16 == 0 for x in (r, k, v, w)))


def wkv_cases():
    """(label, args) of the bits grid, made on the card from a seed."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(7)

    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    for dtype, dk, dv, t in itertools.product((torch.float32, torch.bfloat16), WKV_DIMS,
                                              WKV_DIMS, WKV_TS):
        layouts = {"": 0, " +1 row": None} | ({" +1 elem": 1} if dk == dv == 64 else {})
        for tag, off in layouts.items():
            b, h = 2, 2
            r, k, v, w = (wkv_place(x, dt, x.shape[-1] if off is None else off)
                          for x, dt in ((n(b, t, h, dk), dtype), (n(b, t, h, dk), dtype),
                                        (n(b, t, h, dv), dtype),
                                        (torch.sigmoid(n(b, t, h, dk)), torch.float32)))
            yield f"{str(dtype)[6:]} T={t} K={dk} V={dv}{tag}", (r, k, v, w, n(h, dk),
                                                               n(b, h, dk, dv))
    for kind, shape in WKV_MAIN.items():
        for dtype in (torch.float32, torch.bfloat16):
            yield f"{kind} {str(dtype)[6:]}", cs._wkv_inputs(g, *shape, dtype)
    for dtype, (dk, dv) in itertools.product((torch.float32, torch.bfloat16),
                                             ((64, 64), (33, 17))):
        r, k, v, w, u, s0 = cs._wkv_inputs(g, 2, 2 * WKV_CHUNK + 3, 2, dk, dv, dtype)
        one = slice(WKV_CHUNK, WKV_CHUNK + 3)
        w[:, one] = torch.where(torch.rand(w[:, one].shape, generator=g, device="cuda") < 0.3,
                                0.0, w[:, one])
        yield f"w == 0 in chunk 1 only, {str(dtype)[6:]} K={dk} V={dv}", (r, k, v, w, u, s0)
    b, t, h, dk, dv = 1, 64, 1, 4, 4
    r, k, v, _, u, s0 = cs._wkv_inputs(g, b, t, h, dk, dv)
    mixed = torch.stack([torch.zeros(b, t, h), torch.ones(b, t, h),
                         torch.full((b, t, h), 1e-38), torch.full((b, t, h), 1.0 - 1e-6)],
                        -1).cuda()
    for wv in (0.0, 1e-38, 1e-6, 1.0 - 1e-6, 1.0, None):
        w = mixed if wv is None else torch.full((b, t, h, dk), wv, device="cuda")
        yield f"decay {wv if wv is not None else 'mixed'}", (r, k, v, w, u, s0)
    k, v = k[:, :24].clone(), v[:, :24].clone()
    k[:, :8] = 2e19
    v[:, :8] = 2e19
    w = torch.ones(b, 24, h, dk, device="cuda")
    w[:, 8] = 0.0
    yield "overflow-then-reset", (r[:, :24], k, v, w, u, torch.zeros_like(s0))


def check_wkv6_bits(builds: dict) -> list:
    """Every build's (out, state) against ``wkv6_fma_ref`` and each non-baseline
    build's against the baseline's, as words; returns the differing cases."""
    import torch
    from repro_torch.kernels import ref, wkv6 as kwkv
    bad, count, paths = [], 0, {True: 0, False: 0}
    for label, a in wkv_cases():
        paths[wkv_aligned(*a[:4])] += 1
        want = [cs.wkv_words(x) for x in ref.wkv6_fma_ref(*a)]
        outs = {}
        for name, lib in builds.items():
            with using("wkv6", lib):
                outs[name] = [cs.wkv_words(x) for x in kwkv.wkv6(*a)]
        for name, got in outs.items():
            others = [("fma", want)] + ([("v1", outs["v1"])] if name != "v1" else [])
            for what, other in others:
                for part, x, y in zip(("out", "state"), got, other):
                    count += 1
                    if not torch.equal(x, y):
                        bad.append(f"{name} vs {what}: {part} {label}")
    print(f"[bits] {count} comparisons over {sum(paths.values())} cases ({paths[True]} on "
          f"the aligned path, {paths[False]} on the element path): {len(bad)} differ "
          f"{bad[:10] if bad else ''}", flush=True)
    return bad


def wkv_timings(builds: dict) -> list:
    import torch
    from repro_torch.kernels import wkv6 as kwkv
    g = torch.Generator(device="cuda").manual_seed(70)
    cases = []
    for kind, dtype in itertools.product(WKV_MAIN, (torch.bfloat16, torch.float32)):
        cases.append((kind, str(dtype)[6:], cs._wkv_inputs(g, *WKV_MAIN[kind], dtype)))
    a = list(cs._wkv_inputs(g, *WKV_MAIN["prefill"], torch.bfloat16))
    a[3][:, ::WKV_CHUNK, :, 0] = 0.0          # one w_i == 0 in every chunk
    cases.append(("prefill", "bfloat16, w == 0 in every chunk", a))
    rows = []
    for kind, label, a in cases:
        shape = WKV_MAIN[kind]
        nbytes, ops = cs._wkv_cost(*shape, a[0].element_size())
        bound = 1e3 * max(nbytes / cs.HBM_BYTES_PER_S, ops / cs.FP32_FLOPS)
        rows.append(in_turns("wkv6", builds, "wkv6", shape, label,
                             lambda a=a: kwkv.wkv6(*a), 20 if kind == "prefill" else 200,
                             bound))
    return rows


WKV_BWD_DIMS = (1, 17, 33, 64)
WKV_BWD_CHECK = (2, 67, 3, 64, 64)
WKV_BWD_TRAIN = (4, 512, 64, 64, 64)
WKV_BWD_TOL = {"float32": 1e-5, "bfloat16": 8e-3}


class BwdBuild:
    """One build of a ``wkv6_bwd.cu``, ``ck`` steps a checkpoint (its
    ``CK``). Inside :meth:`context` the package's wrapper launches it, with
    ``BWD_CHUNK`` set to ``ck``; a v1 source (``v1``) is launched by
    :meth:`grads` here, with v1's scratch."""

    def __init__(self, lib, ck: int, v1: bool = False):
        self.lib, self.ck, self.v1 = lib, ck, v1

    @contextlib.contextmanager
    def context(self):
        from repro_torch.kernels import wkv6 as kwkv
        if self.v1:
            yield
            return
        own = kwkv.BWD_CHUNK
        kwkv.BWD_CHUNK = self.ck
        try:
            with using("wkv6_bwd", self.lib):
                yield
        finally:
            kwkv.BWD_CHUNK = own

    def grads(self, r, k, v, w, u, s0, dout, dst):
        import torch
        from repro_torch.kernels import _build, wkv6 as kwkv
        if not self.v1:
            return kwkv.wkv6_bwd(r, k, v, w, u, s0, dout, dst)
        # v1 only (the first design's source): goes with --baseline-trial.
        b, t, h, dk = r.shape
        dv = v.shape[-1]
        f32 = dict(dtype=torch.float32, device=r.device)
        ins = [x.contiguous() for x in (r, k, v, w, u, s0, dout, dst)]
        outs = [torch.empty_like(ins[0]), torch.empty_like(ins[1]), torch.empty_like(ins[2]),
                torch.empty((b, t, h, dk), **f32), torch.empty((h, dk), **f32),
                torch.empty((b, h, dk, dv), **f32)]
        scratch = [torch.empty((b * h * dk,), **f32),
                   torch.empty((b * h * -(-t // self.ck) * dk * dv,), **f32),
                   torch.empty((b * h * min(t, self.ck) * dk * dv,), **f32)]
        entry = self.lib.wkv6_bwd_f32 if r.dtype == torch.float32 else self.lib.wkv6_bwd_bf16
        _build.check(entry(*(x.data_ptr() for x in ins + outs + scratch), b, t, h, dk, dv,
                           torch.cuda.current_stream(r.device).cuda_stream), "wkv6_bwd v1")
        return tuple(outs)


def bwd_text_build(text: str, workdir: Path, label: str, flags=()) -> BwdBuild:
    """Compile a ``wkv6_bwd.cu``'s ``text``: v1's C interface (17 pointers)
    if its entry points take a ``states`` scratch, else the checkout's."""
    from repro_torch.kernels import _build
    loaded = compile_text("wkv6_bwd", text, workdir, label, flags)
    ck = int(re.search(r"constexpr int CK = (\d+);", text).group(1))
    if "float* states, int B" not in text:
        _build._declare("wkv6_bwd", loaded)
        return BwdBuild(loaded, ck)
    for fn in (loaded.wkv6_bwd_f32, loaded.wkv6_bwd_bf16):
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return BwdBuild(loaded, ck, v1=True)


def load_bwd(src: Path, workdir: Path, label: str, words: str = "") -> BwdBuild:
    """Compile a ``wkv6_bwd.cu`` as ``words`` say (see :func:`trial_text`)."""
    text, flags = trial_text(src, words)
    return bwd_text_build(text, workdir, label, flags)


def own_bwd() -> BwdBuild:
    """The checkout's own build, the package's."""
    from repro_torch.kernels import _build, wkv6 as kwkv
    return BwdBuild(_build.library("wkv6_bwd"), kwkv.BWD_CHUNK)


def bwd_grads_in(g, shape, dtype):
    """r, k, v (in ``dtype``), w, u, s0, dout (``dtype``), dsT on the card."""
    import torch
    b, t, h, dk, dv = shape
    a = list(cs._wkv_inputs(g, b, t, h, dk, dv, dtype))
    dout = torch.randn((b, t, h, dv), generator=g, device="cuda").to(a[0].dtype)
    return a + [dout, torch.randn((b, h, dk, dv), generator=g, device="cuda")]


def wkv_bwd_cases(chunk: int):
    """(label, args, after) of the bits grid, made on the card from a seed;
    ``after`` is the first step after an overflowed state's reset, else
    None."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(27)
    ts = (0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk + 3, 512)
    for dtype, dk, dv, t in itertools.product((torch.float32, torch.bfloat16), WKV_BWD_DIMS,
                                              WKV_BWD_DIMS, ts):
        name = str(dtype)[6:]
        a = bwd_grads_in(g, (2, t, 2, dk, dv), dtype)
        yield f"{name} T={t} K={dk} V={dv}", a, None
        if dk == dv == 64 and t in (chunk + 1, 512):
            off = [wkv_place(x, x.dtype, 1) for x in a]
            yield f"{name} T={t} K=V=64 +1 elem", off, None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for shape in (WKV_BWD_CHECK, WKV_BWD_TRAIN):
            yield f"{name} {shape}", bwd_grads_in(g, shape, dtype), None
        for dk, dv in ((64, 64), (33, 17)):
            a = bwd_grads_in(g, (2, 2 * chunk + 3, 2, dk, dv), dtype)
            one = slice(chunk, 2 * chunk)
            a[3][:, one] = torch.where(torch.rand(a[3][:, one].shape, generator=g,
                                                  device="cuda") < 0.3, 0.0, a[3][:, one])
            yield f"w == 0 in chunk 1 only, {name} K={dk} V={dv}", a, None
    b, t, h, dk, dv = 1, 64, 1, 4, 4
    base = bwd_grads_in(g, (b, t, h, dk, dv), torch.float32)
    mixed = torch.stack([torch.zeros(b, t, h), torch.ones(b, t, h),
                         torch.full((b, t, h), 1e-38), torch.full((b, t, h), 1.0 - 1e-6)],
                        -1).cuda()
    for wv in (0.0, 1e-38, 1e-6, 1.0 - 1e-6, 1.0, None):
        a = list(base)
        a[3] = mixed if wv is None else torch.full((b, t, h, dk), wv, device="cuda")
        yield f"decay {wv if wv is not None else 'mixed'}", a, None
    a = [x[:, :24].clone() if x.ndim == 4 and x.shape[1] == t else x for x in base]
    a[1][:, :8] = 2e19
    a[2][:, :8] = 2e19
    a[3] = torch.ones(b, 24, h, dk, device="cuda")
    a[3][:, 8] = 0.0
    a[5] = torch.zeros_like(a[5])
    yield "overflow-then-reset", a, 9


def hold_bwd_contract(args, got, want, after=None) -> list:
    """What of ``got`` breaks the contract against ``want`` (wkv6_bwd_ref's
    gradients): dtype and shape, within the dtype's tolerance of each
    tensor's largest magnitude, dw 0 at reset rows of a finite state. With
    ``after`` (an overflowed state reset at step ``after - 1``): held where
    both are finite, and every gradient of a step from ``after`` on, and
    ds0, finite."""
    import torch
    tol = WKV_BWD_TOL[str(args[0].dtype)[6:]]
    bad = []
    for name, a, b in zip(cs.WKV_GRAD_NAMES, got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            bad.append(f"{name} {a.dtype} {tuple(a.shape)}")
            continue
        a, b = a.float(), b.float()
        keep = torch.isfinite(a) & torch.isfinite(b)
        if after is None and not bool(keep.all()):
            bad.append(f"{name} not finite")
        if after is not None and name != "du":
            late = a[:, after:] if a.ndim == 4 and name != "ds0" else a
            if not bool(torch.isfinite(late).all()):
                bad.append(f"{name} not finite after the reset")
        if bool(keep.any()):
            err = float((a[keep] - b[keep]).abs().max())
            if err > tol * max(float(b[keep].abs().max()), 1e-30):
                bad.append(f"{name} off by {err:.3e}")
    if after is None and bool((args[3] == 0).any()) and bool((got[3][args[3] == 0] != 0).any()):
        bad.append("dw not 0 where w == 0")
    return bad


def check_wkv6_bwd_bits(builds: dict, own: set) -> list:
    """Every build against ``wkv6_bwd_ref``'s contract, and the builds of
    the checkout's source (``own``) against ``wkv6_bwd_fma_ref`` as words;
    returns the differing cases."""
    import torch
    from repro_torch.kernels import ref, wkv6 as kwkv
    chunk = kwkv.BWD_CHUNK
    bad, count, cases = [], 0, 0
    for label, a, after in wkv_bwd_cases(chunk):
        cases += 1
        want = ref.wkv6_bwd_ref(*a)
        exact = [cs.wkv_words(x) for x in ref.wkv6_bwd_fma_ref(*a)]
        for name, build in builds.items():
            with build.context():
                got = build.grads(*a)
            count += 1
            bad += [f"{name} {label}: {x}" for x in hold_bwd_contract(a, got, want, after)]
            if name in own:
                count += 1
                for part, x, y in zip(cs.WKV_GRAD_NAMES, got, exact):
                    if not torch.equal(cs.wkv_words(x), y):
                        bad.append(f"{name} vs fma: {part} {label}")
        del a, want, exact
    print(f"[bits] {count} checks over {cases} cases (chunk {chunk}): {len(bad)} fail "
          f"{bad[:10] if bad else ''}", flush=True)
    return bad


def wkv6_bwd_distance(builds: dict) -> list:
    """Each build's and the float32 plain version's largest error in each
    gradient against the float64 plain version, over its largest magnitude
    (float32 inputs)."""
    import torch
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(28)
    rows = []
    for shape in (WKV_BWD_CHECK, WKV_BWD_TRAIN):
        a = bwd_grads_in(g, shape, torch.float32)
        f64 = ref.wkv6_bwd_ref(*a, dtype=torch.float64)
        outs = {"plain f32": ref.wkv6_bwd_ref(*a)}
        for name, build in builds.items():
            with build.context():
                outs[name] = build.grads(*a)
        row = {"shape": list(shape), "rel_err_vs_float64": {}}
        for name, got in outs.items():
            row["rel_err_vs_float64"][name] = {
                n: float((x.double() - y).abs().max()) / max(float(y.abs().max()), 1e-300)
                for n, x, y in zip(cs.WKV_GRAD_NAMES, got, f64)}
        print(f"[float64] {'x'.join(map(str, shape))} float32: " + "; ".join(
            f"{name} " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            for name, errs in row["rel_err_vs_float64"].items()), flush=True)
        rows.append(row)
        del a, f64, outs
    return rows


def wkv6_bwd_timings(builds: dict) -> list:
    import torch
    g = torch.Generator(device="cuda").manual_seed(29)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        a = bwd_grads_in(g, WKV_BWD_TRAIN, dtype)
        nbytes, ops = cs._wkv_bwd_cost(*WKV_BWD_TRAIN, a[0].element_size())
        bound = 1e3 * max(nbytes / cs.HBM_BYTES_PER_S, ops / cs.FP32_FLOPS)
        runs: dict = {label: [] for label in builds}
        for label in [*builds, *reversed(builds)]:
            build = builds[label]
            with build.context():
                def fn(build=build):
                    return build.grads(*a)
                runs[label].append((cs.time_ms(fn, 10, warmup=2), cs.device_ms(fn, 10)))
        rows.append(turns_row("wkv6_bwd", WKV_BWD_TRAIN, str(dtype)[6:], 10, bound, runs))
        del a
    return rows


DTW_N = 256
DTW_SHAPES = [(1, 4096), (16, 256), (4, 256), (1, 1 << 22)]
DTW_BANDS = (0, 13, 31, 32, 40)
DTW_SWEEP = (8192, 16384, 32768, 65536, 131072)


def dtw_plans(band: int, n: int) -> list:
    """Every kernel that takes ``band`` at length ``n``."""
    from repro_torch.kernels import dtw as kdtw
    b = min(band, n - 1)
    plans = [("v1", 1)]
    if b <= kdtw.ROW_BANDS[-1]:
        plans.append(("v2", 1))
    if b <= kdtw.LANE_MAX_BAND:
        plans += [("v2", g) for g in kdtw.LANES]
    return plans


def dtw_operands(qn: int, num: int, seed: int):
    """qn queries and qn x num candidate rows of z-normalised walks (the
    index's rows), as (Q, n) x (Q, B, n)."""
    from repro_torch.data.synthetic import random_walks
    q = random_walks(qn, DTW_N, seed=seed, device="cuda")
    c = random_walks(qn * num, DTW_N, seed=seed + 1, device="cuda")
    return q, c.reshape(qn, num, DTW_N)


def check_dtw_bits() -> list:
    """Every kernel against ``dtw_band_ref`` (and, at the brute force's
    shape, against v1) as int32 words; returns the differing cases."""
    import torch
    from repro_torch.kernels import dtw as kdtw, ref

    def words(x):
        return x.contiguous().view(torch.int32)

    bad, count = [], 0
    cases = [(qn, num) for qn, num in DTW_SHAPES if qn * num <= 4096]
    cases += [(1, num) for num in (1, 31, 33, 63, 65, 129)] + [(3, 67)]
    for i, (qn, num) in enumerate(cases):
        q, c = dtw_operands(qn, num, 200 + 2 * i)
        for band in DTW_BANDS:
            want = words(ref.dtw_band_ref(q, c, band))
            for plan in dtw_plans(band, DTW_N):
                count += 1
                if not torch.equal(words(kdtw.dtw_band_as(q, c, band, *plan)), want):
                    bad.append(f"{plan} {qn}x{num} band {band}")
    qn, num = DTW_SHAPES[-1]
    q, c = dtw_operands(qn, num, 300)
    for band in DTW_BANDS:
        v1 = words(kdtw.dtw_band_as(q, c, band, "v1"))
        want = words(ref.dtw_band_ref(q, c[:, :4096], band))
        for plan in dtw_plans(band, DTW_N):
            got = words(kdtw.dtw_band_as(q, c, band, *plan))
            count += 2
            if not torch.equal(got, v1):
                bad.append(f"{plan} {qn}x{num} band {band} vs v1")
            if not torch.equal(got[:, :4096], want):
                bad.append(f"{plan} {qn}x{num}[:4096] band {band}")
    print(f"[bits] {count} comparisons: {len(bad)} differ {bad[:10] if bad else ''}",
          flush=True)
    return bad


def dtw_in_turns(shape, band: int, plans: list, fn_of, reps: int) -> dict:
    """Each plan's ``fn_of(plan)`` timed in turns, forward then back, by the
    host loop and a CUDA graph; prints and returns the row."""
    from repro_torch.kernels import dtw as kdtw
    runs: dict = {f"{v}/{g}": [] for v, g in plans}
    for plan in [*plans, *reversed(plans)]:
        fn = fn_of(plan)
        runs[f"{plan[0]}/{plan[1]}"].append((cs.time_ms(fn, reps, warmup=2),
                                             cs.device_ms(fn, reps)))
    nbytes, ops = cs.dtw_cost(shape[0] * shape[1], shape[2], band)
    bound = 1e3 * max(nbytes / cs.HBM_BYTES_PER_S, ops / cs.DTW_OPS_PER_S)
    chosen = kdtw._plan(shape[0] * shape[1], shape[2], band)
    row = {"kernel": "dtw_band", "shape": list(shape), "band": band, "reps": reps,
           "bound_ms": bound, "plan": f"{chosen[0]}/{chosen[1]}", "runs": runs,
           "ms": {k: sum(e for e, _ in v) / 2 for k, v in runs.items()},
           "device_ms": {k: sum(d for _, d in v) / 2 for k, v in runs.items()}}
    best = min(row["device_ms"], key=row["device_ms"].get)
    print(f"[time] dtw_band {'x'.join(map(str, shape))} band {band}: bound {bound:.4f} ms; "
          f"_plan {row['plan']}, fastest {best}; host loop "
          + "; ".join(f"{k} {v:.4f}" for k, v in row["ms"].items()) + "; device "
          + "; ".join(f"{k} {v:.4f} ({bound / v:.1%})" for k, v in row["device_ms"].items()),
          flush=True)
    return row


def dtw_timings() -> list:
    from repro_torch.kernels import dtw as kdtw
    rows = []
    for i, (qn, num) in enumerate(DTW_SHAPES):
        q, c = dtw_operands(qn, num, 400 + 2 * i)
        big = qn * num > 1 << 16
        for band in DTW_BANDS:
            plans = dtw_plans(band, DTW_N)
            if big:       # lanes a pair at full occupancy: their cost, once each
                plans = [p for p in plans if p[1] in (1, kdtw.LANES[0], kdtw.LANES[-1])]
            rows.append(dtw_in_turns(
                (qn, num, DTW_N), band, plans,
                lambda plan, q=q, c=c, band=band: (
                    lambda: kdtw.dtw_band_as(q, c, band, *plan)),
                2 if big else 50))
        del q, c
    for num in DTW_SWEEP:
        q, c = dtw_operands(1, num, 500)
        rows.append(dtw_in_turns(
            (1, num, DTW_N), 13, [("v2", 1), *[("v2", g) for g in kdtw.LANES if g >= 4]],
            lambda plan, q=q, c=c: (lambda: kdtw.dtw_band_as(q, c, 13, *plan)), 20))
    return rows


RG_MAIN = {"prefill": (4, 512, 2560), "decode": (4, 1, 2560), "ragged": (4, 515, 2563)}
RG_CASES = [(4, 512, 2560), (4, 1, 2560), (3, 37, 77), (1, 9, 1), (2, 0, 5), (4, 515, 2560),
            (2, 100, 36), (2, 100, 37), (1, 64, 8), (1, 31, 4), (2, 32, 32), (2, 33, 64),
            (3, 67, 100), (1, 1, 4), (2, 16, 2560), (2, 15, 2560), (4, 515, 2563)]
RG_SWEEP = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def load_rg_baseline(src: Path, workdir: Path):
    """Compile an older ``rg_lru.cu`` (v1's C entry points, no v2) and
    declare its two entry points; the package's launch helpers launch it as
    v1."""
    loaded = compile_text("rg_lru", src.read_text(), workdir, "baseline")
    for fn, n in ((loaded.rg_lru_scan_f32, 5), (loaded.rg_lru_scan_bwd_f32, 8)):
        fn.argtypes = [ctypes.c_void_p] * n + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return loaded


def rg_inputs(g, shape, offset: int = 0):
    """The forward's (a, g, h0) and the gradient's (a, y, h0, dy, dhT) at
    ``shape`` from ``g``, the (B, T, R) operands ``offset`` floats in."""
    import torch
    from repro_torch.kernels import ref
    b, t, r = shape
    a = torch.rand((b, t, r), generator=g, device="cuda")
    gate = torch.randn((b, t, r), generator=g, device="cuda")
    h0 = torch.randn((b, r), generator=g, device="cuda")
    y, _ = ref.rg_lru_scan_ref(a, gate, h0)
    dy = torch.randn((b, t, r), generator=g, device="cuda")
    dht = torch.randn((b, r), generator=g, device="cuda")
    if offset:
        a, gate, y, dy = (cs._rg_place(x, offset) for x in (a, gate, y, dy))
    return (a, gate, h0), (a, y, h0, dy, dht)


def rg_runs(builds: dict, fwd: bool, x, variants: bool):
    """label -> the call of each build (``builds``: label -> (lib, "v1" for
    the launch helper's v1, or None for the wrapper and its plan)); with
    ``variants`` the checkout's v1 and v2 through the launch helper too,
    where they apply. ``x`` is contiguous, as the helpers take it."""
    from repro_torch.kernels import rg_lru as krg
    fn = krg.rg_lru_scan if fwd else krg.rg_lru_scan_bwd
    launch = krg._launch_scan if fwd else krg._launch_scan_bwd
    calls = {}
    for label, (lib, kind) in builds.items():
        calls[label] = (lib, (lambda: fn(*x)) if kind is None
                        else (lambda k=kind: launch(k, *x)))
    if variants:
        takes_v2 = x[0].shape[2] % 4 == 0 and krg._aligned(*(o for o in x if o.ndim == 3))
        for v in ("v1", "v2") if takes_v2 else ("v1",):
            calls[f"own {v}"] = (None, lambda v=v: launch(v, *x))
    return calls


def check_rg_bits(builds: dict) -> list:
    """Every build's forward and gradient (and the checkout's v1 and v2
    through the launch helpers) against ``rg_lru_scan_ref`` and ``rg_lru_scan_bwd_ref`` as int32
    words, at every shape of the tests and ``chip_smoke.py``, contiguous and
    one float in; returns the differing cases."""
    import torch
    from repro_torch.kernels import ref, rg_lru as krg
    g = torch.Generator(device="cuda").manual_seed(28)
    bad, count, plans = [], 0, {"v1": 0, "v2": 0}
    for shape, offset in itertools.product(RG_CASES, (0, 1)):
        fx, bx = rg_inputs(g, shape, offset)
        for fwd, x, want in ((True, fx, ref.rg_lru_scan_ref(*fx)),
                             (False, bx, ref.rg_lru_scan_bwd_ref(*bx))):
            plans[krg._plan(shape[1], shape[2], offset == 0)] += 1
            for label, (lib, call) in rg_runs(builds, fwd, x, True).items():
                with using("rg_lru", lib):
                    got = call()
                for part, p, q in zip(("y", "hT") if fwd else ("da", "dg", "dh0"), got, want):
                    count += 1
                    if not torch.equal(p.view(torch.int32), q.view(torch.int32)):
                        bad.append(f"{label}: {part} {shape} +{offset}")
    torch.cuda.synchronize()
    print(f"[bits] {count} comparisons ({plans['v1']} calls planned v1, {plans['v2']} v2): "
          f"{len(bad)} differ {bad[:10] if bad else ''}", flush=True)
    return bad


def rg_cost(shape, fwd: bool) -> tuple[int, int]:
    """(bytes, operations) of a call: ``chip_smoke.py``'s."""
    return (cs._rg_cost if fwd else cs._rg_bwd_cost)(*shape)


def rg_in_turns(kname: str, shape, mode: str, calls: dict, reps: int, nbytes: int,
                ops: int) -> dict:
    """Each call timed in turns, forward then back, by the host loop and a
    CUDA graph; the row with the bound, each call's share of it and the
    bytes a second it reaches (by the graph), printed."""
    from repro_torch.kernels import rg_lru as krg
    runs: dict = {label: [] for label in calls}
    for label in [*calls, *reversed(calls)]:
        lib, fn = calls[label]
        with using("rg_lru", lib):
            runs[label].append((cs.time_ms(fn, reps, warmup=2), cs.device_ms(fn, reps)))
    bound = 1e3 * max(nbytes / cs.HBM_BYTES_PER_S, ops / cs.FP32_FLOPS)
    row = turns_row(kname, shape, mode, reps, bound, runs)
    row.update(bytes=nbytes, ops=ops, plan=krg._plan(shape[1], shape[2], True),
               tb_per_s={k: nbytes / v / 1e9 for k, v in row["device_ms"].items()})
    print(f"[rate] {kname} {'x'.join(map(str, shape))} {mode}: _plan {row['plan']}; TB/s "
          + "; ".join(f"{k} {v:.3f}" for k, v in row["tb_per_s"].items()), flush=True)
    return row


def rg_sets(g, shape, n: int) -> tuple[list, list]:
    """``n`` operand sets at ``shape``: the forward's args of each, and the
    gradient's, as batch slices of one allocation (every slice 16-byte
    aligned)."""
    b = shape[0]
    fx, bx = rg_inputs(g, (n * b, *shape[1:]))
    return [tuple(x[i * b:(i + 1) * b] for x in fx) for i in range(n)], \
        [tuple(x[i * b:(i + 1) * b] for x in bx) for i in range(n)]


def rg_hot_stream(kname: str, shape, builds: dict, sets, reps: int, variants: bool) -> list:
    """The "hot" row (the first set, relaunched) and the "stream" row (the
    sets in turn, ``reps`` of them at least: operands that L2 does not hold)
    of one kernel."""
    import torch
    fwd = kname == "rg_lru_scan"
    cost = rg_cost(shape, fwd)
    per_set = [rg_runs(builds, fwd, x, variants) for x in sets]
    if fwd and builds:
        for calls, x in zip(per_set, sets):     # the same bytes, no chain: a yardstick
            out = torch.empty_like(x[0])
            calls["torch.add"] = (None, lambda x=x, out=out: torch.add(x[0], x[1], out=out))
    rows = [rg_in_turns(kname, shape, "hot", per_set[0], reps, *cost)]
    if len(per_set) > 1:
        stream = {label: (lib, cycle_calls([p[label][1] for p in per_set]))
                  for label, (lib, _) in per_set[0].items()}
        rows.append(rg_in_turns(kname, shape, "stream", stream, max(reps, len(sets)), *cost))
    return rows


def rg_timings(builds: dict) -> list:
    """Both kernels at the main shapes, every build in turns ("hot": one
    set of operands relaunched, as the CUDA-graph yardstick of
    ``chip_smoke.py`` has it; "stream": operand sets in turn, ~150 MB of
    them, so that L2 holds none of a call's operands), and the T sweep of
    the checkout's v1 against its v2, both ways (where they meet sets
    ``_plan``'s ``V2_MIN_STEPS``)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(29)
    rows = []

    def sets_of(shape):
        return rg_sets(g, shape, max(1, -(-150_000_000 // (12 * math.prod(shape)))))

    for kind, shape in RG_MAIN.items():
        fsets, bsets = sets_of(shape) if kind != "ragged" else rg_sets(g, shape, 1)
        reps = 48 if shape[1] > 1 else 500
        rows += rg_hot_stream("rg_lru_scan", shape, builds, fsets, reps, False)
        rows += rg_hot_stream("rg_lru_scan_bwd", shape, builds, bsets, reps, False)
        del fsets, bsets
    for t in RG_SWEEP:
        shape = (4, t, 2560)
        fsets, bsets = sets_of(shape)
        rows += rg_hot_stream("rg_lru_scan", shape, {}, fsets, 200, True)
        rows += rg_hot_stream("rg_lru_scan_bwd", shape, {}, bsets, 200, True)
        del fsets, bsets
    return rows


def cycle_calls(fns):
    """A call that runs the next of ``fns`` each time, in turn."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", required=True,
                    choices=("ed", "lb_sax", "wkv6", "wkv6_bwd", "dtw", "rg_lru"),
                    help="which source under src/repro_torch/kernels/csrc to compare")
    ap.add_argument("--baseline", default=None,
                    help="an older <kernel>.cu with the same C entry points (not for dtw, "
                         "whose v1 is in the checkout)")
    ap.add_argument("--trial", action="append", default=[], metavar="LABEL=WORDS",
                    help="also build the checkout's source as trial state LABEL: words "
                         "(space-separated) that start with '-' are extra nvcc flags, "
                         "NAME=VALUE sets its 'constexpr int NAME' in a copy")
    ap.add_argument("--baseline-trial", action="append", default=[], metavar="LABEL=WORDS",
                    help="also build the baseline's source so (--kernel wkv6_bwd)")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    if (args.kernel == "dtw") != (args.baseline is None) or (args.kernel == "dtw"
                                                              and args.trial):
        ap.error("--baseline (and --trial) go with --kernel ed|lb_sax|wkv6|wkv6_bwd|rg_lru, "
                 "not dtw")
    if args.baseline_trial and args.kernel != "wkv6_bwd":
        ap.error("--baseline-trial goes with --kernel wkv6_bwd")

    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    if args.kernel == "dtw":
        bad = check_dtw_bits()
        rows = dtw_timings()
    else:
        bad, rows = compare_builds(args)
    extra = {}
    if args.kernel == "wkv6_bwd":
        rows, extra["float64"] = rows
    line = json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                       "kernel": args.kernel, "bits_differ": bad, "timings": rows, **extra})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 1 if bad else 0


def compare_builds(args) -> tuple[list, list]:
    """The bits and times of ``--kernel ed|lb_sax|wkv6|rg_lru``: the baseline's
    build against the checkout's (and each trial's)."""
    with tempfile.TemporaryDirectory(prefix="kernel-ab-") as tmp:
        from repro_torch.kernels import _build
        if args.kernel == "wkv6_bwd":
            return compare_bwd_builds(args, Path(tmp))
        if args.kernel == "rg_lru":
            builds = {"v1": (load_rg_baseline(Path(args.baseline).resolve(), Path(tmp)), "v1"),
                      "v2": (None, None)}
            for trial in args.trial:
                label, _, words = trial.partition("=")
                builds[label] = (load_baseline("rg_lru", _build.CSRC / "rg_lru.cu", Path(tmp),
                                               label, words), None)
            return check_rg_bits(builds), rg_timings(builds)
        builds = {"v1": load_baseline(args.kernel, Path(args.baseline).resolve(), Path(tmp)),
                  "v2": None}
        for trial in args.trial:
            label, _, words = trial.partition("=")
            builds[label] = load_baseline(args.kernel, _build.CSRC / f"{args.kernel}.cu",
                                          Path(tmp), label, words)
        if args.kernel == "lb_sax":
            bad = check_lb_bits(builds)
            rows = lb_timings(builds)
        elif args.kernel == "wkv6":
            bad = check_wkv6_bits(builds)
            rows = wkv_timings(builds)
        else:
            bad = check_ed_bits(builds)
            with using("ed", None):
                for qn, num, n in ED_MAIN:
                    s = walks(num, n, 91)
                    cs.hold_witness(walks(qn, n, 90), s, cs.bf16_payload(s), f"{qn}x{num}x{n}")
            print("[witness] row minima and first argmins equal ed_min's at the main shapes",
                  flush=True)
            rows = ed_timings(builds)
    return bad, rows


def compare_bwd_builds(args, tmp: Path) -> tuple[list, tuple]:
    """``--kernel wkv6_bwd``: the baseline (and its trials), the checkout's
    build and its trials; bits, distances from float64, times."""
    from repro_torch.kernels import _build
    base = Path(args.baseline).resolve()
    builds = {"v1": load_bwd(base, tmp, "v1")}
    for trial in args.baseline_trial:
        label, _, words = trial.partition("=")
        builds[label] = load_bwd(base, tmp, label, words)
    builds["v2"] = own_bwd()
    own = {"v2"}
    for trial in args.trial:
        label, _, words = trial.partition("=")
        builds[label] = load_bwd(_build.CSRC / "wkv6_bwd.cu", tmp, label, words)
        own.add(label)
    bad = check_wkv6_bwd_bits(builds, own)
    far = wkv6_bwd_distance(builds)
    return bad, (wkv6_bwd_timings(builds), far)


if __name__ == "__main__":
    sys.exit(main())
