#!/usr/bin/env python3
"""Hold an older build of one of the port's CUDA sources against this
checkout's on one CUDA card.

    python3 tools/kernel_ab.py --kernel ed|lb_sax --baseline OLD.cu \
        [--trial LABEL=FLAGS ...] [--out FILE]

``--baseline`` is an older ``csrc/<kernel>.cu`` with the same C entry
points, for example the parent commit's (``git show
HEAD~1:src/repro_torch/kernels/csrc/lb_sax.cu`` into a gitignored
``build/`` path). It is compiled with the package's flags into a temporary
directory; the checkout's own build is the package's. Both are launched
through the package's wrappers (``repro_torch.kernels.ed`` or
``.lb_sax``), the baseline by standing in for the package's loaded
library of that name. Each ``--trial LABEL=FLAGS`` (for example
``A=-DED_MIN_TILES_ONLY``) also builds the checkout's source with the extra
``nvcc`` flags, a trial state that joins every bits check and timing.

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


def load_baseline(name: str, src: Path, workdir: Path, label: str = "baseline",
                  flags: tuple = ()) -> ctypes.CDLL:
    """Compile ``src`` with the package's flags (and ``flags``) and declare
    it as library ``name``."""
    from repro_torch.kernels import _build
    lib = workdir / f"lib{name}_{label}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    loaded = ctypes.CDLL(str(lib))
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", required=True, choices=("ed", "lb_sax"),
                    help="which source under src/repro_torch/kernels/csrc to compare")
    ap.add_argument("--baseline", required=True,
                    help="an older <kernel>.cu with the same C entry points")
    ap.add_argument("--trial", action="append", default=[], metavar="LABEL=FLAGS",
                    help="also build the checkout's source with these extra nvcc flags "
                         "(space-separated) as trial state LABEL")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    with tempfile.TemporaryDirectory(prefix="kernel-ab-") as tmp:
        from repro_torch.kernels import _build
        builds = {"v1": load_baseline(args.kernel, Path(args.baseline).resolve(), Path(tmp)),
                  "v2": None}
        for trial in args.trial:
            label, _, flags = trial.partition("=")
            builds[label] = load_baseline(args.kernel, _build.CSRC / f"{args.kernel}.cu",
                                          Path(tmp), label, tuple(flags.split()))
        if args.kernel == "lb_sax":
            bad = check_lb_bits(builds)
            rows = lb_timings(builds)
        else:
            bad = check_ed_bits(builds)
            with using("ed", None):
                for qn, num, n in ED_MAIN:
                    s = walks(num, n, 91)
                    cs.hold_witness(walks(qn, n, 90), s, cs.bf16_payload(s), f"{qn}x{num}x{n}")
            print("[witness] row minima and first argmins equal ed_min's at the main shapes",
                  flush=True)
            rows = ed_timings(builds)
    line = json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                       "kernel": args.kernel, "bits_differ": bad, "timings": rows})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
