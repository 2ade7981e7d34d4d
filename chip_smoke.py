#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Hercules on one CUDA card.

    python3 chip_smoke.py                      # the full run (2**22 x 256)
    python3 chip_smoke.py --num-series 65536   # a short check

Phases (any failure ends the run with a non-zero exit):

1. device: a CUDA card must be present; print its name and power limit;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels vs plain versions at adversarial shapes (ragged N and n,
   ``valid_n`` masking, ties, an all-inf row, bf16 series);
4. the main path at a real size: the paper's Synth random walks (length
   256), a Hercules index with 4096-series leaves, 100 queries at the "5%"
   hardness answered for k=1 and k=10 through ``QueryEngine`` over the
   ``local`` and ``scan`` backends (``kernel_mode="auto"``), held against a
   brute-force difference-form scan on the card; every kernel's launch
   counter must have risen during this phase;
5. kernels vs plain versions at the main path's shapes, with CUDA-event
   times for kernel, plain version and library call, and the bound;
6. the card's answers against the CPU's on a small input (the CPU path is
   the one the test suite holds against the JAX reference).

The line before the last two is ``{"kernels": [...]}``; then the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=2.5e-1)}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def assert_close(got, want, dtype: str, what: str) -> float:
    import torch
    got = got.float().cpu()
    want = want.float().cpu()
    tol = TOL[dtype]
    finite = torch.isfinite(want)
    check(torch.equal(finite, torch.isfinite(got)), f"{what}: inf pattern differs")
    check(torch.equal(got[~finite], want[~finite]), f"{what}: infinite values differ")
    err = (got[finite] - want[finite]).abs()
    lim = tol["atol"] + tol["rtol"] * want[finite].abs()
    bad = int((err > lim).sum())
    check(bad == 0, f"{what}: {bad} elements outside rtol={tol['rtol']} "
                    f"atol={tol['atol']} (max abs err {float(err.max()):.3e})")
    return float(err.max()) if err.numel() else 0.0


def decisive_rows(d_ref) -> "torch.Tensor":
    """Rows whose best distance beats the runner-up by more than the
    matmul-identity rounding band (the conformance suite's rule)."""
    import torch
    two = torch.topk(d_ref, min(2, d_ref.shape[1]), dim=1, largest=False).values
    if two.shape[1] < 2:
        return torch.ones(d_ref.shape[0], dtype=torch.bool, device=d_ref.device)
    return (two[:, 1] - two[:, 0]) > 1e-3 * two[:, 0].clamp_min(1.0)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[device] {name} x{torch.cuda.device_count()} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi


def phase_build():
    from repro_torch.kernels import _build
    info = _build.build_all()
    log(f"[build] {info['seconds']:.2f}s for {info['built']} into {info['dir']}")
    for name in _build.SOURCES:
        log_path = Path(info["dir"]) / f"{name}.log"
        if log_path.is_file():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
    return info["seconds"]


def phase_adversarial():
    import torch
    from repro_torch.core import summaries as S
    from repro_torch.kernels import ed as ked, lb_sax as klb, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    # ed_matrix: ragged shapes, float32 and bf16 series
    for (q, n, length) in [(1, 1, 1), (1, 100, 128), (5, 77, 48), (8, 129, 33),
                           (130, 4097, 256)]:
        qa, sa = randn(q, length), randn(n, length)
        assert_close(ked.ed_matrix(qa, sa), ref.ed_matrix_ref(qa, sa), "float32",
                     f"ed_matrix f32 {q}x{n}x{length}")
        sb = sa.to(torch.bfloat16)
        assert_close(ked.ed_matrix(qa, sb), ref.ed_matrix_ref(qa, sb), "bfloat16",
                     f"ed_matrix bf16 {q}x{n}x{length}")
    # ed_min: ragged shapes, valid_n masking, ties, all-inf rows
    for (q, n, length) in [(1, 1, 1), (3, 13, 64), (5, 77, 48), (70, 5000, 256)]:
        qa, sa = randn(q, length), randn(n, length)
        for valid in (n, max(1, n // 2)):
            dmin, amin = ked.ed_min(qa, sa, valid_n=valid)
            want_d, want_a = ref.ed_min_ref(qa, sa, valid_n=valid)
            assert_close(dmin, want_d, "float32", f"ed_min {q}x{n}x{length} valid {valid}")
            dec = decisive_rows(ref.ed_matrix_ref(qa, sa[:valid]))
            check(torch.equal(amin[dec], want_a[dec]),
                  f"ed_min argmin {q}x{n}x{length} valid {valid}")
    dmin, amin = ked.ed_min(torch.zeros(4, 16, device=dev), torch.ones(200, 16, device=dev))
    check(bool((amin == 0).all()) and bool((dmin == 16).all()), "ed_min tie -> lowest index")
    dmin, amin = ked.ed_min(torch.full((2, 16), 2e19, device=dev),
                            torch.full((300, 16), -2e19, device=dev))
    check(bool(torch.isinf(dmin).all()) and bool((amin == 0).all()),
          "ed_min all-inf row -> (inf, 0)")
    # lb_sax: ragged N, m in {8, 16}, several alphabets, extreme PAA
    for (q, n, m, alphabet) in [(1, 1, 16, 256), (5, 77, 16, 256), (3, 130, 8, 64),
                                (9, 5001, 16, 16), (1, 70001, 16, 256)]:
        length = 4 * m
        q_paa = S.paa(randn(q, length), m)
        codes = S.isax(randn(n, length), m, alphabet)
        got = klb.lb_sax_matrix(q_paa, codes, length, alphabet)
        want = ref.lb_sax_matrix_ref(q_paa, codes, length, alphabet)
        assert_close(got, want, "float32", f"lb_sax {q}x{n} m={m} a={alphabet}")
        check(torch.equal(got, want), f"lb_sax {q}x{n}: kernel and plain version differ in bits")
    q_paa = torch.full((2, 16), 1e15, device=dev)
    codes = S.isax(randn(7, 64), 16)
    check(torch.equal(klb.lb_sax_matrix(q_paa, codes, 64),
                      ref.lb_sax_matrix_ref(q_paa, codes, 64)), "lb_sax extreme PAA")
    torch.cuda.synchronize()
    log("[kernels] adversarial shapes: ed_matrix (f32, bf16), ed_min, lb_sax agree "
        "with their plain versions")


def reset_counters():
    from repro_torch.kernels import ed as ked, lb_sax as klb
    klb.lb_sax_matrix.launches = 0
    ked.ed_matrix.launches = 0
    ked.ed_min.launches = 0


def read_counters() -> dict:
    from repro_torch.kernels import ed as ked, lb_sax as klb
    return {"lb_sax_matrix": klb.lb_sax_matrix.launches,
            "ed_min": ked.ed_min.launches, "ed_matrix": ked.ed_matrix.launches}


def phase_main(num_series: int, num_queries: int):
    import torch
    from repro_torch.core.engine import QueryEngine, dense_scan_knn, make_backend
    from repro_torch.core.index import IndexConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.tree import BuildConfig
    from repro_torch.data.synthetic import make_query_workload, random_walks

    length = 256
    t0 = time.perf_counter()
    data = random_walks(num_series, length, seed=0)
    queries = make_query_workload(data, num_queries, "5%", seed=1)
    torch.cuda.synchronize()
    log(f"[main] data {num_series} x {length} float32 "
        f"({num_series * length * 4 / 2**30:.2f} GiB) made in "
        f"{time.perf_counter() - t0:.2f}s")
    search = SearchConfig(kernel_mode="auto")
    icfg = IndexConfig(build=BuildConfig(leaf_capacity=4096), search=search)

    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    local = make_backend("local", data, index_config=icfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    st = local.stats()
    log(f"[main] local index built in {build_s:.2f}s: {st['num_leaves']} leaves, "
        f"depth {st['max_depth']}, leaf sizes {st['min_leaf']}..{st['max_leaf']}, "
        f"N_pad {local.index.layout.lrd.shape[0]}")
    scan = make_backend("scan", data, search=search)
    engines = {"local": QueryEngine(local), "scan": QueryEngine(scan)}
    answers, timing = {}, {}
    for k in (1, 10):
        for name, eng in engines.items():
            t0 = time.perf_counter()
            res = eng.knn(queries, k=k)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            answers[(name, k)] = res
            timing[(name, k)] = 1e3 * dt / num_queries
            log(f"[main] {name} k={k}: {1e3 * dt:.1f} ms for {num_queries} queries "
                f"({timing[(name, k)]:.3f} ms/query)")
    launches = read_counters()
    log(f"[main] kernel launches during the main path: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[main] peak device memory {peak:.2f} GiB")

    t0 = time.perf_counter()
    ref_d, ref_p = dense_scan_knn(data, queries, k=10)
    torch.cuda.synchronize()
    log(f"[main] brute-force difference-form scan (ref mode): "
        f"{time.perf_counter() - t0:.2f}s")
    for k in (1, 10):
        want_d, want_p = ref_d[:, :k], ref_p[:, :k]
        for name in engines:
            res = answers[(name, k)]
            check(torch.equal(res.ids.long(), want_p.long()),
                  f"{name} k={k}: ids differ from the brute-force scan "
                  f"({int((res.ids.long() != want_p.long()).sum())} entries)")
            rel = ((res.dists - want_d).abs() / want_d.abs().clamp_min(1e-30)).max()
            check(float(rel) <= 1e-5, f"{name} k={k}: dists off by {float(rel):.3e} rel")
        same = torch.equal(answers[("local", k)].dists, answers[("scan", k)].dists)
        log(f"[main] k={k}: local and scan ids equal the brute-force scan; "
            f"dists bit-identical local vs scan: {same}")
    for name, eng in engines.items():
        t = eng.telemetry()
        log(f"[main] {name} telemetry: paths {vars(t.paths)} pruning "
            f"{vars(t.pruning)} plan_cache hits={t.plan_cache.hits} "
            f"misses={t.plan_cache.misses}")
    n_blocks = math.ceil(num_series / search.scan_block)
    check(launches["lb_sax_matrix"] >= num_queries,
          f"lb_sax_matrix launched {launches['lb_sax_matrix']} < {num_queries} times")
    check(launches["ed_min"] >= 1, "ed_min never launched")
    check(launches["ed_matrix"] >= n_blocks,
          f"ed_matrix launched {launches['ed_matrix']} < {n_blocks} times")
    summary = {"build_s": build_s, "leaves": st["num_leaves"], "depth": st["max_depth"],
               "ms_per_query": {f"{a}_k{b}": v for (a, b), v in timing.items()},
               "peak_gib": peak}
    return data, queries, local, launches, summary


def phase_kernel_timing(data, queries, local, launches):
    import torch
    from repro_torch.core import summaries as S
    from repro_torch.kernels import ed as ked, lb_sax as klb, ref

    rows = []
    bucket = 1 << (queries.shape[0] - 1).bit_length()
    qb = torch.cat([queries, queries.new_zeros((bucket - queries.shape[0],
                                                queries.shape[1]))])
    num, n = data.shape

    # lb_sax_matrix: one query row against the whole LSD sidecar (phase 3)
    lsd = local.index.layout.lsd
    q_paa = S.paa(queries[:1], lsd.shape[1])
    got = klb.lb_sax_matrix(q_paa, lsd, n)
    want = ref.lb_sax_matrix_ref(q_paa, lsd, n)
    err = assert_close(got, want, "float32", "lb_sax main shape")
    check(torch.equal(got, want), "lb_sax main shape: bits differ")
    m = lsd.shape[1]
    nbytes = q_paa.numel() * 4 + lsd.numel() + 2 * 256 * 4 + got.numel() * 4
    ops = got.numel() * (6 * m + 1)
    rows.append(dict(
        name="lb_sax_matrix", route="cuda",
        source="src/repro_torch/kernels/csrc/lb_sax.cu",
        replaces="src/repro/kernels/lb_sax.py:69",
        shape=[1, lsd.shape[0], m], launches=launches["lb_sax_matrix"],
        max_abs_err=err,
        ms=time_ms(lambda: klb.lb_sax_matrix(q_paa, lsd, n), reps=50, warmup=3),
        plain_ms=time_ms(lambda: ref.lb_sax_matrix_ref(q_paa, lsd, n), reps=5),
        library_ms=None, bytes=nbytes, ops=ops))

    # ed_min: the k=1 scan, the query bucket against the whole collection
    dmin, amin = ked.ed_min(qb, data, valid_n=num)
    d_ref = ref.ed_matrix_ref(qb, data)
    want_d, want_a = torch.min(d_ref, dim=1)
    err = assert_close(dmin, want_d, "float32", "ed_min main shape")
    dec = decisive_rows(d_ref)
    dec[queries.shape[0]:] = False          # bucket padding rows tie everywhere
    check(bool(dec[:queries.shape[0]].float().mean() > 0.9),
          "ed_min main shape: fewer than 90% of the queries are decisive")
    check(torch.equal(amin[dec].long(), want_a[dec]), "ed_min main shape: argmin differs")
    del d_ref
    lib_min = lambda: torch.cdist(qb, data, compute_mode="use_mm_for_euclid_dist").square().min(1)
    rows.append(dict(
        name="ed_min", route="cuda", source="src/repro_torch/kernels/csrc/ed.cu",
        replaces="src/repro/kernels/ed.py:141", shape=[bucket, num, n],
        launches=launches["ed_min"], max_abs_err=err,
        ms=time_ms(lambda: ked.ed_min(qb, data, valid_n=num), reps=5),
        plain_ms=time_ms(lambda: ref.ed_min_ref(qb, data, valid_n=num), reps=1),
        library_ms=time_ms(lib_min, reps=3),
        bytes=(qb.numel() + data.numel()) * 4 + bucket * 8,
        ops=2 * bucket * num * n))

    # ed_matrix: the k>1 scan, the query bucket against one scan block
    blk = data[:4096]
    got = ked.ed_matrix(qb, blk)
    err = assert_close(got, ref.ed_matrix_ref(qb, blk), "float32", "ed_matrix main shape")
    lib_mat = lambda: torch.cdist(qb, blk, compute_mode="use_mm_for_euclid_dist").square()
    rows.append(dict(
        name="ed_matrix", route="cuda", source="src/repro_torch/kernels/csrc/ed.cu",
        replaces="src/repro/kernels/ed.py:110", shape=[bucket, blk.shape[0], n],
        launches=launches["ed_matrix"], max_abs_err=err,
        ms=time_ms(lambda: ked.ed_matrix(qb, blk), reps=200, warmup=5),
        plain_ms=time_ms(lambda: ref.ed_matrix_ref(qb, blk), reps=10),
        library_ms=time_ms(lib_mat, reps=50, warmup=3),
        bytes=(qb.numel() + blk.numel() + got.numel()) * 4,
        ops=2 * bucket * blk.shape[0] * n))

    for r in rows:
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / FP32_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[timing] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes']} B, {r['ops']} ops)")
    return rows


def phase_profile(data, queries, local):
    """Opt-in (``--profile``): trace 16 queries per backend with
    torch.profiler and report wall time, summed device-kernel time (one
    stream, so kernels do not overlap), the device idle share and the
    operators that hold the device longest."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import QueryEngine, make_backend

    q = queries[:16]
    for name, backend, k in (("local", local, 1), ("local", local, 10),
                             ("scan", make_backend("scan", data), 1),
                             ("scan", make_backend("scan", data), 10)):
        eng = QueryEngine(backend)
        eng.knn(q, k=k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.knn(q, k=k)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        by_name: dict = {}
        for e in kernels:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        log(f"[profile] {name} k={k}, 16 queries: wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
            f"{len(kernels)} kernel launches")
        for kname, (t, c) in top:
            log(f"[profile]   {t:9.3f} ms {c:6d}x  {kname[:110]}")


def phase_cpu_agreement():
    """The card's answers equal the CPU's on a small input, bit for bit for
    the index (same arithmetic on both devices) and by ids for the scans."""
    import numpy as np
    import torch
    from repro_torch.core.engine import QueryEngine, make_backend
    from repro_torch.core.index import IndexConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.tree import BuildConfig

    rng = np.random.default_rng(3)
    x = np.cumsum(rng.standard_normal((8192, 256)), axis=1)
    x = ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)).astype(np.float32)
    q = (x[rng.integers(0, 8192, 16)]
         + rng.standard_normal((16, 256)) * np.sqrt(0.05)).astype(np.float32)
    icfg = IndexConfig(build=BuildConfig(leaf_capacity=256),
                       search=SearchConfig(chunk=256, scan_block=1024))
    res, trees = {}, {}
    for dev in ("cpu", "cuda"):
        for name in ("local", "scan"):
            backend = make_backend(name, x, index_config=icfg, device=dev)
            if name == "local":
                trees[dev] = backend.index.tree
            eng = QueryEngine(backend)
            res[(dev, name)] = [eng.knn(q, k=k) for k in (1, 5)]
    for field in trees["cpu"]._fields:
        check(torch.equal(getattr(trees["cuda"], field).cpu(), getattr(trees["cpu"], field)),
              f"the card's tree differs from the CPU's in {field}")
    for a, b in zip(res[("cpu", "local")], res[("cuda", "local")]):
        for field in a._fields:
            check(torch.equal(getattr(a, field).cpu(), getattr(b, field).cpu()),
                  f"local on the card differs from the CPU in {field}")
    for a, b in zip(res[("cpu", "scan")], res[("cuda", "scan")]):
        check(torch.equal(a.ids.cpu(), b.ids.cpu()), "scan on the card: ids differ from CPU")
        check(torch.equal(a.dists.cpu(), b.dists.cpu()), "scan on the card: dists differ from CPU")
    log("[agree] 8192 x 256, 16 queries, k in (1, 5): the card builds the CPU's tree "
        "bit for bit; its local answers equal the CPU's in every field; scan ids and "
        "dists equal")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-series", type=int, default=1 << 22)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--profile", action="store_true",
                    help="also trace 16 queries per backend with torch.profiler")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"FAIL: {ROOT / 'src' / 'repro_torch'} is missing; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()

    name, smi = phase_device()
    phase_build()
    phase_adversarial()
    data, queries, local, launches, summary = phase_main(args.num_series, args.queries)
    rows = phase_kernel_timing(data, queries, local, launches)
    if args.profile:
        phase_profile(data, queries, local)
    del data, queries, local
    torch.cuda.empty_cache()
    phase_cpu_agreement()
    log(f"[main] summary {json.dumps(summary)}")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "bytes", "ops")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
