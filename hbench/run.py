#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 hbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run makes the cell's collection and query pool on the card from
``--seed``, builds the cell's backend with the configuration's builder
(``builders/<name>.py``), serves one wave of each k to warm up (set-up ends
there), then drives a ``KnnServeEngine`` with the cell's load for
``--seconds``.
With ``--trace 1`` it then traces a stretch of further waves with
``torch.profiler``. It serves every request still open, frees the
program's state, and holds every answer handed out to the plain reference
(``compare.py``). The last lines on standard error give each compared
number beside its limit; the last line on standard output is the result:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones, each read by its own
``metrics/<name>.py``), ``device`` and, traced, ``breakdown``; ``check``
comes last.

It exits non-zero with no result where there is no CUDA card (or fewer
than the cell asks for), where ``repro_torch`` is not the checkout's own,
and where ``jax``, ``jaxlib``, ``flax`` or ``repro`` is loaded once the
window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pkgutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from hbench import compare, context, gen, loop, spec, trace as trace_mod  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# build and kernel caches, at fixed paths inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "nv_compute_cache"}
TRACE_MIN_WAVES = 2
TRACE_MIN_SECONDS = 2.0


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (or ``names``) whose top-level name is one of
    ``FORBIDDEN``, compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launch_counts() -> tuple[dict, dict]:
    """Every kernel wrapper's ``launches`` and ``launches_by`` counters in
    ``repro_torch.kernels``, by wrapper name."""
    import repro_torch.kernels as kernels

    launches, by = {}, {}
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"repro_torch.kernels.{info.name}")
        for name, obj in vars(mod).items():
            if not callable(obj):
                continue
            n = getattr(obj, "launches", None)
            if isinstance(n, int) and not isinstance(n, bool):
                launches[name] = n
            if isinstance(getattr(obj, "launches_by", None), dict):
                by[name] = dict(obj.launches_by)
    return launches, by


def snapshot(serve) -> dict:
    """The program's counters now: the serving engine's ``telemetry()`` as
    a plain dict, with every kernel wrapper's ``launches`` and
    ``launches_by``."""
    snap = dataclasses.asdict(serve.telemetry())
    snap["launches"], snap["launches_by"] = launch_counts()
    return snap


def _check_program(root: Path):
    import repro_torch

    src = (Path(root) / "src").resolve()
    where = Path(repro_torch.__file__).resolve()
    if src not in where.parents:
        raise RuntimeError(f"repro_torch was imported from {where}, not from {src}")


def _shape(cfg: dict, traffic: dict, backend) -> dict:
    from repro_torch.core.search import SearchConfig

    shape = {"slots": traffic["slots"], "rows": cfg["num_series"], "n": cfg["series_len"],
             "scan_block": SearchConfig(**cfg.get("search", {})).scan_block}
    index = getattr(backend, "index", None)
    if index is not None:
        shape["sax_words"], shape["sax_segments"] = (int(s) for s in index.layout.lsd.shape)
    return shape


def log(msg: str) -> None:
    print(f"hbench: {msg}", file=sys.stderr, flush=True)


def _finite(x: float):
    return x if math.isfinite(x) else str(x)


def run_cell(cell_name: str, seed: int, seconds: float, trace: int, *,
             device: str = "cuda", root: Path = ROOT, overrides: dict | None = None,
             t_start: float | None = None,
             trace_min_seconds: float = TRACE_MIN_SECONDS) -> dict:
    """One run of one cell; returns the result object. ``overrides``
    ({"config": {...}, "traffic": {...}}, merged group by group) resize a
    cell for a test on the CPU; ``t_start`` is when set-up began (default:
    process start)."""
    from repro_torch.serve.engine import KnnAnswer, KnnServeConfig, KnnServeEngine
    from repro_torch.core.engine import QueryEngine

    _check_program(root)
    t_start = T_START if t_start is None else t_start
    log(f"program imported at {time.perf_counter() - t_start:.2f}s")
    overrides = overrides or {}
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, cell_name)
    cfg = spec.merged(spec.config(bench, cell["config"], root), overrides.get("config", {}))
    traffic = spec.merged(spec.traffic(cell["traffic"], root), overrides.get("traffic", {}))
    dev = torch.device(device)
    torch.empty(1, device=dev)
    log(f"device ready at {time.perf_counter() - t_start:.2f}s")
    data = gen.random_walks(cfg["num_series"], cfg["series_len"],
                            gen.generator(seed, "collection", dev), dev)
    levels, ks = gen.mix(traffic, traffic["pool"], seed, "pool")
    pool = gen.queries(data, levels, seed, "pool")
    pool_np = pool.cpu().numpy()
    log(f"collection {tuple(data.shape)} and {len(pool_np)} queries made at "
        f"{time.perf_counter() - t_start:.2f}s")

    backend, build_s = spec.builder(cfg["builder"], root).build(cfg, data, dev)
    engine = QueryEngine(backend)
    serve = KnnServeEngine(engine, KnnServeConfig(
        batch_slots=traffic["slots"], wave=traffic["wave"], pack=traffic["pack"]))
    shape = _shape(cfg, traffic, backend)
    log(f"backend {cfg['backend']} ready at {time.perf_counter() - t_start:.2f}s "
        f"(build {build_s:.3f}s)")

    # warm-up: one full wave of each k, the only shapes the window uses
    slots, hard = traffic["slots"], traffic["difficulty"]
    for k in traffic["k"]:
        warm = gen.queries(data, [hard[i % len(hard)] for i in range(slots)], seed,
                           f"warmup/{k}").cpu().numpy()
        for q in warm:
            serve.submit(q, k=int(k))
        serve.drain()
    _sync(dev)

    load = loop.Load(serve, pool_np, ks, traffic)
    spans = {}
    s0 = snapshot(serve)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    load.start()
    t1 = load.run_until(t0 + seconds)
    spans["window"] = (s0, snapshot(serve))
    log(f"set-up {setup_s:.2f}s; window {t1 - t0:.2f}s: "
        f"{spans['window'][1]['serving']['waves'] - s0['serving']['waves']} waves, "
        f"{load.answered_in('window')} answers")

    summary = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        s1 = snapshot(serve)
        load.phase = "trace"
        with profile(activities=acts) as prof:
            _sync(dev)
            ts = time.perf_counter()
            waves = 0
            while waves < TRACE_MIN_WAVES or time.perf_counter() - ts < trace_min_seconds:
                load.step()
                waves += 1
            _sync(dev)
            te = time.perf_counter()
        spans["stretch"] = (s1, snapshot(serve))
        summary = trace_mod.from_profiler(prof, te - ts)
        del prof

    load.phase = "drain"
    load.drain()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None

    # free the program's state before the reference runs
    served = [(r[2], r[3], r[5].dists, r[5].ids) for r in load.records
              if isinstance(r[5], KnnAnswer)]
    attempted = load.attempted
    readings = {"answered": load.answered_in("window"), "window_s": t1 - t0,
                "latencies": load.latencies("window"), "build_s": build_s,
                "peak_bytes": peak, "setup_s": setup_s}
    del serve, engine, backend, load
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers, detail = compare.judge_served(data, pool, served, attempted)
    log(f"reference: {len(served)} answers held in {time.perf_counter() - t_ref:.2f}s "
        f"({detail['scans']} queries by the full scan); dist_gap {detail['dist_gap']!r}, "
        f"id_gap {detail['id_gap']!r}")
    correct = compare.passes(numbers)

    ctx = context.Context(readings, spans, summary, shape, root)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end)(bench, cell_name):
        val = spec.metric_reader(m["name"], root).read(ctx)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        elif not trace and dev.type == "cuda":    # the CPU has no allocator peak
            raise KeyError(f"the harness read no value of {m['name']!r} in this cell")

    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": attempted - len(served),
              "metrics": metrics, "device": dev_info}
    if summary is not None:
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["check"] = {name: {"value": _finite(numbers[name]), "limit": limit}
                       for name, limit in compare.LIMITS.items()}
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load_benchmark(ROOT), args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"hbench: the cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{have} available", file=sys.stderr)
        return 3
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / "build" / "hbench" / sub)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(args.workload, args.seed, args.seconds, args.trace)
    bad = forbidden_modules()
    if bad:
        print(f"hbench: modules loaded that the port must not load: {bad}", file=sys.stderr)
        return 4
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
