"""End-to-end driver on PyTorch (the paper's kind: a query-serving system).

Builds a Hercules index over a synthetic collection on the CUDA card (or
``--device cpu``), saves and reloads it, and serves batched kNN workloads of
every difficulty level through the port's ``repro_torch.api`` surface: a
:class:`KnnServeEngine` (slot-based batching, ``--wave`` for the fused wave
plan) over a :class:`QueryEngine` over a :class:`LocalBackend`. It reports
latency, access paths, pruning and plan-cache behaviour, then checks the
answers against the dense-scan backend through the same surface.

    PYTHONPATH=src python examples/torch_serve_index.py [--num-series 100000]
    PYTHONPATH=src python examples/torch_serve_index.py --device cpu \\
        --num-series 20000 --queries 8 --wave
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.data.synthetic import (DIFFICULTY_LEVELS, make_query_workload,
                                        random_walks)
from repro_torch.device import synchronize


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-series", type=int, default=100_000)
    ap.add_argument("--length", type=int, default=128)
    ap.add_argument("--queries", type=int, default=20)
    ap.add_argument("--wave", action="store_true",
                    help="serve each wave through the fused wave plan")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    print(f"=== index construction: {args.num_series} x {args.length} ===")
    data = random_walks(args.num_series, args.length, seed=0, device=args.device)
    dev = data.device
    t0 = time.perf_counter()
    # small leaves + few phase-1 visits suit memory-resident collections
    idx = api.HerculesIndex.build(data, api.IndexConfig(
        build=api.BuildConfig(leaf_capacity=256),
        search=api.SearchConfig(k=1, l_max=8)), device=dev)
    synchronize(dev)
    print(f"built in {time.perf_counter() - t0:.1f}s  {idx.stats()}")

    # persist + reload (the reference's .npz file format)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hercules_demo.npz")
        idx.save(path)
        idx = api.HerculesIndex.load(path, device=dev)
        print(f"persisted + reloaded {os.path.getsize(path) / 2**20:.1f} MiB")

    engine = api.QueryEngine(api.LocalBackend(idx))

    print(f"\n=== query answering stage (slot-based serving, wave={args.wave}) ===")
    serve = api.KnnServeEngine(engine, api.KnnServeConfig(batch_slots=args.queries,
                                                          wave=args.wave))
    for seed, diff in enumerate(DIFFICULTY_LEVELS):
        q = make_query_workload(data, args.queries, diff, seed=seed + 1).cpu().numpy()
        for qi in q:                           # warm-up wave
            serve.submit(qi)
        serve.drain()
        rids = [serve.submit(qi) for qi in q]
        t0 = time.perf_counter()
        answers = serve.drain()
        dt = (time.perf_counter() - t0) / args.queries
        paths = np.bincount([max(answers[r].path, 0) for r in rids], minlength=4)
        tele = serve.telemetry()
        print(f"[{diff:>4}] {dt * 1e3:7.1f} ms/query  "
              f"paths scan/pruned = {paths[0] + paths[1]}/{paths[2]}  "
              f"plan cache {tele.plan_cache.hits}h/{tele.plan_cache.misses}m")
    print(f"mean pruning: eapca={tele.pruning.eapca_mean:.3f} "
          f"sax={tele.pruning.sax_mean:.3f}; waves served {tele.serving['waves']}")

    print("\n=== exactness + speedup vs dense scan: same surface ===")
    q = make_query_workload(data, args.queries, "ood", seed=99)
    scan = api.QueryEngine(api.ScanBackend(data, api.SearchConfig(k=1), mxu=True))

    def timed(eng):
        eng.knn(q)                             # warm
        t0 = time.perf_counter()
        d = eng.knn(q).dists
        synchronize(dev)
        return d, time.perf_counter() - t0

    (d_idx, t_idx), (d_scan, t_scan) = timed(engine), timed(scan)
    assert torch.allclose(d_idx, d_scan, rtol=1e-3, atol=1e-3)
    print(f"exact: hercules {t_idx:.2f}s vs pscan {t_scan:.2f}s "
          f"({t_scan / max(t_idx, 1e-9):.1f}x)")


if __name__ == "__main__":
    main()
