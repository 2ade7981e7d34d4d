"""kNN index serving from the command line on PyTorch, over the QueryEngine.

Builds a backend by name on the CUDA device (``--device cpu`` for the
host), wraps it in a :class:`QueryEngine` and a :class:`KnnServeEngine`,
serves a stream of submitted queries through the slot pool, and reports
throughput, plan-cache behaviour and access-path telemetry. ``--smoke``
runs a small workload and verifies every answer against brute force.

    PYTHONPATH=src python -m repro_torch.launch.serve_knn --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_knn --backend scan \\
        --num-series 100000 --requests 256 --slots 64
    PYTHONPATH=src python -m repro_torch.launch.serve_knn --smoke --wave \\
        --mixed-k --max-queue 16 --pack difficulty
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.engine import QueryEngine, backend_names, make_backend
from repro_torch.core.index import IndexConfig
from repro_torch.core.search import SearchConfig, brute_force_knn
from repro_torch.core.tree import BuildConfig
from repro_torch.data.synthetic import (DIFFICULTY_LEVELS, make_query_workload,
                                        random_walks)
from repro_torch.device import resolve_device
from repro_torch.serve.engine import KnnServeConfig, KnnServeEngine, QueueFull


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=backend_names("memory"), default="local")
    ap.add_argument("--num-series", type=int, default=100_000)
    ap.add_argument("--length", type=int, default=128)
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--difficulty", choices=DIFFICULTY_LEVELS, default="5%")
    ap.add_argument("--leaf-size", type=int, default=256)
    ap.add_argument("--l-max", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--wave", action="store_true",
                    help="serve each wave through the fused wave plan")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission bound; submits past it are rejected and "
                         "retried after serving a wave")
    ap.add_argument("--pack", choices=("fifo", "difficulty"), default="fifo",
                    help="wave packing policy")
    ap.add_argument("--mixed-k", action="store_true",
                    help="alternate k and 2k requests to exercise sub-wave grouping")
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes + brute-force verification")
    args = ap.parse_args(argv)

    if args.smoke:
        args.num_series = min(args.num_series, 4096)
        args.length = min(args.length, 64)
        args.requests = min(args.requests, 24)
        args.slots = min(args.slots, 8)

    dev = resolve_device(args.device)
    print(f"generating {args.num_series} series of length {args.length} on {dev} ...")
    data = random_walks(args.num_series, args.length, seed=0, device=dev)

    cfg = IndexConfig(
        build=BuildConfig(leaf_capacity=args.leaf_size),
        search=SearchConfig(k=args.k, l_max=args.l_max,
                            chunk=min(1024, args.num_series),
                            scan_block=min(4096, args.num_series)))
    t0 = time.perf_counter()
    backend = make_backend(args.backend, data, index_config=cfg, device=dev)
    print(f"backend '{args.backend}' ready in {time.perf_counter() - t0:.1f}s: "
          f"{backend.describe()}")

    serve = KnnServeEngine(QueryEngine(backend),
                           KnnServeConfig(batch_slots=args.slots, k=args.k,
                                          wave=args.wave, max_queue=args.max_queue,
                                          pack=args.pack))

    workload = make_query_workload(data, args.requests, args.difficulty, seed=1)
    queries = workload.cpu().numpy()
    ks = [args.k if (i % 2 == 0 or not args.mixed_k) else 2 * args.k
          for i in range(len(queries))]

    t0 = time.perf_counter()
    rids = []
    for q, k in zip(queries, ks):
        while True:
            try:
                rids.append(serve.submit(q, k=k))
                break
            except QueueFull:   # backpressure: free slots, then retry
                serve.step()
    answers = serve.drain()
    dt = time.perf_counter() - t0
    assert set(answers) == set(rids) and serve.pending() == 0
    if not answers:
        print("no requests submitted: nothing to serve")
        return

    tele = serve.telemetry()
    pc, sv = tele.plan_cache, tele.serving
    print(f"\nserved {len(answers)} queries in {dt:.2f}s "
          f"({len(answers) / dt:.1f} q/s, {1e3 * dt / len(answers):.2f} ms/query)")
    print(f"plan cache: {pc.hits} hits / {pc.misses} misses")
    print(f"paths: {vars(tele.paths)}  pruning: eapca={tele.pruning.eapca_mean:.3f} "
          f"sax={tele.pruning.sax_mean:.3f}")
    print(f"serving: waves={sv['waves']} wave_mode={sv['wave_mode']} "
          f"pack={sv['pack']} rejected={sv['rejected']} failed={sv['failed']} "
          f"scored={sv['difficulty_scored']} wave_calls={tele.wave_calls}")

    if args.smoke:
        if sv["failed"]:
            raise SystemExit(f"smoke: {sv['failed']} requests failed")
        for k in sorted(set(ks)):
            rows = [i for i, kk in enumerate(ks) if kk == k]
            bf_d, _ = brute_force_knn(data, workload[rows], k)
            got = np.stack([answers[rids[i]].dists for i in rows])
            if not np.allclose(got, bf_d.cpu().numpy(), rtol=1e-3, atol=1e-3):
                raise SystemExit(f"smoke exactness violation at k={k}")
        print(f"smoke exactness vs brute force: OK (k groups: {sorted(set(ks))})")


if __name__ == "__main__":
    torch.set_grad_enabled(False)
    main()
