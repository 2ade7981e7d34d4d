"""Hercules search from the command line on PyTorch -- build, answer, verify.

    PYTHONPATH=src python -m repro_torch.launch.search --num-series 100000 \
        --length 256 --queries 100 --k 1 --difficulty 5% --verify

Builds the index on the CUDA device (``--device cpu`` for the host), answers
a query workload, reports per-query latency, pruning ratios and the
access-path distribution, and with ``--verify`` checks the answers against
the exact dense scan. ``--save PATH`` writes the built index to one
``.npz`` (``HerculesIndex.save``, the reference's file format).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.engine import dense_scan_knn
from repro_torch.core.index import HerculesIndex, IndexConfig
from repro_torch.core.search import SearchConfig
from repro_torch.core.tree import BuildConfig
from repro_torch.data.synthetic import (DIFFICULTY_LEVELS, make_query_workload,
                                        random_walks)
from repro_torch.device import resolve_device, synchronize


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-series", type=int, default=100_000)
    ap.add_argument("--length", type=int, default=256)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--difficulty", choices=DIFFICULTY_LEVELS, default="5%")
    ap.add_argument("--leaf-size", type=int, default=1024)
    ap.add_argument("--l-max", type=int, default=80)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--save", default="")
    ap.add_argument("--verify", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print(f"generating {args.num_series} series of length {args.length} "
          f"on {dev} ...")
    data = random_walks(args.num_series, args.length, seed=args.seed, device=dev)

    cfg = IndexConfig(build=BuildConfig(leaf_capacity=args.leaf_size),
                      search=SearchConfig(k=args.k, l_max=args.l_max))
    t0 = time.perf_counter()
    idx = HerculesIndex.build(data, cfg, device=dev)
    synchronize(dev)
    t_build = time.perf_counter() - t0
    st = idx.stats()
    print(f"index built in {t_build:.2f}s: {st['num_leaves']} leaves, "
          f"depth {st['max_depth']}, max leaf {st['max_leaf']}")
    if args.save:
        idx.save(args.save)
        print(f"saved to {args.save}")

    queries = make_query_workload(data, args.queries, args.difficulty,
                                  seed=args.seed + 1)
    t0 = time.perf_counter()
    res = idx.knn(queries, k=args.k)
    synchronize(dev)
    t_query = time.perf_counter() - t0

    paths = np.bincount(res.path.cpu().numpy(), minlength=4)
    print(f"\n{args.queries} x {args.k}-NN [{args.difficulty}] in "
          f"{t_query:.2f}s ({1e3 * t_query / max(args.queries, 1):.2f} ms/query)")
    print(f"  access paths: scan(eapca)={paths[0]} scan(sax)={paths[1]} "
          f"pruned={paths[2]}")
    print(f"  mean pruning: eapca={float(res.eapca_pr.mean()):.3f} "
          f"sax={float(res.sax_pr.mean()):.3f}")
    print(f"  mean data accessed: "
          f"{float(res.accessed.float().mean()) / args.num_series:.3%}")

    if args.verify:
        t0 = time.perf_counter()
        d_scan, p_scan = dense_scan_knn(data, queries, k=args.k)
        synchronize(dev)
        t_scan = time.perf_counter() - t0
        ok = bool(torch.equal(res.ids.long(), p_scan.long()))
        print(f"  scan: {t_scan:.2f}s -> speedup "
              f"{t_scan / max(t_query, 1e-9):.2f}x; exact match: {ok}")
        if not ok:
            raise SystemExit("exactness violation")


if __name__ == "__main__":
    main()
