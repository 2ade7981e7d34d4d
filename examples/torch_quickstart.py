"""Quickstart on PyTorch: build a Hercules index and answer exact kNN
queries through the port's ``repro_torch.api`` surface (QueryEngine over a
backend), on the CUDA card by default.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch import api
from repro_torch.data.synthetic import make_query_workload, random_walks

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

# 1. a collection of 20k z-normalized random-walk series (the paper's Synth)
data = random_walks(20_000, 128, seed=0, device=args.device)

# 2. build the index backend: EAPCA tree + leaf-ordered LRD layout + iSAX
#    sidecar, wrapped in a QueryEngine (plan cache + telemetry)
backend = api.LocalBackend(api.HerculesIndex.build(data, api.IndexConfig(
    build=api.BuildConfig(leaf_capacity=256),
    search=api.SearchConfig(k=5, l_max=16)), device=data.device))
engine = api.QueryEngine(backend)
print("tree:", engine.stats())

# 3. a workload of medium-hard queries (dataset series + 5% gaussian noise)
queries = make_query_workload(data, 10, "5%", seed=1)

# 4. exact 5-NN; per-call overrides (k, l_max, thresholds...) are free
res = engine.knn(queries)
print("\nper-query pruning (1.0 = everything pruned):")
print("  EAPCA:", [round(v, 3) for v in res.eapca_pr.tolist()])
print("  SAX:  ", [round(v, 3) for v in res.sax_pr.tolist()])
print("data accessed:", f"{float(res.accessed.float().mean()) / 20_000:.2%}")

# 5. the paper's ground rule: answers are exact, and every path agrees. The
#    wave plan (shared descent, one LB_SAX launch for the batch) and the
#    dense-scan backend answer the same workload bit for bit.
wave = engine.knn(queries, wave=True)
assert torch.equal(wave.dists, res.dists)
scan = api.QueryEngine(api.ScanBackend(data, api.SearchConfig(k=5)))
assert torch.equal(scan.knn(queries).dists, res.dists)
bf_d, _ = api.brute_force_knn(data, queries, 5)
assert torch.allclose(res.dists, bf_d, rtol=1e-3, atol=1e-3)
print("\nexact answers verified against the wave plan, the dense scan and brute "
      "force: OK")

# 6. repeated calls hit the plan cache
engine.knn(queries)
print("plan cache:", engine.telemetry().plan_cache)
print("nearest ids for query 0:", res.ids[0].tolist())
