#!/usr/bin/env python3
"""The control of ``correct``: the plain reference put in the program's
place and computed in TF32, the precision just below the configurations'
(float32 with TF32 off), judged by the same comparison as the program.
Its numbers are the upper readings that ``compare.LIMITS`` lie under.

    python3 hbench/control.py --workload <cell> --seeds 1,2,3 --queries 2000

makes each seed's collection and query pool as a run of the cell does,
answers the first ``--queries`` pool entries (the ones a run's window
answers first) with the control, and prints each seed's ``gap`` (and its
``dist_gap`` and ``id_gap``). ``--emulate`` rounds the operands to TF32 by
hand instead of turning the card's TF32 on (the CPU has none). Not part of
a benchmark run: it needs no program, only the inputs and the reference.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from hbench import compare, gen, reference, spec  # noqa: E402


def control_numbers(cell_name: str, seed: int, queries: int, *, device: str = "cuda",
                    emulate: bool = False, root: Path = ROOT,
                    overrides: dict | None = None) -> dict:
    """The control's ``gap`` (with ``dist_gap`` and ``id_gap``) on one
    seed's inputs of a cell."""
    overrides = overrides or {}
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, cell_name)
    cfg = spec.merged(spec.config(bench, cell["config"], root), overrides.get("config", {}))
    traffic = spec.merged(spec.traffic(cell["traffic"], root), overrides.get("traffic", {}))
    dev = torch.device(device)
    data = gen.random_walks(cfg["num_series"], cfg["series_len"],
                            gen.generator(seed, "collection", dev), dev)
    levels, ks = gen.mix(traffic, traffic["pool"], seed, "pool")
    pool = gen.queries(data, levels, seed, "pool")
    count = min(queries, len(ks))
    q, ks = pool[:count], torch.as_tensor(ks[:count], device=dev)
    kmax = int(ks.max())
    ref_d, _, _ = reference.knn(data, q, kmax)
    ctl_d, ctl_i = reference.control_knn(data, q, kmax, emulate_tf32=emulate)
    out = {"dist_gap": 0.0, "id_gap": 0.0}
    for k in sorted(set(ks.tolist())):
        rows = (ks == k).nonzero().flatten()
        dg, ig = compare.gaps(data, q[rows], ctl_d[rows, :k], ctl_i[rows, :k],
                              ref_d[rows, :k])
        out["dist_gap"] = max(out["dist_gap"], dg)
        out["id_gap"] = max(out["id_gap"], ig)
    out["gap"] = max(out["dist_gap"], out["id_gap"])
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--queries", type=int, required=True)
    ap.add_argument("--emulate", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = control_numbers(args.workload, seed, args.queries, device=args.device,
                               emulate=args.emulate)
        verdict = "passes" if compare.passes({"gap": nums["gap"], "unanswered": 0}) \
            else "fails"
        print(f"control {args.workload} seed {seed}: gap {nums['gap']!r} (dist_gap "
              f"{nums['dist_gap']!r}, id_gap {nums['id_gap']!r}): {verdict} the limits "
              f"{compare.LIMITS}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
