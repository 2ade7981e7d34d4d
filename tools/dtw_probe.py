#!/usr/bin/env python3
"""Where a ``dtw_knn`` call's time goes, and what the DTW kernels compiled
to, on one CUDA card.

    python3 tools/dtw_probe.py [--num-series N] [--out FILE]

1. Build: each ``csrc/dtw.cu`` kernel's registers, shared memory and spills
   (``nvcc -Xptxas -v``, from the package's build log) and a count of the
   SASS instructions that set its per-cell cost (``cuobjdump -sass``):
   FADD, FMUL, FMNMX, FSEL, the register moves, branches and indirect
   branches.
2. Rounds: ``dtw_knn`` over N (default 2**20) z-normalised random walks of
   256 at band 13, 16 queries, k=1: the untraced wall time a round, then
   the same call under ``torch.profiler`` (CPU and CUDA): kernel launches,
   the host operators that take the most self time, the device's busy time
   and idle share.

Prints the results and one JSON line (``--out`` also writes it). Exits 2
without a card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402  (the repo root, put on the path above)

SASS_OPS = ("FADD", "FMUL", "FMNMX", "FSEL", "SEL", "MOV", "BRA", "BRX", "SHFL", "LDS",
            "LDG", "BAR")


def demangle(name: str) -> str:
    out = subprocess.run(["c++filt", name], capture_output=True, text=True)
    return out.stdout.strip() or name


def build_report() -> dict:
    """ptxas lines and SASS op counts of every kernel in libdtw.so."""
    from repro_torch.kernels import _build
    info = _build.build_all()
    out = Path(info["dir"])
    ptxas, fn = {}, None
    for line in (out / "dtw.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = demangle(m.group(1))
        elif fn and ("registers" in line or "spill" in line):
            ptxas.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(out / "libdtw.so")],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = demangle(m.group(1))
            counts[fn] = {"total": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)[.\s]", line)
        if fn and m:
            op = m.group(1)
            counts[fn]["total"] += 1
            key = "MOV" if op == "IMAD" and ".MOV" in line else op
            if key in SASS_OPS:
                counts[fn][key] = counts[fn].get(key, 0) + 1
    for name in sorted(counts):
        print(f"[build] {name}: {'; '.join(ptxas.get(name, []))} | SASS {counts[name]}",
              flush=True)
    return {"ptxas": ptxas, "sass": counts}


def rounds_report(num: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.dtw import dtw_knn
    from repro_torch.core.engine import make_backend
    from repro_torch.data.synthetic import random_walks

    data = random_walks(num, 256, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    q = data[:16] + torch.randn((16, 256), generator=g, device="cuda") * 0.05 ** 0.5
    layout = make_backend("local", data).index.layout
    dtw_knn(layout, q, 1, 13)
    torch.cuda.synchronize()
    stats: dict = {}
    t0 = time.perf_counter()
    dtw_knn(layout, q, 1, 13, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dtw_knn(layout, q, 1, 13)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    out = {"num_series": num, "rounds": stats["rounds"], "wall_ms": 1e3 * wall,
           "ms_per_round": 1e3 * wall / stats["rounds"], "traced_ms": 1e3 * traced,
           "device_ms": device_ms, "idle_share": 1 - device_ms / (1e3 * traced),
           "host_ops": [{"name": e.key, "calls": e.count,
                         "self_cpu_ms": e.self_cpu_time_total / 1e3} for e in host]}
    print(f"[rounds] dtw_knn k=1, band 13, 16 queries over {num} rows: {out['rounds']} "
          f"rounds, {out['wall_ms']:.1f} ms untraced ({out['ms_per_round']:.3f} ms a round); "
          f"traced {out['traced_ms']:.1f} ms, device busy {device_ms:.1f} ms (idle share "
          f"{out['idle_share']:.3f})", flush=True)
    for e in out["host_ops"]:
        print(f"[rounds] {e['name']}: {e['calls']} calls, {e['self_cpu_ms']:.1f} ms self CPU",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-series", type=int, default=1 << 20)
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    line = json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                       "build": build_report(), "rounds": rounds_report(args.num_series)})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
