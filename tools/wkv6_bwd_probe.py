#!/usr/bin/env python3
"""Where the time of the RWKV-6 gradient kernel ``wkv6_bwd`` goes, on one
CUDA card.

    python3 tools/wkv6_bwd_probe.py [--out FILE]

At the training shape of ``rwkv6-7b`` (B=4, T=512, H=64, K=V=64, bf16 r,
k, v):

1. ``ptxas`` registers and spills of each ``wkv6_bwd_kernel`` instance, and
   SASS instruction counts by opcode (``cuobjdump -sass``).
2. A block's cycles by phase: the checkout's ``csrc/wkv6_bwd.cu`` built
   with ``clock64()`` reads between its phases (a copy made by
   ``kernel_ab.patched``, which ends the run if an anchor is missing),
   launched through the package's wrapper. Thread 0 and thread 511 of
   every block write their totals over the start of the block's dstate;
   the means over the blocks are printed: the forward sweep, the copies and checkpoint
   load before a chunk, the chunk's steps, the wait and barrier, the fold
   and write of its gradients, the widening of the next chunk, and the
   closing barrier.
3. Ablations, each a copy of the source, timed in turns with the checkout
   by a CUDA graph (``chip_smoke.device_ms``): the sweep alone; the steps'
   shared-memory loads hoisted out of the step loops; the steps' shuffles
   removed. Their outputs are wrong; only their times are read.

Prints one line per item and a JSON line; ``--out`` also writes the JSON.
Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]

import chip_smoke as cs  # noqa: E402  (the repo root, put on the path above)
import kernel_ab as ab  # noqa: E402

SHAPE = (4, 512, 64, 64, 64)
PHASES = ("sweep", "copies and checkpoint", "steps", "wait and barrier", "fold and write",
          "widen", "closing barrier")


def substitute(src: str, pairs) -> str:
    return ab.patched(src, pairs, "csrc/wkv6_bwd.cu")


def clocked(src: str) -> str:
    """The source with per-phase cycle counters (P[0..6]), written over
    the block's first 16 dstate words at the end by threads 0 and 511."""
    tick = "pb = clock64(); P[{}] += pb - pa; pa = pb;"
    return substitute(src, [
        ("  float du_acc = 0.0f;\n",
         "  float du_acc = 0.0f;\n  long long P[7] = {}, pa = clock64(), pb;\n"),
        ("  // Backwards, chunk by chunk:", "  " + tick.format(0) + "\n  // Backwards, chunk by chunk:"),
        ("    const Wide wd = sm.wide(c);\n", "    " + tick.format(1) + "\n    const Wide wd = sm.wide(c);\n"),
        ("    cp_async_wait_all();\n    __syncthreads();                     // c's partial",
         "    " + tick.format(2) + "\n    cp_async_wait_all();\n    __syncthreads();                     // c's partial"),
        ("    write_chunk(sm, wd, rows, dr, dk, dv, dw, t0, n, du_acc);\n",
         "    " + tick.format(3) + "\n    write_chunk(sm, wd, rows, dr, dk, dv, dw, t0, n, du_acc);\n    "
         + tick.format(4) + "\n"),
        ("    resets = __syncthreads_or(zero);     // c written, c - 1 widened\n",
         "    " + tick.format(5) + "\n    resets = __syncthreads_or(zero);     // c written, c - 1 widened\n    "
         + tick.format(6) + "\n"),
        ("  if (tid < K) du_part[(size_t)bh * K + tid] = du_acc;",
         "  if (tid < K) du_part[(size_t)bh * K + tid] = du_acc;\n  __syncthreads();\n"
         "  if (tid == 0 || tid == THREADS - 1)\n    for (int q = 0; q < 7; ++q)\n"
         "      ds0[sbase + q + (tid ? 8 : 0)] = (float)P[q];"),
    ])


def hoisted(src: str) -> str:
    """The steps read their chunk's first step's inputs, loaded once."""
    once = ("  const float4 E0 = wd.pk[tl.i0], E1 = wd.pk[tl.i0 + 1];\n  float V4[4], D4[4];\n"
            "  load4(wd.pv + tl.j0, V4);\n  load4(wd.pdo + tl.j0, D4);\n")
    copy = "      for (int i_ = 0; i_ < 4; ++i_) { vv[i_] = V4[i_]; dd[i_] = D4[i_]; }"
    return substitute(src, [
        ("  const bool b8 = tl.cg & 8;\n#pragma unroll\n",
         "  const bool b8 = tl.cg & 8;\n" + once + "#pragma unroll\n"),
        ("      const float4 e0 = wd.pk[tt * KMAX + tl.i0], e1 = wd.pk[tt * KMAX + tl.i0 + 1];\n"
         "      float vv[4], dd[4], p[2];\n      load4(wd.pv + tt * KMAX + tl.j0, vv);\n"
         "      load4(wd.pdo + tt * KMAX + tl.j0, dd);",
         "      const float4 e0 = E0, e1 = E1;\n      float vv[4], dd[4], p[2];\n" + copy),
        ("  const bool b8 = tl.cg & 8, b4 = tl.cg & 4, hi = tl.rsub;\n#pragma unroll\n",
         "  const bool b8 = tl.cg & 8, b4 = tl.cg & 4, hi = tl.rsub;\n" + once + "#pragma unroll\n"),
        ("      const float4 e[2] = {wd.pk[tt * KMAX + tl.i0], wd.pk[tt * KMAX + tl.i0 + 1]};\n"
         "      float vv[4], dd[4], pk[2], pw[2], pv[4];\n      load4(wd.pv + tt * KMAX + tl.j0, vv);\n"
         "      load4(wd.pdo + tt * KMAX + tl.j0, dd);",
         "      const float4 e[2] = {E0, E1};\n      float vv[4], dd[4], pk[2], pw[2], pv[4];\n" + copy),
    ])


def unshuffled(src: str) -> str:
    """The steps' shuffles (in recompute and walk_back) return their input."""
    head, rest = src.split("// The chunk's states st[0 .. n-1] from st[0]", 1)
    steps, tail = rest.split("// Fold and write a chunk's gradients", 1)
    head = substitute(head, [("__device__ __forceinline__ float widen(float x)",
                              "__device__ __forceinline__ float same(unsigned, float x, int) "
                              "{ return x; }\n__device__ __forceinline__ float widen(float x)")])
    return (head + "// The chunk's states st[0 .. n-1] from st[0]"
            + steps.replace("__shfl_xor_sync(", "same(") + "// Fold and write a chunk's gradients"
            + tail)


def sweep_only(src: str) -> str:
    return substitute(src, [("  // Backwards, chunk by chunk:",
                             "  if (T > 0) return;\n  // Backwards, chunk by chunk:")])


def sass_counts(lib: Path) -> dict:
    from repro_torch.kernels import _build
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    func, counts = None, {}
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            func = m.group(1)
            counts[func] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and func:
            counts[func][m.group(2).split(".")[0]] += 1
    return {f: dict(c.most_common()) for f, c in counts.items() if "wkv6_bwd_kernel" in f}


def phase_cycles(build, args) -> dict:
    """Mean cycles by phase over the blocks, for threads 0 and 511."""
    import torch
    b, _, h, dk, dv = SHAPE
    with build.context():
        for _ in range(3):
            ds0 = build.grads(*args)[5]
    torch.cuda.synchronize()
    per_block = ds0.reshape(b * h, dk * dv)[:, :16].double()
    out = {}
    for lo, who in ((0, "thread 0"), (8, "thread 511")):
        mean = per_block[:, lo:lo + len(PHASES)].mean(0)
        total = float(mean.sum())
        out[who] = {"total": total, **{p: float(x) for p, x in zip(PHASES, mean)}}
        print(f"[cycles] {who}: a block {total:.0f} cycles; " + ", ".join(
            f"{p} {float(x):.0f} ({float(x) / total:.1%})" for p, x in zip(PHASES, mean)),
            flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    smi = cs.smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    info = _build.build_all()
    log = (Path(info["dir"]) / "wkv6_bwd.log").read_text()
    ptxas = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
    print("[ptxas] " + " | ".join(ptxas), flush=True)
    sass = sass_counts(Path(info["dir"]) / "libwkv6_bwd.so")
    for f, c in sass.items():
        print(f"[sass] {f[-48:]}: {sum(c.values())} instructions, "
              + ", ".join(f"{k} {v}" for k, v in list(c.items())[:12]), flush=True)
    src = (_build.CSRC / "wkv6_bwd.cu").read_text()
    g = torch.Generator(device="cuda").manual_seed(31)
    a = ab.bwd_grads_in(g, SHAPE, torch.bfloat16)
    with tempfile.TemporaryDirectory(prefix="wkv6-bwd-probe-") as tmp:
        def build(name, text):
            return ab.bwd_text_build(text, Path(tmp), name)

        cycles = phase_cycles(build("clocked", clocked(src)), a)
        builds = {"v2": ab.own_bwd(),
                  "sweep only": build("sweep", sweep_only(src)),
                  "loads hoisted": build("hoisted", hoisted(src)),
                  "no shuffles": build("unshuffled", unshuffled(src))}
        runs: dict = {label: [] for label in builds}
        for label in [*builds, *reversed(builds)]:
            with builds[label].context():
                runs[label].append(cs.device_ms(lambda b=builds[label]: b.grads(*a), 10))
    ms = {label: sum(v) / len(v) for label, v in runs.items()}
    print("[ablate] device ms, in turns: " + "; ".join(f"{k} {v:.4f}" for k, v in ms.items()),
          flush=True)
    line = json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                       "shape": list(SHAPE), "ptxas": ptxas, "sass": sass, "cycles": cycles,
                       "ablations_ms": ms, "runs": runs})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
