#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Hercules on one CUDA card.

    python3 chip_smoke.py                      # the full run (2**22 x 256)
    python3 chip_smoke.py --num-series 65536   # a short check
    python3 chip_smoke.py --disk-dir /big/tmp  # put the disk index there
    python3 chip_smoke.py --mesh-only          # build, then phases 30-33 alone

Phases (any failure ends the run with a non-zero exit):

1. device: a CUDA card must be present; print its name and power limit;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels vs plain versions at adversarial shapes (ragged N and n,
   ``valid_n`` masking, ties, an all-inf row, bf16 series, a bf16 payload at
   the codec's pitch, views one row in, ``ed_min``'s resident-query state at
   the edges of its fit), ``ed_min`` and ``ed_matrix`` equal to the exact
   fma references bit for bit, and the ED witness: the row minima and first
   argmins of ``ed_matrix`` and ``decode_bf16_ed_matrix`` equal ``ed_min``'s;
4. the main path at a real size: the paper's Synth random walks (length
   256; the card's draw held bit for bit to the CPU's), a Hercules index
   with 4096-series leaves, 100 queries at the "5%" hardness answered for
   k=1 and k=10 through ``QueryEngine`` over the ``local`` and ``scan``
   backends (``kernel_mode="auto"``), held against a
   brute-force difference-form scan on the card; every kernel's launch
   counter must have risen during this phase;
5. the disk path at the same data scale: a store (``Hercules.create``, a
   chunked build straight to a format-v3 index directory with the bf16
   codec; its tree held against phase 4's), served memory-mapped by the
   store's ``ooc-scan`` and ``ooc-local`` engines at a 256 MiB budget, raw
   and bf16 streams, k=1 and k=10, with the threaded reader (and once with
   the synchronous one); every answer is held against phase 4's in-memory
   answers bit for bit, and every kernel of the path must have launched;
5b. the runtime sanitizer on that store: a fresh read-only handle opened
   under ``REPRO_SANITIZE=1`` (memory maps in use-after-close guards; the
   threaded reader poisoning each recycled pinned slot and checking every
   staged block, after its copy event, against a host snapshot) answers
   phase 5's ``ooc-local`` raw k=1 call equal in every field, raising no
   ``SanitizerError``; after ``close()`` a read of its ``lrd`` must raise
   ``UseAfterCloseError``;
6. the wave plans and kNN serving on phase 4's ``local`` backend and phase
   5's store engines: ``knn(..., wave=True)`` at k=1 and k=10 over the 100
   queries (bucket 128) on ``local`` (``wave_knn``: exactly one
   ``lb_sax_matrix`` launch a call, over the whole LSD sidecar; its time
   and peak memory beside phase 4's), ``ooc-scan`` (raw and bf16;
   ``wave_rows_shared`` = rows streamed x 127) and ``ooc-local`` (raw and
   bf16, the threaded reader, raw k=10 also the synchronous one; its
   streaming, reader and sharing counters beside the same engine's batch
   call), every answer held bit for bit to phase 4's (ids as sets per
   row); then 256 requests of phase 4's queries, two at k=1 for one at
   k=10, one of them of the wrong length, through ``KnnServeEngine`` (32
   slots, wave plans, difficulty packing, a queue bound of 64 that raises
   ``QueueFull``, each retried after a wave) over ``local`` and over the
   bf16 ``ooc-local`` engine, each wave call timed with its size (full or
   padded), at least one full k=10 wave of 32 over ``ooc-local``; every
   answer equal to the query's per-query answer, exactly one ``KnnFailure``
   (the wrong length), its wave-mates answered; every kNN kernel must
   launch in this phase;
7. sharding at the same scale, on phase 4's data and phase 5's store
   (before the journal): ``sharded``, 4 shards of N/4 on the one card
   (``devices=["cuda:0"] * 4``), answering the 100 queries at k=1 and
   k=10 through ``QueryEngine``, ids equal to phase 4's ``local`` answers
   and dists bit-identical (each distance is the same difference-form sum
   whichever shard holds its row), its build seconds, ms a query and peak
   memory logged, ``lb_sax_matrix`` launched at least 4 x 100 times; then
   the store's ``dist-ooc`` engines at 256 MiB a shard with the threaded
   reader, each shard on its own thread and CUDA stream: 4 shards raw k=1,
   raw k=10, bf16 k=10 and bf16 k=10 with ``wave=True``, and 1 shard bf16
   k=10, dists bit-identical to phase 4's answers, positions and ids equal
   (ids and positions as sets per row for the wave call), every shard's
   ``rows_touched`` inside its ``row_range``, per-shard rows and bytes
   streamed, ``imbalance`` and ``read_wait_seconds`` logged beside phase
   5's ``ooc-local`` time for the same stream and k;
   ``decode_bf16_ed_matrix`` and ``lb_sax_matrix`` must launch in this
   phase;
7b. exact DTW kNN on phase 4's in-memory index (before the journal):
   ``dtw_knn`` over phase 4's first 16 queries at band 13 (a 5% warping
   window of n = 256, the UCR-Suite convention), k=1 and k=10, its rounds,
   chunks and rows refined and its ``dtw_band`` launches logged, held
   against a brute-force ``dtw_band`` over every row with a stable top-k
   (dists bit-identical, positions equal); every ``dtw_band`` kernel the
   run reaches bit for bit equal to its plain version ``dtw_band_ref`` on
   the card (``kernels/dtw.py::_plan``'s choice at 1 query x 4,096 rows,
   at a refinement round, 16 x 256, and at a late round, 4 x 256; v2 with
   one thread a pair, the brute force's; v1 at band 40); host-loop and
   CUDA-graph times at those shapes, v1's at the round and the brute
   force's (1 x every row), each row naming its kernel (``variant``,
   ``lanes``); each ``dtw_knn`` call's launches x the round's device time
   against its wall time, the rest being the host's share;
8. the store's mutation path on that store: two journal segments of 1/32
   of the base each (2 x 131,072 rows at the full size) appended in chunks
   of 65,536 and 8,192 rows, each append invalidating the store's cached
   engine; 100 queries (phase 4's first 72, 28 made from the journal rows)
   answered with the rows pending by ``local``, ``scan``, ``ooc-scan``,
   ``ooc-local`` and ``dist-ooc`` (4 shards) at k=1 and k=10, each held
   bit for bit to a brute-force difference-form scan over base and
   journal on the card (journal hits at
   position -1; at k=1 at least 14 of the 28 journal-made queries find
   their neighbour in the journal); ``compact()`` to generation 1, held bit
   for bit to a one-shot in-memory build over base and journal (tree,
   layout, LRD, LSD), the old generation and the journal swept, the old
   generation's handle raising ``IndexFormatError``, and every backend's
   answers after compaction equal to the merged ones before it; the four
   kNN kernels must launch in this phase. The index directory (two
   generations side by side at the compaction's peak, with its id-order
   copy of the base, about 18 GB at the full size) is removed after this phase, also on failure;
9. kernels vs plain versions at the main path's shapes, with CUDA-event
   times for kernel, plain version and library call (each launched from a
   host loop, as the engine launches them), and the bound;
   ``ed_matrix`` and ``decode_bf16_ed_matrix`` (on a strided view of a real
   encoded block, with its error against a float64 evaluation) at 4096 and
   131,072 rows, ``lb_sax_matrix`` at Q=1, Q=128 (a wave call's shape) and
   Q=32 (a serving wave's) over the whole LSD sidecar and at Q=128 over one
   131,072-row LSD block,
   and ``ed_min`` over the whole collection (the k=1 scan) and over one
   131,072-row block (the out-of-core k=1 fold), also timed on the device alone by a CUDA graph
   (``device_ms``), with their launches per run at each shape; ``ed_min``
   and ``ed_matrix`` held bit for bit to the exact fma references at both
   of ``ed_min``'s shapes and at 131,072 rows, and the ED witness;
10. the card's answers against the CPU's on a small input (the CPU path is
   the one the test suite holds against the JAX reference), ``dtw_knn``'s
   (k=3, band 13) bit for bit;
11. ``wkv6`` against its plain version and, bit for bit, against the exact
   fma reference ``wkv6_fma_ref``: the LM path's prefill shape (B=4,
   T=512, H=64, K=V=64) with a nonzero state, the decode shape (T=1), bf16
   r/k/v as served and float32, the extreme decays and the
   overflow-then-reset case; host-loop and CUDA-graph times at both shapes;
12. LM serving at full width: ``rwkv6-7b`` (8 of its 32 layers, d_model 4096,
   bf16 compute, float32 parameters) with random weights from a seed, 8
   requests of 512-token prompts through ``ServeEngine`` in two waves of 4,
   32 new tokens each; ``wkv6`` must launch 8 x (1 + 31) x 2 = 512
   times in that run; logits finite; the waves replayed step by step give
   the engine's tokens; served again in float32 with the same weights, each
   first token equals the request's solo run wherever its top-2 margin
   exceeds twice the float32 logit tolerance;
13. the card against the CPU at full width and 2 layers in float32: a
   64-token prefill and 4 decode steps, logits within 1e-4, equal tokens;
14. dense LM serving at full width: ``minicpm-2b`` (20 of its 40 layers
   for the run's time, d_model 2304, vocab 122,753, bf16 compute, float32
   parameters, ~1.8 B parameters) with random weights from a seed, 8 requests of 512-token
   prompts through ``ServeEngine`` in two waves of 4, 32 new tokens each;
   logits finite; the waves replayed step by step give the engine's
   tokens; prefill ms a wave, decode ms a step, tok/s and peak memory;
15. training at full width and depth (all 40 layers, ~3.0 B parameters):
   6 steps of ``make_train_step``
   (AdamW with minicpm's WSD schedule at 3e-4 from the first step, float32
   moments, remat) at B=4, S=512 on one repeated ``synth_batch``; loss and
   grad norm finite, the last loss below the first; step time, tokens/s,
   TFLOP/s by 6*N*D and peak memory; then one step with int8 moments;
16. the card against the CPU: ``minicpm-2b`` at full width and 2 layers in
   float32 (logits and the train step's loss within 1e-4, each gradient
   within 1e-4 of its tensor's largest magnitude, the grad norm within 1e-4
   relative, AdamW on the same gradients within 1e-6); a smoke-size
   checkpoint written on the card and reloaded, training on within 1e-6 of
   an uninterrupted run; ``examples/torch_retrieval_lm.py``'s path on the
   card, exact against brute force, ``lb_sax_matrix`` launched;
17. mixture-of-experts serving at full width, as phase 14 serves:
   ``granite-moe-1b-a400m`` (12 of its 24 layers for the run's time, 32
   experts top-8, float32 parameters) and ``moonshot-v1-16b-a3b`` (all 48
   layers, 64 experts top-6,
   28.06 B parameters held as a bf16 serving tree, 56.1 GB; peak under 80
   GB); capacities 168 and 64 at S=512, 8 at decode; no kernel of the port
   launches (experts, routing and combine are torch ops);
18. MoE training: ``granite-moe-1b-a400m``, 6 steps at B=4, S=512 (AdamW,
   float32 moments, remat, the auxiliary loss at 1e-2); loss, ``moe_aux``
   and grad norm finite, the last loss below the first; TFLOP/s by 6*N*D
   with N the 478,943,232 active parameters;
19. ``rg_lru_scan`` equal to its plain version bit for bit, on the card and
   against the CPU, through the variant ``kernels/rg_lru.py::_plan`` picks
   (v2 where R % 4 == 0, the operands are 16-byte aligned and T >= 64; v1
   otherwise), one launch a call, counted under that variant: at the
   Griffin path's prefill (4, 512, 2560, nonzero h0; v2) and decode (T=1;
   v1) shapes, a ragged shape (v1), v2's tile tail (4, 515, 2560), R = 36
   (R % 32 != 0; v2), T=0, and the prefill shape one float into its
   buffers (v1); host-loop and CUDA-graph times beside the plain version's
   and the bound;
20. ``recurrentgemma-2b`` served at full width and depth as phase 14 serves
   (26 layers, 18 recurrent, window 2048, 3,549,934,080 float32
   parameters); ``rg_lru_scan`` must launch 18 x 32 x 2 = 1,152 times,
   counted by variant and shape where they launch (36 prefills, 1,116
   decode steps);
21. the card against the CPU in float32: granite-moe at full width and 2
   layers and moonshot at its smoke config (logits and aux within 1e-4,
   the train step's metrics within 1e-4, each gradient within 1e-4 of its
   tensor's largest magnitude), recurrentgemma at full width and 3 layers
   (rec, rec, attn; a 64-token prefill and 4 decode steps within 1e-4,
   tokens equal);
22. ``wkv6_bwd`` (the gradient's kernel, v2) against its plain version
   ``wkv6_bwd_ref``: float32 at (2, 67, 3, 64, 64) with w == 0 in one
   chunk (every gradient within 1e-5 of its tensor's largest magnitude, dw
   0 at the reset rows), ragged K/V, T=1, T=0; bf16 at the training shape
   (4, 512, 64, 64, 64); bit for bit ``wkv6_bwd_fma_ref`` at the check
   shape and the ragged shapes; two launches bit-equal; times and the
   bound;
23. ``rg_lru_scan_bwd`` equal to ``rg_lru_scan_bwd_ref`` bit for bit as
   phase 19 holds the forward: at the training shape (4, 512, 2560; v2),
   T=1 (v1), phase 19's edges and the training shape one float in (v1);
   times and the bound;
24. ``rwkv6-7b`` trained at full width, cut to 12 of 32 layers (float32
   AdamW state for 32 layers takes 120.6 GB), as phase 15 trains minicpm:
   6 steps at B=4, S=512, remat, float32 moments (the loss must fall), one
   int8-moment step; exactly 24 ``wkv6`` and 12 ``wkv6_bwd`` launches a
   step, the int8 step's too (remat runs each layer's forward twice);
25. ``recurrentgemma-2b`` trained at full width and depth the same way: 36
   ``rg_lru_scan`` and 18 ``rg_lru_scan_bwd`` launches a step, the int8
   step's too, counted by variant and shape;
26. the card against the CPU in float32: rwkv6 at full width and 2 layers
   and recurrentgemma at full width and 3 layers (logits, the train step's
   metrics, each gradient within 1e-4 of its tensor's largest magnitude;
   rwkv6's largest gap printed beside v1's 7.736e-05);
   recurrentgemma's smoke config: AdamW on the same gradients within 1e-6
   (moments a list of layers) and a checkpoint (blocks as a list) resumed
   on the card within 1e-6;
27. ``whisper-large-v3`` served at its published width and depth (32
   encoder and 32 decoder layers, d 1280, 20 heads, vocab 51,866, 1,500
   frames, bf16 compute, 1,535,219,200 float32 parameters made on the card
   from seed 0; ``param_count()`` counts the tied head twice and no norm or
   MLP bias): 8 requests, each with 1,500 random frames and a 128-token
   prompt, through ``ServeEngine`` in two waves of 4, 32 new tokens each;
   no kernel of the port launches; the waves replayed step by step give
   the engine's tokens, every logit finite; tok/s, prefill ms a wave
   (encoder included), decode ms a step, peak memory;
28. whisper trained from phase 27's parameters: 6 steps at B=4, 1,500
   frames, S=448 (remat, AdamW at minicpm's WSD rate from the first step,
   float32 moments), batch t ``synth_batch(0, t)`` drawn on the host and
   staged on the card by ``DoubleBufferedLoader``, each staged batch equal
   to the direct draw; losses and grad norms finite, the cross-entropy of
   a held-out batch lower after the six steps than before; one int8-moment
   step; s a step, decoder tokens/s, TFLOP/s by the 6*N*D of
   ``_whisper_flops`` (encoder and cross K/V over the frames, the rest
   over the tokens), peak memory; a smoke checkpoint (``enc``/``dec``
   stacked) resumed on the card within 1e-6;
29. the card against the CPU at whisper's smoke config in float32:
   logits, the train step's metrics, each gradient within 1e-4 of its
   tensor's largest magnitude, and 8 greedy decode steps after a prefill
   with frames, logits within 1e-4 and tokens equal;
30. the specs on ``meta``: ``param_specs`` of all ten archs (bytes a tree,
   llama3-405b's within 10% of 2 x ``param_count()``) and the bytes a chip
   holds under ``shard_params_tree`` on the 16 x 16 and 2 x 16 x 16
   production meshes of ``meta`` devices; the card's allocation must not
   move;
31. GPipe over ``rwkv6-7b`` at full width, 8 of its 32 layers (random
   weights, seed 0) in 4 stages of 2 on a ``stage`` mesh of four
   ``cuda:0`` entries, 4 microbatches of (1, 512) embeddings: forward and
   backward of sum(out**2) against the same layers run one microbatch at
   a time (outputs within 1e-5, gradients within 1e-4 of each tensor's
   largest magnitude), 32 ``wkv6`` and 32 ``wkv6_bwd`` launches at (1,
   512, 64, 64, 64) and no other kernel in each of its three runs (the
   pipeline twice, the plain run); before them both kernels held to their
   plain versions at that shape;
32. the int8 error-feedback all-reduce (``compressed_psum``) over 4
   workers on four ``cuda:0`` entries, each with one microbatch's gradient
   of phase 31's stage 0 (2 layers), two steps: over every entry the
   codes, error buffers and means exactly the reference's arithmetic
   recomputed in float64, each mean within 0.51 x its scale of the exact
   mean; codes, scales, means and error buffers bit for bit the same run
   on the CPU over a sample of each tensor holding its largest entries;
   the int8 payload's bytes against float32;
33. ``reshard_checkpoint`` of phase 31's layers as host numpy (the
   reference's layout) under ``param_spec`` on a (data 2, model 2) mesh of
   ``cuda:0``, then on (data 1, model 4): every piece its ``shard_shape``,
   every gather bit for bit.

The line before the last two is ``{"kernels": [...]}`` (every row with
``device_ms``, a CUDA graph's time; two ``dtw_band`` rows from phase 7b,
the round (16 x 256) and 1 x 4,096, each with its ``variant`` and
``lanes``, its other shapes in the summary; ``rg_lru_scan`` at the prefill
and decode shapes and ``rg_lru_scan_bwd`` at the training shape, each with
the launches that phases 20 and 25 (its int8 step included) counted at its
shape and its ``variant``, the one those launches took (prefill 36 served
+ 216 in phase 25's six steps + 36 in its int8 step = 288, decode 1,116,
gradient 108 + 18 = 126; every launch of those runs falls on a row);
``wkv6_bwd`` at the training shape with phases 24's launches, its int8
step's included: 84; the launches of the card-vs-CPU checks, phases 21 and
26, at other shapes, are in no row); then the
card's ``nvidia-smi`` name
and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
# The DTW cell has no FMA, so its rows are bound at the non-FMA issue rate:
# NVIDIA's CUDA C++ Programming Guide ("Arithmetic Instructions", results a
# clock an SM, compute capability 9.0): 128 for 32-bit float add and multiply
# (FADD, FMUL), 64 for compare, minimum, maximum (FMNMX); four schedulers
# issue at most 4 x 32 = 128 a clock an SM. A cell's 3 FADD/FMUL and 2 FMNMX
# then take max(3 / 128, 2 / 64, 5 / 128) = 5 / 128 clocks an SM.
SM_COUNT, SM_CLOCK_HZ = 132, 1.98e9   # H100 SXM: SMs, boost clock
FP32_ADD_MUL_PER_S = SM_COUNT * 128 * SM_CLOCK_HZ   # 33.45e12 (half of FP32_FLOPS)
FP32_MINMAX_PER_S = SM_COUNT * 64 * SM_CLOCK_HZ     # 16.73e12
DTW_OPS_PER_S = 5 / max(3 / FP32_ADD_MUL_PER_S, 2 / FP32_MINMAX_PER_S,
                        5 / FP32_ADD_MUL_PER_S)     # 33.45e12 of a cell's 5 operations
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
    """Mean time of ``fn`` over ``reps`` runs launched from a host loop, as
    the engine launches them, by CUDA events: the ``ms``, ``plain_ms`` and
    ``library_ms`` of every row."""
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


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back launches: CUDA
    events around one replay of a CUDA graph of them, so no host time falls
    between the launches (at a 4096-row ``ed_matrix`` the host loop of
    :func:`time_ms` takes longer than the kernel): the ``device_ms`` of the
    ED rows."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bf16_payload(rows):
    """(N, n) float32 rows -> a (N, 2n) uint8 view at the bf16 codec's row
    pitch 2n + 4 (the bf16 bits, then a 4-byte trailer), as the disk path
    hands its encoded blocks to ``decode_bf16_ed_matrix``."""
    import torch
    num, n = rows.shape
    enc = torch.zeros((num, 2 * n + 4), dtype=torch.uint8, device=rows.device)
    enc[:, :2 * n] = rows.to(torch.bfloat16).view(torch.uint8)
    return enc[:, :-4]


def hold_witness(queries, rows=None, payload=None, what: str = "") -> None:
    """The ED witness, now a check of ``ed_min``'s fold: each row's minimum
    of ``ed_matrix`` (over float32 ``rows`` and their bf16 rounding) and of
    ``decode_bf16_ed_matrix`` (over ``payload``) equals ``ed_min``'s
    distance over the same series, as a value, and the lowest index that
    attains it equals ``ed_min``'s index. All three run one tile core of
    ed.cu, so this holds the reduction that only ``ed_min`` does (per
    thread, across lanes and warps, across tiles in its resident-query
    state, and the atomicMin words) against a plain row minimum; the core's
    arithmetic itself is held by :func:`hold_fma_bits`."""
    import torch
    from repro_torch.kernels import ed as ked
    pairs = []
    if rows is not None:
        pairs.append(("ed_matrix f32", ked.ed_matrix(queries, rows), rows))
        rb = rows.to(torch.bfloat16)
        pairs.append(("ed_matrix bf16", ked.ed_matrix(queries, rb), rb))
    if payload is not None:
        pairs.append(("decode_bf16_ed_matrix", ked.decode_bf16_ed_matrix(queries, payload)[0],
                      payload.contiguous().view(torch.bfloat16)))
    for name, mat, series in pairs:
        dmin, amin = ked.ed_min(queries, series)
        low = mat.min(dim=1).values
        first = (mat == low[:, None]).int().argmax(dim=1)
        check(torch.equal(low, dmin), f"witness {name} {what}: a row minimum differs "
                                      f"from ed_min's distance")
        check(torch.equal(first, amin.long()), f"witness {name} {what}: the first argmin "
                                               f"differs from ed_min's index")


def hold_fma_bits(queries, series, what: str, valid_ns=None, matrix: bool = True) -> None:
    """``ed_min`` (at each ``valid_n`` of ``valid_ns``, default all rows) and,
    with ``matrix``, ``ed_matrix`` over ``series`` (float32 or bf16) equal
    the exact fma references (``kernels/ref.py``: the kernels' fmaf chains
    through a correctly rounded fmaf built from float64 operations) in
    every bit: distances as int32 words, indices exactly."""
    import torch
    from repro_torch.kernels import ed as ked, ref

    def words(x):
        return x.contiguous().view(torch.int32)

    for valid in valid_ns or (series.shape[0],):
        dmin, amin = ked.ed_min(queries, series, valid_n=valid)
        want_d, want_a = ref.ed_min_fma_ref(queries, series, valid_n=valid)
        bad_d = int((words(dmin) != words(want_d)).sum())
        bad_a = int((amin != want_a).sum())
        check(bad_d == 0 and bad_a == 0,
              f"ed_min {what} valid_n {valid}: {bad_d} distances and {bad_a} indices "
              f"differ from ed_min_fma_ref")
    if matrix:
        got = ked.ed_matrix(queries, series)
        bad = int((words(got) != words(ref.ed_matrix_fma_ref(queries, series))).sum())
        check(bad == 0, f"ed_matrix {what}: {bad} outputs differ from ed_matrix_fma_ref")


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

    # ed_matrix (float32 and bf16 series) and decode_bf16_ed_matrix (a
    # payload at the codec's pitch): ragged shapes and both tile shapes;
    # each also held to the ed_min witness
    for (q, n, length) in [(1, 1, 1), (1, 100, 128), (5, 77, 48), (8, 129, 33),
                           (130, 4097, 256), (127, 31, 7), (1, 4097, 256),
                           (129, 131073, 255)]:
        qa, sa = randn(q, length), randn(n, length)
        assert_close(ked.ed_matrix(qa, sa), ref.ed_matrix_ref(qa, sa), "float32",
                     f"ed_matrix f32 {q}x{n}x{length}")
        sb = sa.to(torch.bfloat16)
        assert_close(ked.ed_matrix(qa, sb), ref.ed_matrix_ref(qa, sb), "bfloat16",
                     f"ed_matrix bf16 {q}x{n}x{length}")
        payload = bf16_payload(sa)
        got, sn = ked.decode_bf16_ed_matrix(qa, payload)
        assert_close(got, ref.decode_bf16_ed_matrix_ref(qa, payload), "float32",
                     f"decode_bf16_ed_matrix {q}x{n}x{length}")
        rows = ref.decode_bf16_ref(payload)
        assert_close(sn, S.fixed_order_sum(rows * rows), "float32",
                     f"decode_bf16_ed_matrix row norms {q}x{n}x{length}")
        hold_witness(qa, sa, payload, f"{q}x{n}x{length}")
        for tag, (qv, sv) in {"": (qa, sa), " +1 row": (qa[1:], sa[1:])}.items():
            if qv.shape[0] and sv.shape[0]:
                hold_fma_bits(qv, sv, f"f32 {q}x{n}x{length}{tag}",
                              (sv.shape[0], sv.shape[0] // 2))
                hold_fma_bits(qv, sv.to(torch.bfloat16), f"bf16 {q}x{n}x{length}{tag}")
    # ed_min's resident-query state at the edges of its fit: Q = 128 and
    # 129, n = 320 (float32) and 384 (bf16), the largest that fit, and one
    # past them
    for (q, n, length) in [(128, 40000, 320), (129, 40000, 320), (128, 40000, 321),
                           (128, 40000, 384), (128, 40000, 385)]:
        qa, sa = randn(q, length), randn(n, length)
        hold_fma_bits(qa, sa, f"f32 {q}x{n}x{length}", (n, n // 2), matrix=False)
        hold_fma_bits(qa, sa.to(torch.bfloat16), f"bf16 {q}x{n}x{length}", (n, n // 2),
                      matrix=False)
    # ed_min: ragged shapes, valid_n masking, ties, all-inf rows
    for (q, n, length) in [(1, 1, 1), (3, 13, 64), (5, 77, 48), (70, 5000, 256)]:
        qa, sa = randn(q, length), randn(n, length)
        hold_fma_bits(qa, sa, f"f32 {q}x{n}x{length}", (n, max(1, n // 2), 0),
                      matrix=False)
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
    hold_fma_bits(torch.zeros(4, 16, device=dev), torch.ones(200, 16, device=dev), "ties")
    # lb_sax: ragged N, m in {8, 16}, several alphabets, extreme PAA, and
    # every edge of v2's tiling (Q around its unrolled query loop and its
    # 128-query passes, N around its blocks of 256 threads x 2 series);
    # equal in every bit, as int32 words
    edges = itertools.product((1, 7, 8, 9, 127, 128, 129), (1, 255, 256, 257, 131073),
                              (8, 16), (2, 4, 16, 256))
    for (q, n, m, alphabet) in [(1, 1, 16, 256), (5, 77, 16, 256), (3, 130, 8, 64),
                                (9, 5001, 16, 16), (1, 70001, 16, 256), *edges]:
        length = 4 * m
        q_paa = S.paa(randn(q, length, scale=3.0), m)
        codes = S.isax(randn(n, length, scale=3.0), m, alphabet)
        got = klb.lb_sax_matrix(q_paa, codes, length, alphabet)
        want = ref.lb_sax_matrix_ref(q_paa, codes, length, alphabet)
        assert_close(got, want, "float32", f"lb_sax {q}x{n} m={m} a={alphabet}")
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"lb_sax {q}x{n} m={m} a={alphabet}: kernel and plain version differ in bits")
    q_paa = torch.full((2, 16), 1e15, device=dev)
    codes = S.isax(randn(7, 64), 16)
    check(torch.equal(klb.lb_sax_matrix(q_paa, codes, 64),
                      ref.lb_sax_matrix_ref(q_paa, codes, 64)), "lb_sax extreme PAA")
    torch.cuda.synchronize()
    log("[kernels] adversarial shapes: ed_matrix (f32, bf16), decode_bf16_ed_matrix, "
        "ed_min, lb_sax agree with their plain versions; ed_min and ed_matrix equal "
        "the exact fma references bit for bit (also one row in, and ed_min's "
        "resident-query state at the edges of its fit); the row minima and first "
        "argmins of ed_matrix and decode_bf16_ed_matrix equal ed_min's")


def reset_counters():
    from repro_torch.kernels import dtw as kdtw, ed as ked, lb_sax as klb, wkv6 as kwkv
    from repro_torch.kernels import rg_lru as krg
    for fn in (krg.rg_lru_scan, krg.rg_lru_scan_bwd):
        fn.launches = 0
        fn.launches_by.clear()
    kdtw.dtw_band.launches = 0
    klb.lb_sax_matrix.launches = 0
    ked.ed_matrix.launches = 0
    ked.ed_min.launches = 0
    ked.decode_bf16_ed_matrix.launches = 0
    for fn in (kwkv.wkv6, kwkv.wkv6_bwd):
        fn.launches = 0
        fn.launches_by.clear()


def read_counters() -> dict:
    """The launch counts of the kNN paths' kernels."""
    from repro_torch.kernels import ed as ked, lb_sax as klb
    return {"lb_sax_matrix": klb.lb_sax_matrix.launches,
            "ed_min": ked.ed_min.launches, "ed_matrix": ked.ed_matrix.launches,
            "decode_bf16_ed_matrix": ked.decode_bf16_ed_matrix.launches}


def phase_main(num_series: int, num_queries: int):
    import torch
    from repro_torch.core.engine import QueryEngine, dense_scan_knn, make_backend
    from repro_torch.core.index import IndexConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.tree import BuildConfig
    from repro_torch.data.synthetic import CHUNK_ROWS, make_query_workload, random_walks

    length = 256
    # the draw does not depend on the device: a few chunks and a ragged
    # tail, and queries from them, made for the card and for the CPU
    num = 3 * CHUNK_ROWS + 1000
    card, host = (random_walks(num, length, seed=5, device=d) for d in ("cuda", "cpu"))
    check(torch.equal(card.cpu(), host), "random_walks: the card's draw differs from the CPU's")
    check(torch.equal(make_query_workload(card, 50, "5%", seed=6).cpu(),
                      make_query_workload(host, 50, "5%", seed=6)),
          "make_query_workload: the card's queries differ from the CPU's")
    del card, host
    log(f"[main] random_walks ({num} x {length}) and make_query_workload give the same "
        f"bits on the card and on the CPU")
    t0 = time.perf_counter()
    data = random_walks(num_series, length, seed=0)
    queries = make_query_workload(data, num_queries, "5%", seed=1)
    torch.cuda.synchronize()
    log(f"[main] data {num_series} x {length} float32 "
        f"({num_series * length * 4 / 2**30:.2f} GiB) drawn on the host in chunks of "
        f"{CHUNK_ROWS} rows into the card in {time.perf_counter() - t0:.2f}s")
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
    return data, queries, local, launches, answers, summary


DISK_BUDGET_MB = 256            # 131,072-row blocks of 256 float32 values
FULL_SERIES = 1 << 22           # the full run's collection (--num-series default)


def disk_root(disk_dir: str | None, num: int, n: int) -> str:
    """A new directory for the disk and store phases' index, with room for
    two generations side by side plus the journal: the compaction writes
    generation 1 before it sweeps generation 0."""
    if disk_dir:
        os.makedirs(disk_dir, exist_ok=True)
        root = tempfile.mkdtemp(prefix="hercules-disk-", dir=disk_dir)
    else:
        root = tempfile.mkdtemp(prefix="hercules-disk-")
    free = shutil.disk_usage(root).free
    # a generation: lrd (4n bytes a row) + enc (2n + 4) + lsd (16), padding
    # and the small files, about 6.5 GB at 2**22 x 256; the journal: lrd +
    # lsd of 1/16 of the rows; then generation 1 over both, beside the
    # compaction's id-order copy of the base (4n bytes a row): about 18 GB
    jrows = journal_rows(num) * 2
    need = int(((2 * num + jrows) * (6 * n + 20) + num * 4 * n) * 1.05) + (128 << 20)
    log(f"[disk] index directory {root}: {free / 2**30:.1f} GiB free, the index, "
        f"its journal and its compacted generation need about {need / 2**30:.1f} GiB")
    if free < need:
        shutil.rmtree(root, ignore_errors=True)
        fail(f"{root} has too little free space (pass --disk-dir)")
    return root


def ooc_delta(after, before):
    """The streaming counters of one call of an engine the store caches
    (``after`` minus ``before``, both ``OocTelemetry``)."""
    import dataclasses
    return type(after)(**{f.name: getattr(after, f.name) - getattr(before, f.name)
                          for f in dataclasses.fields(after)})


def phase_disk(data, queries, local, answers, root: str, profile: bool = False):
    """The disk-resident path at phase 4's data scale: a store created at
    ``root`` (``Hercules.create``, a chunked build straight to format v3
    with the bf16 codec), served by ``ooc-scan`` and ``ooc-local`` engines
    of the store under a 256 MiB budget. Returns (the path's kernel
    launches, blocks of its encoded, LSD and LRD files staged on the card
    for phase 9, summary, the open store for phases 6, 7 and 8).

    At the full size phase 1 of ``ooc-local`` seeds 1,624 of the 1,635
    leaves, and the rest must go through phase 3 (the LSD sidecar and the
    LB_SAX kernel) in every ``ooc-local`` call. Only a short check (fewer
    series) may seed every leaf and skip it."""
    import numpy as np
    import torch
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.index import IndexConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.tree import BuildConfig
    from repro_torch.data.pipeline import ArrayChunkSource
    from repro_torch.storage import Hercules

    num, n = data.shape
    path = os.path.join(root, "idx")
    need_sax = num >= FULL_SERIES
    t0 = time.perf_counter()
    host = data.cpu().numpy()
    log(f"[disk] collection copied to the host in {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    # the build's reader mode comes from the config: the threaded reader
    hx = Hercules.create(
        path, IndexConfig(build=BuildConfig(leaf_capacity=4096),
                          search=SearchConfig(prefetch="thread")),
        data=ArrayChunkSource(host, 1 << 18), codec="bf16")
    build_s = time.perf_counter() - t0
    del host
    b = hx.manifest["extra"]["build"]
    sizes = {name: os.path.getsize(os.path.join(path, name))
             for name in ("lrd.npy", "enc.npy", "lsd.npy", "tree.npz", "layout.npz")}
    log(f"[disk] store created in {build_s:.2f}s (the build, then the open's checksum "
        f"pass): tree_seconds {b['tree_seconds']}, write_seconds {b['write_seconds']} "
        f"(chunks of {b['chunk_size']} rows, {b['num_chunks']} chunks, prefetch "
        f"{b['prefetch']}); file bytes {sizes}")
    log("[disk] the files were just written, so the reads below may come from "
        "the page cache rather than the disk")

    summary = {"build_s": build_s, "tree_s": b["tree_seconds"],
               "write_s": b["write_seconds"], "bytes": sizes, "calls": {}}
    saved = hx.saved
    mem = local.index
    for field in mem.tree._fields:
        check(torch.equal(getattr(saved.tree, field), getattr(mem.tree, field).cpu()),
              f"disk build: tree field {field} differs from the in-memory build")
    for field in ("perm", "leaf_start", "leaf_count"):
        check(np.array_equal(saved.small[field],
                             getattr(mem.layout, field).cpu().numpy()),
              f"disk build: {field} differs from the in-memory build")
    check(saved.n_pad == mem.layout.lrd.shape[0] and saved.codec == "bf16",
          "disk build: n_pad or codec differs")
    log(f"[disk] the disk build's tree, perm, leaf_start and leaf_count equal the "
        f"in-memory build's; n_pad {saved.n_pad}, codec {saved.codec}")

    runs = [(name, codec, k, "thread") for name in ("ooc-scan", "ooc-local")
            for codec in ("raw", "bf16") for k in (1, 10)]
    runs.append(("ooc-local", "bf16", 10, "sync"))
    sax_read = False
    reset_counters()
    for name, codec, k, prefetch in runs:
        eng = hx.engine(name, search=SearchConfig(codec=codec, prefetch=prefetch),
                        memory_budget_mb=DISK_BUDGET_MB)
        before, t_before = read_counters(), eng.telemetry().ooc
        t0 = time.perf_counter()
        res = eng.knn(queries, k=k)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = read_counters()
        t = ooc_delta(eng.telemetry().ooc, t_before)
        tag = f"{name} {codec} k={k} {prefetch}"
        log(f"[disk] {tag}: {1e3 * dt / len(queries):.3f} ms/query, blocks "
            f"{t.blocks}, rows_streamed {t.rows_streamed}, bytes_streamed "
            f"{t.bytes_streamed}, read_seconds {t.read_seconds:.3f}, "
            f"read_wait_seconds {t.read_wait_seconds:.3f}, overlap_blocks "
            f"{t.overlap_blocks}, sax_rows_read {t.sax_rows_read}, "
            f"codec_refine_rows {t.codec_refine_rows}, codec_fallbacks "
            f"{t.codec_fallbacks}, launches "
            f"{ {key: after[key] - before[key] for key in after} }")
        summary["calls"][tag] = {"ms_per_query": 1e3 * dt / len(queries),
                                 "rows_streamed": t.rows_streamed,
                                 "codec_fallbacks": t.codec_fallbacks,
                                 "launches": {key: after[key] - before[key]
                                              for key in after}}
        if (name, codec, k, prefetch) == ("ooc-local", "raw", 1, "thread"):
            # phase 5b holds the sanitized call to this one
            answers[("ooc-local raw", 1)] = res
        want = answers[("local" if name == "ooc-local" else "scan", k)]
        check(torch.equal(res.dists, want.dists),
              f"{tag}: dists are not bit-identical to the in-memory "
              f"{'local' if name == 'ooc-local' else 'scan'}")
        check(torch.equal(res.ids.long(), want.ids.long()),
              f"{tag}: ids differ from the in-memory answers "
              f"({int((res.ids.long() != want.ids.long()).sum())} entries)")
        if codec == "bf16":
            launched = after["decode_bf16_ed_matrix"] - before["decode_bf16_ed_matrix"]
            # a fallback streams raw blocks too; those need no decode
            need = t.blocks if t.codec_fallbacks == 0 else 1
            check(launched >= need, f"{tag}: decode_bf16_ed_matrix launched "
                                    f"{launched} times for {t.blocks} blocks")
        if name == "ooc-local" and (need_sax or t.sax_rows_read):
            # phase 3: the LSD sidecar goes through the LB_SAX kernel
            check(t.sax_rows_read > 0, f"{tag}: no LSD rows were read")
            check(after["lb_sax_matrix"] > before["lb_sax_matrix"],
                  f"{tag}: lb_sax_matrix never launched")
        sax_read = sax_read or t.sax_rows_read > 0
    launches = read_counters()
    log(f"[disk] kernel launches during the disk path: {launches}")
    for kname, count in launches.items():
        # a short check may seed every leaf: then phase 3, the LB_SAX
        # pass, has nothing to filter
        if kname != "lb_sax_matrix" or sax_read or need_sax:
            check(count > 0, f"disk path: {kname} was never launched")
    log("[disk] every answer equals the in-memory answers: ooc-local dists "
        "bit-identical to local, ooc-scan dists bit-identical to scan, ids equal")
    if profile:
        for name, codec, k, bucket in (("ooc-scan", "bf16", 10, None),
                                       ("ooc-scan", "raw", 1, None),
                                       ("ooc-local", "raw", 1, None),
                                       ("ooc-local", "raw", 1, len(queries))):
            eng = hx.engine(name, search=SearchConfig(codec=codec, prefetch="thread"),
                            memory_budget_mb=DISK_BUDGET_MB,
                            engine_config=EngineConfig(
                                bucket_sizes=(bucket,) if bucket else ()))
            trace(f"{name} {codec} k={k}, {len(queries)} queries, bucket "
                  f"{bucket or 'pow2'}", lambda: eng.knn(queries, k=k))
            t = eng.telemetry().ooc
            log(f"[profile]   rows_streamed {t.rows_streamed}, blocks {t.blocks}, "
                f"read_wait_seconds {t.read_wait_seconds:.3f}")
    rows = min(num, 1 << 17)
    enc = torch.from_numpy(np.array(saved._mapped("enc")[:rows])).cuda()
    lsd = torch.from_numpy(np.array(saved._mapped("lsd")[:rows])).cuda()
    lrd = torch.from_numpy(np.array(saved._mapped("lrd")[:rows])).cuda()
    return launches, (enc, lsd, lrd), summary, hx


def phase_sanitize(hx, queries, answers, disk):
    """The runtime sanitizer on phase 5's store: a fresh read-only handle
    opened under ``REPRO_SANITIZE=1`` (its maps wrapped in ``MmapGuard``s,
    its readers poisoning each recycled pinned slot and checking every
    staged block against a snapshot) answers phase 5's ``ooc-local`` raw
    k=1 call with the threaded reader, equal in every field and raising no
    ``SanitizerError``; after ``close()`` a read of its ``lrd`` raises
    ``UseAfterCloseError``. Returns the phase's summary."""
    import torch
    from repro_torch.analysis import sanitize
    from repro_torch.core.search import SearchConfig
    from repro_torch.storage import Hercules

    prev = os.environ.get(sanitize.ENV_VAR)
    os.environ[sanitize.ENV_VAR] = "1"
    try:
        sx = Hercules.open(hx.path, "r", verify=False)
        try:
            check(isinstance(sx.saved.lrd, sanitize.MmapGuard),
                  "[sanitize] the store's lrd is not guarded under REPRO_SANITIZE=1")
            eng = sx.engine("ooc-local", search=SearchConfig(codec="raw", prefetch="thread"),
                            memory_budget_mb=DISK_BUDGET_MB)
            t0 = time.perf_counter()
            res = eng.knn(queries, k=1)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            blocks = eng.telemetry().ooc.blocks
            escaped = sx.saved.lrd
        finally:
            sx.close()
    finally:
        if prev is None:
            os.environ.pop(sanitize.ENV_VAR)
        else:
            os.environ[sanitize.ENV_VAR] = prev
    want = answers[("ooc-local raw", 1)]
    for field in want._fields:
        check(torch.equal(getattr(res, field), getattr(want, field)),
              f"[sanitize] ooc-local raw k=1 under REPRO_SANITIZE=1: {field} differs "
              f"from phase 5's answers")
    try:
        escaped[0]
    except sanitize.UseAfterCloseError as e:
        log(f"[sanitize] reading the closed store's lrd raises UseAfterCloseError: {e}")
    else:
        fail("[sanitize] reading the closed store's lrd did not raise UseAfterCloseError")
    ms = 1e3 * dt / len(queries)
    before = disk["calls"]["ooc-local raw k=1 thread"]["ms_per_query"]
    log(f"[sanitize] ooc-local raw k=1 under REPRO_SANITIZE=1 (fresh handle, threaded "
        f"reader, {blocks} blocks staged and checked): {ms:.3f} ms/query, against "
        f"{before:.3f} in phase 5; answers equal in every field")
    return {"ms_per_query": ms, "phase5_ms_per_query": before, "blocks": blocks}


# the serving runs: 255 valid requests and 1 of the wrong length over each
# engine. Over local the bad request rides in a mixed wave and, once that
# wave fails, its mates are served again one by one, each padded to the 32
# slots. Over ooc-local such a call streams most of the bf16 store (~2 s at
# 2**22), so there the bad request and 3 valid mates carry an explicit
# l_max override equal to the configured value (the same SearchConfig,
# another signature): their sub-wave is 4 requests, its fallback 4 calls
SERVE_REQUESTS = 256
SERVE_SLOTS = 32
SERVE_MAX_QUEUE = 64
SERVE_OV = {"l_max": 80}


def phase_waves(queries, local, answers, hx, summary):
    """The wave plans and kNN serving at phase 4's scale, on phase 4's
    ``local`` backend and phase 5's store engines (before the journal):
    ``knn(..., wave=True)`` on ``local`` (one ``lb_sax_matrix`` launch a
    call), ``ooc-scan`` and ``ooc-local`` (raw and bf16, k=1 and 10), each
    held bit for bit to phase 4's per-query answers (ids as sets per row);
    ``ooc-local``'s streaming and sharing counters beside the same engine's
    batch call; then 256 mixed k=1/k=10 requests through ``KnnServeEngine``
    (32 slots, wave plans, difficulty packing, a queue bound that rejects
    and is retried) over ``local`` and over the bf16 ``ooc-local`` engine,
    each wave call timed with its size: every answer equal to the query's
    per-query answer, exactly one failure (the request of the wrong
    length), its wave-mates answered, and over ``ooc-local`` at least one
    full k=10 wave of 32. Returns the phase's summary, its kernel launches
    by call under ``launches``."""
    import numpy as np
    import torch
    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.search import SearchConfig
    from repro_torch.serve import KnnFailure, KnnServeConfig, KnnServeEngine, QueueFull

    nq = len(queries)
    bucket = 1 << (nq - 1).bit_length()
    need_sax = local.index.layout.num_series >= FULL_SERIES
    out: dict = {"ms_per_query": {}, "calls": {}, "launches": {}, "serving": {}}
    want = {key: (res.dists.cpu(), torch.sort(res.ids.long(), 1).values.cpu())
            for key, res in answers.items()}
    reset_counters()

    def hold(res, key, tag):
        rows = res.dists.shape[0]
        check(torch.equal(res.dists.cpu(), want[key][0][:rows]),
              f"{tag}: dists are not bit-identical to phase 4's {key[0]} answers")
        check(torch.equal(torch.sort(res.ids.long(), 1).values.cpu(), want[key][1][:rows]),
              f"{tag}: ids differ from phase 4's {key[0]} answers")

    def call(eng, k, wave, q=queries):
        before, t_before = read_counters(), eng.telemetry().ooc
        t0 = time.perf_counter()
        res = eng.knn(q, k=k, wave=wave)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / len(q)
        after = read_counters()
        t = None if t_before is None else ooc_delta(eng.telemetry().ooc, t_before)
        return res, ms, t, {key: after[key] - before[key] for key in after}

    # local: wave_knn, one LB_SAX launch over the (bucket, m) PAA matrix
    eng = QueryEngine(local)
    torch.cuda.reset_peak_memory_stats()
    lb_wave = 0
    for k in (1, 10):
        res, ms, _, launched = call(eng, k, True)
        hold(res, ("local", k), f"local wave k={k}")
        check(launched["lb_sax_matrix"] == 1,
              f"local wave k={k}: lb_sax_matrix launched {launched['lb_sax_matrix']} times")
        lb_wave += launched["lb_sax_matrix"]
        was = summary["ms_per_query"][f"local_k{k}"]
        out["ms_per_query"][f"local k={k}"] = ms
        log(f"[waves] local k={k} wave: {ms:.3f} ms/query against {was:.3f} per query in "
            f"phase 4 ({ms - was:+.3f}); launches {launched}")
    out["local_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["lb_sax_wave_launches"] = lb_wave
    log(f"[waves] local wave: peak device memory {out['local_peak_gib']:.2f} GiB "
        f"(phase 4: {summary['peak_gib']:.2f}); answers bit for bit phase 4's")

    def counters(t) -> dict:
        return {f: getattr(t, f) for f in (
            "rows_streamed", "bytes_streamed", "blocks", "runs_deduped",
            "runs_skipped_bsf", "wave_rows_shared", "read_seconds",
            "read_wait_seconds", "overlap_blocks", "codec_fallbacks")}

    def ooc_line(t) -> str:
        return (f"rows_streamed {t.rows_streamed}, bytes_streamed {t.bytes_streamed}, "
                f"blocks {t.blocks}, runs_deduped {t.runs_deduped}, runs_skipped_bsf "
                f"{t.runs_skipped_bsf}, wave_rows_shared {t.wave_rows_shared}, "
                f"read_seconds {t.read_seconds:.3f}, read_wait_seconds "
                f"{t.read_wait_seconds:.3f}, overlap_blocks {t.overlap_blocks}, "
                f"codec_fallbacks {t.codec_fallbacks}")

    # ooc-scan: the batch stream, every row shared by the whole bucket
    for codec in ("raw", "bf16"):
        for k in (1, 10):
            eng = hx.engine("ooc-scan", search=SearchConfig(codec=codec, prefetch="thread"),
                            memory_budget_mb=DISK_BUDGET_MB)
            res, ms, t, launched = call(eng, k, True)
            tag = f"ooc-scan {codec} k={k} wave"
            hold(res, ("scan", k), tag)
            check(t.wave_calls == 1 and t.wave_rows_shared == t.rows_streamed * (bucket - 1),
                  f"{tag}: wave_calls {t.wave_calls}, wave_rows_shared "
                  f"{t.wave_rows_shared} != rows_streamed {t.rows_streamed} x {bucket - 1}")
            out["ms_per_query"][tag] = ms
            out["launches"][tag] = launched
            log(f"[waves] {tag}: {ms:.3f} ms/query; {ooc_line(t)}; launches {launched}")

    # ooc-local: the demand-scheduled wave (raw) and the codec wave (bf16),
    # each beside the same engine's batch call
    for codec, k, prefetch in (("raw", 1, "thread"), ("raw", 10, "thread"),
                               ("bf16", 1, "thread"), ("bf16", 10, "thread"),
                               ("raw", 10, "sync")):
        eng = hx.engine("ooc-local", search=SearchConfig(codec=codec, prefetch=prefetch),
                        memory_budget_mb=DISK_BUDGET_MB)
        for wave in (False, True):
            res, ms, t, launched = call(eng, k, wave)
            tag = f"ooc-local {codec} k={k} {prefetch} {'wave' if wave else 'batch'}"
            hold(res, ("local", k), tag)
            if wave:
                check(t.wave_calls == 1, f"{tag}: wave_calls {t.wave_calls}")
            if need_sax or t.sax_rows_read:
                check(launched["lb_sax_matrix"] > 0, f"{tag}: lb_sax_matrix never launched")
            out["ms_per_query"][tag] = ms
            out["launches"][tag] = launched
            out["calls"][tag] = counters(t)
            log(f"[waves] {tag}: {ms:.3f} ms/query; {ooc_line(t)}; launches {launched}")

    class Timed:
        """The engine as ``KnnServeEngine`` sees it, each wave call timed
        with its real rows, k, outcome and streaming counters."""

        def __init__(self, eng):
            self.eng, self.calls, self.step = eng, [], 0

        def knn(self, q, k, valid_rows, **kw):
            t_ooc, t0, ok = self.eng.telemetry().ooc, time.perf_counter(), False
            try:
                res = self.eng.knn(q, k=k, valid_rows=valid_rows, **kw)
                torch.cuda.synchronize()
                ok = True
                return res
            finally:
                self.calls.append(dict(
                    step=self.step, k=k, rows=valid_rows, ok=ok,
                    s=time.perf_counter() - t0,
                    ooc=None if t_ooc is None else ooc_delta(self.eng.telemetry().ooc, t_ooc)))

        def estimate_difficulty(self, q):
            return self.eng.estimate_difficulty(q)

        def telemetry(self):
            return self.eng.telemetry()

    # serving: mixed k=1/k=10 traffic in waves of 32, the bad request (and
    # over ooc-local its override group) submitted halfway
    host_q = queries.cpu().numpy()
    for name, eng, ov in (("local", QueryEngine(local), {}),
                          ("ooc-local bf16", hx.engine(
                              "ooc-local", search=SearchConfig(codec="bf16", prefetch="thread"),
                              memory_budget_mb=DISK_BUDGET_MB), SERVE_OV)):
        # k=1 twice as often as k=10, so a k=1 sub-wave's peers outnumber the
        # slots and difficulty packing scores them
        mates = 3 if ov else 0
        n_plain = SERVE_REQUESTS - 1 - mates
        plain = [(i % nq, 10 if i % 3 == 2 else 1, {}) for i in range(n_plain)]
        group = [(i % nq, 1, ov) for i in range(n_plain, n_plain + mates)]
        reqs = plain[:n_plain // 2] + group + [(None, 1, ov)] + plain[n_plain // 2:]
        timed_eng = Timed(eng)
        serve = KnnServeEngine(timed_eng, KnnServeConfig(
            batch_slots=SERVE_SLOTS, wave=True, pack="difficulty",
            max_queue=SERVE_MAX_QUEUE))

        step_s: dict = {}

        def step():
            timed_eng.step += 1
            t_step = time.perf_counter()
            served = serve.step()
            step_s[timed_eng.step] = time.perf_counter() - t_step
            return served

        before = read_counters()
        rids, retries = [], 0
        t0 = time.perf_counter()
        for qi, k, o in reqs:
            q = host_q[qi] if qi is not None else host_q[0][:-1]   # the wrong length
            while True:
                try:
                    rids.append(serve.submit(q, k=k, **o))
                    break
                except QueueFull:       # backpressure: serve a wave, then retry
                    retries += 1
                    step()
        while step():
            pass
        got = serve.drain()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = read_counters()
        out["launches"][f"serving {name}"] = {key: after[key] - before[key] for key in after}
        sv = serve.telemetry().serving
        check(set(got) == set(rids) and serve.pending() == 0,
              f"serving {name}: {len(got)} of {len(rids)} requests completed")
        check(retries > 0 and sv["rejected"] == retries,
              f"serving {name}: QueueFull raised {sv['rejected']} times, retried {retries}")
        bad = [got[r] for r, (qi, _, _) in zip(rids, reqs) if qi is None]
        check(len(bad) == 1 and isinstance(bad[0], KnnFailure)
              and bad[0].error.startswith("ValueError"),
              f"serving {name}: the request of the wrong length gave {bad!r}")
        failed = [got[r] for r, (qi, _, _) in zip(rids, reqs)
                  if qi is not None and isinstance(got[r], KnnFailure)]
        check(not failed and sv["failed"] == 1,
              f"serving {name}: {len(failed)} valid requests failed, e.g. "
              f"{failed[:1]}")
        for rid, (qi, k, _) in zip(rids, reqs):
            if qi is None:
                continue
            a = got[rid]
            check(np.array_equal(a.dists, want[("local", k)][0][qi].numpy()),
                  f"serving {name}: request {rid} (query {qi}, k={k}): dists differ")
            check(np.array_equal(np.sort(a.ids), want[("local", k)][1][qi].numpy()),
                  f"serving {name}: request {rid} (query {qi}, k={k}): ids differ")
        # the waves: a step of one call served its wave; the step of more is
        # the bad request's wave, which failed before it reached the engine
        # (its series do not stack), its members then served one by one
        calls = timed_eng.calls
        by_step: dict = {}
        for c in calls:
            by_step.setdefault(c["step"], []).append(c)
        waves = [cs[0] for cs in by_step.values() if len(cs) == 1]
        fb = [(st, cs) for st, cs in by_step.items() if len(cs) > 1]
        check(len(fb) == 1 and sum(not c["ok"] for c in fb[0][1]) == 1
              and all(c["ok"] and c["rows"] == 1 for c in fb[0][1] if c["ok"])
              and all(c["ok"] for c in waves),
              f"serving {name}: wave calls by step {by_step}")
        comp: dict = {}
        for c in waves:
            key = f"k={c['k']} {'full' if c['rows'] == SERVE_SLOTS else 'padded'}"
            e = comp.setdefault(key, {"waves": 0, "requests": 0, "seconds": 0.0})
            e["waves"] += 1
            e["requests"] += c["rows"]
            e["seconds"] += c["s"]
        fallback = {"wave_rows": len(fb[0][1]), "calls": len(fb[0][1]),
                    "seconds": step_s[fb[0][0]]}
        if ov:
            check(comp.get("k=10 full", {}).get("waves", 0) >= 1,
                  f"serving {name}: no full k=10 wave of {SERVE_SLOTS} was served: {comp}")
        out["serving"][name] = {"seconds": dt, "requests_per_s": len(rids) / dt,
                                "waves": sv["waves"], "wave_calls": len(calls),
                                "by_composition": comp, "fallback": fallback,
                                "rejected": sv["rejected"],
                                "difficulty_mean": sv["difficulty_mean"],
                                "difficulty_scored": sv["difficulty_scored"]}
        for c in calls:
            if c["ooc"] is not None:
                log(f"[waves] serving {name}, step {c['step']}: k={c['k']}, {c['rows']} of "
                    f"{SERVE_SLOTS} rows real, {'served' if c['ok'] else 'failed'} in "
                    f"{c['s']:.3f}s; {ooc_line(c['ooc'])}")
        if calls[0]["ooc"] is not None:
            out["serving"][name]["ooc"] = [dict(k=c["k"], rows=c["rows"], s=c["s"],
                                                **counters(c["ooc"])) for c in calls]
        log(f"[waves] serving {name}: {len(rids)} requests in {dt:.2f}s "
            f"({len(rids) / dt:.1f} requests/s), {sv['waves']} waves served in "
            f"{len(calls)} wave calls; by composition (waves, requests, s): "
            + "; ".join(f"{key} {e['waves']}, {e['requests']}, {e['seconds']:.2f}"
                        for key, e in sorted(comp.items()))
            + f"; the bad request's wave of {fallback['wave_rows']} failed and was served "
            f"again in {fallback['calls']} single-member calls (the bad one failing), "
            f"{fallback['seconds']:.2f}s in all; QueueFull {sv['rejected']} times (retried), 1 failure (the wrong length), "
            f"difficulty_mean {sv['difficulty_mean']:.6f} over {sv['difficulty_scored']} "
            f"scored; every answer equals the query's per-query answer; launches "
            f"{out['launches'][f'serving {name}']}")
    launches = read_counters()
    log(f"[waves] kernel launches during the wave phase: {launches}")
    for kname, count in launches.items():
        check(count > 0, f"wave phase: {kname} was never launched")
    return out

SHARDS = 4                      # the shards phase's shard count, all on one card
SHARD_RUNS = ((SHARDS, "raw", 1, False), (SHARDS, "raw", 10, False),
              (SHARDS, "bf16", 10, False), (SHARDS, "bf16", 10, True),
              (1, "bf16", 10, False))


def phase_shards(data, queries, local, answers, hx, summary):
    """Sharding at phase 4's scale (before the journal): ``sharded`` with
    4 shards on the one card, built from phase 4's data, and the store's
    ``dist-ooc`` engines (``SHARD_RUNS``: shards, stream, k, wave), every
    answer held bit for bit to phase 4's (ids and positions as sets per row
    for the wave call), every shard reader inside its row range. Returns
    the phase's summary."""
    import torch
    from repro_torch.core.engine import QueryEngine, make_backend
    from repro_torch.core.search import SearchConfig

    nq = len(queries)
    out: dict = {"ms_per_query": {}, "dist": {}, "launches": {}}
    reset_counters()

    # sharded: one index a shard of N/4 rows, all four on the card of the data
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sharded = make_backend("sharded", data, index_config=local.index.config,
                           devices=[data.device] * SHARDS)
    torch.cuda.synchronize()
    out["sharded_build_s"] = time.perf_counter() - t0
    st = sharded.stacked
    out["shard_n_pad"] = st.layout.lrd.shape[1]
    log(f"[shards] sharded: {SHARDS} indexes of {st.layout.num_series} rows built on "
        f"{sharded.devices} in {out['sharded_build_s']:.2f}s (phase 4's one index: "
        f"{summary['build_s']:.2f}s); stacked N_pad {st.layout.lrd.shape[1]}, leaves "
        f"(padded) {st.layout.num_leaves}, max_leaf {st.layout.max_leaf}, depth "
        f"{st.max_depth}")
    eng = QueryEngine(sharded)
    for k in (1, 10):
        before = read_counters()
        t0 = time.perf_counter()
        res = eng.knn(queries, k=k)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / nq
        after = read_counters()
        want = answers[("local", k)]
        check(torch.equal(res.dists, want.dists),
              f"[shards] sharded k={k}: dists are not bit-identical to phase 4's local "
              f"({int((res.dists != want.dists).sum())} entries)")
        check(torch.equal(res.ids.long(), want.ids.long()),
              f"[shards] sharded k={k}: ids differ from phase 4's local answers")
        tag = f"sharded k={k}"
        out["ms_per_query"][tag] = ms
        out["launches"][tag] = {key: after[key] - before[key] for key in after}
        was = summary["ms_per_query"][f"local_k{k}"]
        log(f"[shards] {tag}: {ms:.3f} ms/query against {was:.3f} for phase 4's local; "
            f"answers bit for bit phase 4's; launches {out['launches'][tag]}")
    out["sharded_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    lb = sum(c["lb_sax_matrix"] for c in out["launches"].values())
    check(lb >= SHARDS * nq, f"[shards] sharded: lb_sax_matrix launched {lb} < "
                             f"{SHARDS} x {nq} times")
    log(f"[shards] sharded: peak device memory {out['sharded_peak_gib']:.2f} GiB (phase "
        f"4: {summary['peak_gib']:.2f}, its index still resident)")
    del sharded, eng, st
    torch.cuda.empty_cache()

    # dist-ooc over phase 5's store: every shard streams its own rows
    want_sets = {key: (torch.sort(res.ids.long(), 1).values,
                       torch.sort(res.positions.long(), 1).values)
                 for key, res in answers.items() if key[0] == "local"}
    for shards, codec, k, wave in SHARD_RUNS:
        eng = hx.engine("dist-ooc", search=SearchConfig(codec=codec, prefetch="thread"),
                        memory_budget_mb=DISK_BUDGET_MB, shards=shards)
        before, d0 = read_counters(), eng.telemetry().dist
        t0 = time.perf_counter()
        res = eng.knn(queries, k=k, wave=wave)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / nq
        after = read_counters()
        d = eng.telemetry().dist
        tag = f"dist-ooc shards={shards} {codec} k={k}{' wave' if wave else ''}"
        want = answers[("local", k)]
        check(torch.equal(res.dists, want.dists),
              f"[shards] {tag}: dists are not bit-identical to phase 4's local "
              f"({int((res.dists != want.dists).sum())} entries)")
        if wave:
            ids, pos = want_sets[("local", k)]
            check(torch.equal(torch.sort(res.ids.long(), 1).values, ids)
                  and torch.equal(torch.sort(res.positions.long(), 1).values, pos),
                  f"[shards] {tag}: ids or positions differ from phase 4's (as sets)")
        else:
            check(torch.equal(res.ids.long(), want.ids.long())
                  and torch.equal(res.positions.long(), want.positions.long()),
                  f"[shards] {tag}: ids or positions differ from phase 4's local")
        for s, ((lo, hi), touched) in enumerate(zip(d.row_range, d.rows_touched)):
            check(touched is not None and lo <= touched[0] and touched[1] <= hi,
                  f"[shards] {tag}: shard {s} touched rows {touched} outside {[lo, hi]}")
        rows = [a - b for a, b in zip(d.rows_streamed, d0.rows_streamed)]
        nbytes = [a - b for a, b in zip(d.bytes_streamed, d0.bytes_streamed)]
        wait = [a - b for a, b in zip(d.read_wait_seconds, d0.read_wait_seconds)]
        imbalance = max(rows) / max(min(rows), 1)
        launched = {key: after[key] - before[key] for key in after}
        was = summary["disk"]["calls"][f"ooc-local {codec} k={k} thread"]["ms_per_query"]
        out["ms_per_query"][tag] = ms
        out["launches"][tag] = launched
        out["dist"][tag] = {"rows_streamed": rows, "bytes_streamed": nbytes,
                            "read_wait_seconds": wait, "imbalance": imbalance,
                            "row_range": d.row_range, "rows_touched": d.rows_touched}
        log(f"[shards] {tag}: {ms:.3f} ms/query against {was:.3f} for phase 5's "
            f"ooc-local {codec} k={k} ({ms - was:+.3f}); rows_streamed {rows}, "
            f"bytes_streamed {nbytes}, imbalance {imbalance:.3f} (plan "
            f"{d.plan_imbalance:.3f}), read_wait_seconds "
            f"{[round(w, 4) for w in wait]}, row_range {d.row_range}, rows_touched "
            f"{d.rows_touched}; launches {launched}; answers bit for bit phase 4's")
        if codec == "bf16":
            check(launched["decode_bf16_ed_matrix"] > 0,
                  f"[shards] {tag}: decode_bf16_ed_matrix never launched")
    # where the threaded fan-out's time goes: the shards of the 4-shard bf16
    # k=10 engine driven one after another on this thread, no pool
    eng = hx.engine("dist-ooc", search=SearchConfig(codec="bf16", prefetch="thread"),
                    memory_budget_mb=DISK_BUDGET_MB, shards=SHARDS)
    shard_ms = []
    for sub in eng.backend._subs:
        t0 = time.perf_counter()
        QueryEngine(sub).knn(queries, k=10)
        torch.cuda.synchronize()
        shard_ms.append(1e3 * (time.perf_counter() - t0) / nq)
    out["sequential_shard_ms"] = shard_ms
    threaded = out["ms_per_query"][f"dist-ooc shards={SHARDS} bf16 k=10"]
    log(f"[shards] the {SHARDS} shards of dist-ooc bf16 k=10 one after another on the "
        f"main thread: {[round(v, 3) for v in shard_ms]} ms/query, {sum(shard_ms):.3f} in "
        f"all, against {threaded:.3f} for the threaded fan-out")
    launches = read_counters()
    out["phase_launches"] = launches
    log(f"[shards] kernel launches during the shards phase: {launches}")
    for kname in ("lb_sax_matrix", "decode_bf16_ed_matrix"):
        check(launches[kname] > 0, f"shards phase: {kname} was never launched")
    return out


DTW_QUERIES = 16                # phase 4's first queries
DTW_BAND = 13                   # a 5% warping window of n = 256 (UCR-Suite's convention)
DTW_KS = (1, 10)
DTW_BITS_ROWS = 4096            # the kernel-vs-plain shape: 1 query x 4,096 rows
DTW_LATE_QUERIES = 4            # a late round: the queries still refining
DTW_WIDE_BAND = 40              # a band past v2's instances: v1's kernel


def dtw_cost(pairs: int, n: int, band: int) -> tuple[int, int]:
    """(bytes, operations) of ``pairs`` banded-DTW pairs of length ``n``:
    each candidate row read once and each distance written once, and 5
    FP32 operations (subtract, multiply, two minima, add; no FMA) a band
    cell, bound at :data:`DTW_OPS_PER_S` (a row's ``ops_per_s``)."""
    band = min(band, n - 1)
    cells = n * (2 * band + 1) - band * (band + 1)
    return pairs * (n + 1) * 4, 5 * pairs * cells


def dtw_latency_ms(n: int, cycles: int = 8) -> float:
    """The least time of one pair whatever the parallelism: its 2n - 1
    anti-diagonals in series, one dependent FMNMX and FADD each (~4 cycles
    apiece on Hopper, an estimate), at :data:`SM_CLOCK_HZ`."""
    return 1e3 * (2 * n - 1) * cycles / SM_CLOCK_HZ


def words32(x):
    import torch
    return x.contiguous().view(torch.int32)


def phase_dtw(queries, local):
    """Exact banded-DTW kNN on phase 4's in-memory index (before the
    journal): ``dtw_knn`` over the first ``DTW_QUERIES`` queries at band
    ``DTW_BAND``, k = 1 and 10, held against a brute-force ``dtw_band`` over
    every row with a stable top-k (dists bit-identical, positions equal);
    ``dtw_band`` held bit for bit to ``dtw_band_ref`` on the card through
    every kernel the run reaches (``kernels/dtw.py::_plan``'s choice at 1
    query x 4,096 rows, a refinement round and a late round of 4 queries,
    v2 with one thread a pair, and v1 at band ``DTW_WIDE_BAND``); both times
    at those shapes, at the brute force's (1 query x every row), and v1's at
    the round; each ``dtw_knn`` call's launches x the round's device time
    against its wall time (the rest is the host's). Returns (the kernels
    line's rows: the round and 1 x 4,096; the other shapes' rows; summary)."""
    import torch
    from repro_torch.core.dtw import dtw_knn
    from repro_torch.kernels import dtw as kdtw, ref

    layout = local.index.layout
    q = queries[:DTW_QUERIES]
    num, n = layout.num_series, layout.series_len
    chunk = 256                 # dtw_knn's default refinement chunk
    out: dict = {"band": DTW_BAND, "queries": int(q.shape[0]), "calls": {}}
    answers = {}
    kdtw.dtw_band.launches = 0
    for k in DTW_KS:
        stats: dict = {}
        before = kdtw.dtw_band.launches
        t0 = time.perf_counter()
        d, p = dtw_knn(layout, q, k=k, band=DTW_BAND, stats=stats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = kdtw.dtw_band.launches - before
        check(launched == stats["rounds"] and launched > 0,
              f"[dtw] k={k}: {launched} dtw_band launches for {stats['rounds']} rounds")
        answers[k] = (d, p)
        out["calls"][f"k={k}"] = {"s": dt, "ms_per_query": 1e3 * dt / q.shape[0],
                                  "launches": launched, **stats}
        log(f"[dtw] dtw_knn k={k}, band {DTW_BAND}, {q.shape[0]} queries over {num} rows: "
            f"{dt:.3f}s ({1e3 * dt / q.shape[0]:.3f} ms/query); {stats['rounds']} rounds "
            f"(dtw_band launches {launched}), {stats['chunks']} chunks of {chunk} refined, "
            f"{stats['rows']} rows ({stats['rows'] / (q.shape[0] * num):.4%} of the rows a "
            f"query)")
    launches = kdtw.dtw_band.launches
    out["launches"] = launches

    # the brute force: every real row, one launch a query, a stable top-k
    rows = layout.lrd[:num]
    t0 = time.perf_counter()
    full = torch.stack([kdtw.dtw_band(qq, rows, DTW_BAND) for qq in q])
    vals, idx = torch.sort(full, dim=1, stable=True)
    torch.cuda.synchronize()
    out["brute_force_s"] = time.perf_counter() - t0
    del full
    for k in DTW_KS:
        d, p = answers[k]
        bad_d = int((words32(d) != words32(vals[:, :k])).sum())
        bad_p = int((p.long() != idx[:, :k]).sum())
        check(bad_d == 0 and bad_p == 0,
              f"[dtw] k={k}: {bad_d} dists and {bad_p} positions differ from the "
              f"brute-force dtw_band")
    log(f"[dtw] dtw_knn at k={DTW_KS}: dists bit-identical to a brute-force dtw_band over "
        f"all {num} rows (stable top-k, {out['brute_force_s']:.2f}s), positions equal")
    del vals, idx

    # every kernel the run reaches against the plain version, bit for bit
    qn = q.shape[0]
    a, cands = q[0], rows[:DTW_BITS_ROWS]
    rnd = rows[:qn * chunk].reshape(qn, chunk, n)
    late = DTW_LATE_QUERIES
    cases = [("1 x 4096", a, cands, DTW_BAND, kdtw._plan(DTW_BITS_ROWS, n, DTW_BAND)),
             ("1 x 4096", a, cands, DTW_BAND, kdtw._plan(num, n, DTW_BAND)),
             ("round", q, rnd, DTW_BAND, kdtw._plan(qn * chunk, n, DTW_BAND)),
             ("late round", q[:late], rnd[:late], DTW_BAND,
              kdtw._plan(late * chunk, n, DTW_BAND)),
             ("1 x 4096", a, cands, DTW_WIDE_BAND, kdtw._plan(DTW_BITS_ROWS, n, DTW_WIDE_BAND))]
    check(cases[1][4] == ("v2", 1) and cases[-1][4] == ("v1", 1),
          f"[dtw] the brute force and band {DTW_WIDE_BAND} plan {cases[1][4]}, {cases[-1][4]}")
    err = 0.0
    for label, qa, ca, band, plan in cases:
        got = kdtw.dtw_band_as(qa, ca, band, *plan)
        want = ref.dtw_band_ref(qa, ca, band)
        bad = int((words32(got) != words32(want)).sum())
        check(bad == 0, f"[dtw] dtw_band {plan} at {label} x {n}, band {band}: {bad} of "
                        f"{want.numel()} distances differ from dtw_band_ref on the card")
        err = max(err, float((got - want).abs().max()))
    log("[dtw] dtw_band equals dtw_band_ref bit for bit through "
        + "; ".join(f"{plan[0]} with {plan[1]} lanes at {label}, band {band}"
                    for label, _, _, band, plan in cases))
    shapes = []
    # (query, candidates, shape, band, plan, host-loop and graph reps, plain
    # reps, launches at the shape in dtw_knn): the round (the main path's
    # shape: every query a chunk; rounds with fewer queries left are
    # smaller), the bits' shape, a late round, v1 at the round, the brute
    # force (its plain version is not timed) and v1 at its band
    for qa, ca, shape, band, plan, reps, plain_reps, per_run in (
            (q, rnd, [qn, chunk, n], DTW_BAND, cases[2][4], (50, 100), 3, launches),
            (a, cands, [1, DTW_BITS_ROWS, n], DTW_BAND, cases[0][4], (50, 100), 3, 0),
            (q[:late], rnd[:late], [late, chunk, n], DTW_BAND, cases[3][4], (50, 100), 3, 0),
            (q, rnd, [qn, chunk, n], DTW_BAND, ("v1", 1), (50, 100), 0, 0),
            (a, rows, [1, num, n], DTW_BAND, ("v2", 1), (3, 3), 0, 0),
            (a, cands, [1, DTW_BITS_ROWS, n], DTW_WIDE_BAND, ("v1", 1), (10, 10), 0, 0)):
        run = lambda qa=qa, ca=ca, band=band, plan=plan: kdtw.dtw_band_as(qa, ca, band, *plan)
        nbytes, ops = dtw_cost(shape[0] * shape[1], n, band)
        r = dict(name="dtw_band", route="cuda", source="src/repro_torch/kernels/csrc/dtw.cu",
                 replaces="src/repro/core/dtw.py:53 (dtw_distance; reference code "
                          "outside Pallas, no TPU kernel)",
                 shape=shape, band=band, variant=plan[0], lanes=plan[1], launches=launches,
                 max_abs_err=err, ms=time_ms(run, reps=reps[0], warmup=2),
                 device_ms=device_ms(run, reps=reps[1]),
                 plain_ms=(time_ms(lambda qa=qa, ca=ca, band=band:
                                   ref.dtw_band_ref(qa, ca, band), reps=plain_reps)
                           if plain_reps else None),
                 library_ms=None, bytes=nbytes, ops=ops, ops_per_s=DTW_OPS_PER_S,
                 launches_per_run=per_run)
        _bound(r)
        log_timing(r)
        log(f"[dtw] {shape}, band {band}: {plan[0]}, {plan[1]} lanes")
        shapes.append(r)
    round_ms = shapes[0]["device_ms"]
    floor = dtw_latency_ms(n)
    log(f"[dtw] the round's bound {shapes[0]['bound_ms']:.4f} ms, its latency floor "
        f"{floor:.4f} ms (2n - 1 = {2 * n - 1} dependent steps of ~8 cycles)")
    for k, call in out["calls"].items():
        call["kernel_ms"] = call["launches"] * round_ms
        call["host_ms"] = 1e3 * call["s"] - call["kernel_ms"]
        log(f"[dtw] dtw_knn {k}: {call['launches']} launches x {round_ms:.4f} ms (the "
            f"round's device time) = {call['kernel_ms']:.1f} ms of {1e3 * call['s']:.1f} ms; "
            f"the host's share {call['host_ms']:.1f} ms")
    out["shapes"] = [{k: r[k] for k in ("shape", "band", "variant", "lanes", "ms", "device_ms",
                                        "plain_ms", "bound_ms")} for r in shapes]
    out["latency_floor_ms"] = floor
    return shapes[:2], shapes[2:], out


def journal_rows(num: int) -> int:
    """Rows of each of the store phase's two journal segments: 1/32 of the
    base, so 2 x 131,072 = 2**18 rows (6.25%) at the full 2**22."""
    return max(num // 32, 1)


JOURNAL_SEEDS = (7, 8)          # the segments' draws; phase 4 draws seeds 0, 1, 5, 6
JOURNAL_CHUNKS = (1 << 16, 8192)  # append chunk sizes: large, the default
STORE_JOURNAL_QUERIES = 28


def phase_store(hx, data, queries, summary):
    """The store's mutation path on phase 5's store (mode ``"a"``): two
    journal segments appended, 100 queries (phase 4's first 72, and 28 made
    from the journal rows) answered with the rows pending by ``local``,
    ``scan``, ``ooc-scan`` and ``ooc-local`` at k=1 and k=10, each held bit
    for bit against a brute-force difference-form scan over A||J on the
    card; plan invalidation on every append; then ``compact()`` to
    generation 1, held against a one-shot in-memory build over A||J (tree,
    layout, LRD, LSD bit for bit), the old generation and the journal swept,
    a handle to the old generation loud, and the answers after compaction
    equal to those before it. The four kNN kernels must launch in this
    phase. Returns the phase's summary."""
    import numpy as np
    import torch
    from repro_torch.core.engine import dense_scan_knn, make_disk_backend
    from repro_torch.core.index import HerculesIndex
    from repro_torch.data.synthetic import make_query_workload, random_walks
    from repro_torch.storage import IndexFormatError
    from repro_torch.storage import store as store_mod

    num, n = data.shape
    seg = journal_rows(num)
    out: dict = {"journal_rows": 2 * seg, "appends": [], "ms_per_query": {}}
    reset_counters()

    # the journal: two segments of random walks from seeds phase 4 does not use
    journal = [random_walks(seg, n, seed=s, device="cpu").numpy() for s in JOURNAL_SEEDS]
    j_card = torch.from_numpy(np.concatenate(journal)).cuda()
    base_q = queries[:min(72, len(queries))]
    j_q = make_query_workload(j_card, STORE_JOURNAL_QUERIES, "5%", seed=9)
    q = torch.cat([base_q, j_q])
    nq = q.shape[0]
    log(f"[store] {nq} queries: phase 4's first {base_q.shape[0]} and "
        f"{STORE_JOURNAL_QUERIES} made from the journal rows at the 5% hardness")

    # appends, each with an engine of the store in its cache that has served
    # one call: every append must invalidate it and drop it from the cache
    for i, (rows, chunk) in enumerate(zip(journal, JOURNAL_CHUNKS)):
        eng = hx.engine("ooc-local", memory_budget_mb=DISK_BUDGET_MB)
        eng.knn(q[:8], k=1)
        pc0 = eng.telemetry().plan_cache
        t0 = time.perf_counter()
        rec = hx.append(rows, chunk_size=chunk,
                        provenance={"kind": "synthetic-torch", "seed": JOURNAL_SEEDS[i],
                                    "num": seg, "length": n})
        dt = time.perf_counter() - t0
        pc = eng.telemetry().plan_cache
        d = hx.describe()
        log(f"[store] append {rec['name']}: {rec['rows']} rows in chunks of {chunk} in "
            f"{dt:.3f}s ({rec['rows'] / dt:.0f} rows/s, "
            f"{rec['rows'] * n * 4 / dt / 2**20:.1f} MiB/s of float32); the engine's "
            f"plan cache: invalidations {pc0.invalidations} -> {pc.invalidations}, "
            f"size {pc0.size} -> {pc.size}; describe {d}")
        check(pc.invalidations == pc0.invalidations + 1 and pc.size == 0,
              f"append {i}: the cached engine was not invalidated")
        check(hx.engine("ooc-local", memory_budget_mb=DISK_BUDGET_MB) is not eng,
              f"append {i}: the store kept serving its old engine")
        check(d["pending_rows"] == (i + 1) * seg and d["journal_segments"] == i + 1,
              f"append {i}: describe() shows {d}")
        out["appends"].append({"rows": rec["rows"], "chunk": chunk, "s": dt,
                               "rows_per_s": rec["rows"] / dt})
        del eng

    # the oracle: a brute-force difference-form scan over A||J on the card
    aj = torch.cat([data, j_card])
    del j_card
    t0 = time.perf_counter()
    ref_d, ref_p = dense_scan_knn(aj, q, k=10)
    torch.cuda.synchronize()
    log(f"[store] brute-force difference-form scan over A||J ({aj.shape[0]} rows): "
        f"{time.perf_counter() - t0:.2f}s")

    backends = ("local", "scan", "ooc-scan", "ooc-local", "dist-ooc")

    def shards_of(name) -> dict:
        return {"shards": SHARDS} if name == "dist-ooc" else {}

    def timed_call(fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, 1e3 * (time.perf_counter() - t0) / nq

    def made_engine(name):
        t0 = time.perf_counter()
        eng = hx.engine(name, memory_budget_mb=DISK_BUDGET_MB, **shards_of(name))
        log(f"[store] {name} engine over generation {hx.generation} made in "
            f"{time.perf_counter() - t0:.2f}s")
        return eng

    before_compact = {}
    for name in backends:
        eng = made_engine(name)
        for k in (1, 10):
            # the base alone on the same engine, then the call with the
            # journal merged: their difference is the merge's cost
            _, base_ms = timed_call(lambda: eng.knn(q, k=k))
            res, ms = timed_call(
                lambda: hx.query(q, k, backend=name, memory_budget_mb=DISK_BUDGET_MB,
                                 **shards_of(name)))
            tag = f"{name} k={k}"
            out["ms_per_query"][f"{tag} base only"] = base_ms
            want_d, want_p = ref_d[:, :k], ref_p[:, :k]
            check(torch.equal(res.dists, want_d),
                  f"[store] {tag}: merged dists are not bit-identical to the scan over "
                  f"A||J ({int((res.dists != want_d).sum())} entries)")
            check(torch.equal(res.ids.long(), want_p.long()),
                  f"[store] {tag}: merged ids differ from the scan over A||J "
                  f"({int((res.ids.long() != want_p.long()).sum())} entries)")
            in_j = res.ids >= num
            check(bool((res.positions[in_j] == -1).all())
                  and bool((res.positions[~in_j] >= 0).all()),
                  f"[store] {tag}: journal hits must carry position -1, base hits >= 0")
            hits = int(in_j[base_q.shape[0]:, 0].sum())
            if k == 1:
                check(hits >= STORE_JOURNAL_QUERIES // 2,
                      f"[store] {tag}: only {hits} of the {STORE_JOURNAL_QUERIES} "
                      f"journal-made queries found their nearest neighbour in the journal")
            before_compact[(name, k)] = res
            out["ms_per_query"][tag] = ms
            log(f"[store] {tag} with {2 * seg} rows pending: {ms:.3f} ms/query, the "
                f"base alone {base_ms:.3f} (merge {ms - base_ms:+.3f}); "
                f"{int(in_j.sum())} journal hits ({hits} first neighbours of the "
                f"journal-made queries); dists bit-identical to the scan over A||J, "
                f"ids equal")
        del eng

    # compaction to generation 1, with the reads of _BaseRows' id-order copy
    # of the base timed (on the reader thread, beside the build)
    old = hx.saved
    stale = make_disk_backend("ooc-scan", hx, memory_budget_mb=DISK_BUDGET_MB)
    gather = {"s": 0.0, "rows": 0, "calls": 0}
    getitem = store_mod._BaseRows.__getitem__

    def timed_getitem(self, sl):
        t0 = time.perf_counter()
        rows = getitem(self, sl)
        gather["s"] += time.perf_counter() - t0
        gather["rows"] += rows.shape[0]
        gather["calls"] += 1
        return rows

    gen0_files = sorted(os.listdir(hx.path))
    store_mod._BaseRows.__getitem__ = timed_getitem
    try:
        t0 = time.perf_counter()
        manifest = hx.compact(chunk_size=1 << 18)
        compact_s = time.perf_counter() - t0
    finally:
        store_mod._BaseRows.__getitem__ = getitem
    b = manifest["extra"]["build"]
    stage_s = manifest["extra"]["compact"]["stage_seconds"]
    out.update(compact_s=compact_s, tree_s=b["tree_seconds"], write_s=b["write_seconds"],
               stage_s=stage_s, gather_s=gather["s"], gather_rows=gather["rows"],
               gather_calls=gather["calls"])
    log(f"[store] compacted {2 * seg} journal rows into generation {hx.generation} in "
        f"{compact_s:.2f}s: the base staged in id order in {stage_s:.2f}s, tree_seconds "
        f"{b['tree_seconds']}, write_seconds {b['write_seconds']} (chunks of "
        f"{b['chunk_size']}, prefetch {b['prefetch']}); _BaseRows read {gather['rows']} "
        f"base rows of the staged copy in {gather['calls']} slices in {gather['s']:.2f}s "
        f"({gather['rows'] / max(gather['s'], 1e-9):.0f} rows/s, "
        f"{gather['rows'] / num:.1f} passes over the base)")
    files = sorted(os.listdir(hx.path))
    log(f"[store] files before: {gen0_files}; after: {files}")
    check(hx.generation == 1 and hx.pending_rows == 0 and hx.base_rows == num + 2 * seg,
          f"[store] after compact: {hx.describe()}")
    check(not os.listdir(os.path.join(hx.path, "journal")),
          "[store] the journal segments were not swept")
    check(not {"lrd.npy", "enc.npy", "lsd.npy", "tree.npz", "layout.npz"} & set(files),
          "[store] generation 0's files were not swept")
    check(old.closed, "[store] the old generation's handle is still open")
    for what, fn in (("SavedIndex", lambda: old._mapped("lrd")),
                     ("ooc-scan backend", lambda: stale.knn(q[:1], k=1))):
        try:
            fn()
        except IndexFormatError as e:
            log(f"[store] the old generation's {what} raises IndexFormatError: {e}")
        else:
            fail(f"[store] the old generation's {what} did not raise")
    del old, stale

    # the one-shot build over A||J on the card, held to the compacted files
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one = HerculesIndex.build(aj, hx.config)
    torch.cuda.synchronize()
    out["oneshot_build_s"] = time.perf_counter() - t0
    out["oneshot_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    saved = hx.saved
    for field in one.tree._fields:
        check(torch.equal(getattr(saved.tree, field), getattr(one.tree, field).cpu()),
              f"[store] compacted tree field {field} differs from the one-shot build")
    for field, arr in saved.small.items():
        check(np.array_equal(arr, getattr(one.layout, field).cpu().numpy()),
              f"[store] compacted layout field {field} differs from the one-shot build")
    for field in ("series_len", "max_leaf", "num_leaves", "num_series"):
        check(getattr(saved, field) == getattr(one.layout, field),
              f"[store] compacted {field} differs from the one-shot build")
    for field in ("lrd", "lsd"):
        mapped, mem = saved._mapped(field), getattr(one.layout, field)
        check(mapped.shape == tuple(mem.shape), f"[store] {field} shapes differ")
        for lo in range(0, mapped.shape[0], 1 << 18):
            blk = torch.from_numpy(np.array(mapped[lo:lo + (1 << 18)])).cuda()
            check(torch.equal(blk, mem[lo:lo + (1 << 18)]),
                  f"[store] compacted {field} rows {lo}.. differ from the one-shot build")
    log(f"[store] the compacted tree, layout, LRD and LSD equal the one-shot build over "
        f"A||J bit for bit (one-shot build {out['oneshot_build_s']:.2f}s, peak device "
        f"memory {out['oneshot_peak_gib']:.2f} GiB)")
    del one, aj, saved

    for name in backends:
        made_engine(name)
        for k in (1, 10):
            res, ms = timed_call(
                lambda: hx.query(q, k, backend=name, memory_budget_mb=DISK_BUDGET_MB,
                                 **shards_of(name)))
            want = before_compact[(name, k)]
            check(torch.equal(res.dists, want.dists) and torch.equal(res.ids, want.ids),
                  f"[store] {name} k={k}: the answers after compaction differ from "
                  f"the merged answers before it")
            check(bool((res.positions >= 0).all()),
                  f"[store] {name} k={k}: a position after compaction is negative")
            out["ms_per_query"][f"{name} k={k} compacted"] = ms
    log("[store] after compaction every backend's answers equal the merged answers "
        "before it (dists bit-identical, ids equal, positions >= 0): ms/query "
        + ", ".join(f"{t} {v:.3f}" for t, v in out["ms_per_query"].items()
                    if t.endswith("compacted")))

    launches = read_counters()
    out["launches"] = launches
    log(f"[store] kernel launches during the store phase: {launches}")
    for kname, count in launches.items():
        check(count > 0, f"store path: {kname} was never launched")
    ref = {"local": "local_k{}", "scan": "scan_k{}"}
    for name in backends:
        for k in (1, 10):
            if name in ref:
                was = summary["ms_per_query"][ref[name].format(k)]
            else:
                streamed = "ooc-local" if name == "dist-ooc" else name
                was = summary["disk"]["calls"][f"{streamed} bf16 k={k} thread"]["ms_per_query"]
            now = out["ms_per_query"][f"{name} k={k}"]
            log(f"[store] {name} k={k}: {now:.3f} ms/query with the journal merged against "
                f"{was:.3f} ms/query in phase {4 if name in ref else 5} ({now - was:+.3f}; "
                f"the same engine without the merge: "
                f"{out['ms_per_query'][f'{name} k={k} base only']:.3f})")
    return out


def phase_disk_kernels(queries, blocks, launches):
    """``decode_bf16_ed_matrix`` at the out-of-core scan's shape (the query
    bucket against one streamed 131,072-row bf16 block, read in place at its
    row pitch) and at ``ooc-local``'s (4096 rows of it, a leaf padded to
    ``max_leaf``), against its plain version, the library call, a float64
    evaluation and the ed_min witness; then ``lb_sax_matrix`` (``ooc-local``'s
    LSD filter of one block, also timed by a CUDA graph) and ``ed_min`` at
    the out-of-core shapes, against their plain versions (times logged, for
    PERF.md). Returns (the kernel's row, the rows of other shapes)."""
    import torch
    from repro_torch.core import summaries as S
    from repro_torch.kernels import ed as ked, lb_sax as klb, ref

    enc, lsd, lrd = blocks
    bucket = 1 << (queries.shape[0] - 1).bit_length()
    qb = torch.cat([queries, queries.new_zeros((bucket - queries.shape[0],
                                                queries.shape[1]))])
    num, width = enc.shape
    n = (width - 4) // 2
    payload = enc[:, :-4]
    check(payload.stride() == (width, 1), "the payload is not a strided view of enc")
    bits = payload.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    decoded = ref.decode_bf16_ref(payload)
    check(torch.equal(decoded, (bits << 16).view(torch.float32)),
          "decode_bf16_ref: decoded values are not the exact bf16 widening")
    del bits
    got, sn = ked.decode_bf16_ed_matrix(qb, payload)
    q64, r64 = qb.double(), decoded.double()
    exact = (q64 * q64).sum(1)[:, None] + (r64 * r64).sum(1)[None, :] - 2.0 * (q64 @ r64.T)
    scale = (q64 * q64).sum(1)[:, None] + (r64 * r64).sum(1)[None, :]
    ratio = float(((got.double() - exact).abs() / scale).max())
    del exact, scale, r64, got, sn
    log(f"[timing] decode_bf16_ed_matrix soundness: max |d_kernel - d_f64| / "
        f"(|q|^2 + |s^|^2) = {ratio:.3e} (limit 1e-5)")
    check(ratio <= 1e-5, f"decode_bf16_ed_matrix: error ratio {ratio:.3e} > 1e-5")
    row, shapes = None, []
    for num_rows in (num, min(num, 4096)):
        view = payload[:num_rows]
        big = num_rows == num
        got, sn = ked.decode_bf16_ed_matrix(qb, view)
        err = assert_close(got, ref.decode_bf16_ed_matrix_ref(qb, view), "float32",
                           f"decode_bf16_ed_matrix {bucket}x{num_rows}")
        del got, sn
        hold_witness(qb, None, view, f"{bucket}x{num_rows}x{n}")
        lib = lambda: torch.cdist(qb, view.view(torch.bfloat16).float(),
                                  compute_mode="use_mm_for_euclid_dist").square()
        r = dict(
            name="decode_bf16_ed_matrix", route="cuda",
            source="src/repro_torch/kernels/csrc/ed.cu",
            replaces="src/repro/kernels/ops.py:106",
            shape=[bucket, num_rows, n], launches=launches["decode_bf16_ed_matrix"],
            max_abs_err=err, soundness_ratio=ratio,
            ms=time_ms(lambda: ked.decode_bf16_ed_matrix(qb, view),
                       reps=20 if big else 200, warmup=2),
            device_ms=device_ms(lambda: ked.decode_bf16_ed_matrix(qb, view),
                                reps=40 if big else 500),
            plain_ms=time_ms(lambda: ref.decode_bf16_ed_matrix_ref(qb, view), reps=2),
            library_ms=time_ms(lib, reps=10 if big else 50, warmup=2),
            bytes=qb.numel() * 4 + view.numel() + bucket * num_rows * 4 + num_rows * 4,
            ops=2 * bucket * num_rows * n)
        _bound(r)
        log_timing(r)
        if big:
            row = r
        else:
            shapes.append(r)
    log(f"[witness] decode_bf16_ed_matrix row minima and first argmins equal ed_min's "
        f"(bf16) at {bucket}x{num}x{n} and {bucket}x{min(num, 4096)}x{n}")

    # the slice-1 kernels at the shapes the out-of-core path gives them,
    # held against their plain versions there and timed
    q_paa = S.paa(qb, lsd.shape[1])
    got = klb.lb_sax_matrix(q_paa, lsd, n)
    want = ref.lb_sax_matrix_ref(q_paa, lsd, n)
    assert_close(got, want, "float32", "lb_sax ooc shape")
    check(torch.equal(got, want), "lb_sax ooc shape: bits differ")
    del got, want
    lb_row = dict(name="lb_sax_matrix", shape=[bucket, lsd.shape[0], lsd.shape[1]],
                  ms=time_ms(lambda: klb.lb_sax_matrix(q_paa, lsd, n), reps=20, warmup=2),
                  device_ms=device_ms(lambda: klb.lb_sax_matrix(q_paa, lsd, n), reps=100),
                  plain_ms=time_ms(lambda: ref.lb_sax_matrix_ref(q_paa, lsd, n), reps=2),
                  library_ms=None,
                  bytes=q_paa.numel() * 4 + lsd.numel() + bucket * lsd.shape[0] * 4,
                  ops=bucket * lsd.shape[0] * (6 * lsd.shape[1] + 1))
    shapes.append(lb_row)
    dmin, amin = ked.ed_min(qb, lrd, valid_n=lrd.shape[0])
    d_ref = ref.ed_matrix_ref(qb, lrd)
    want_d, want_a = torch.min(d_ref, dim=1)
    err = assert_close(dmin, want_d, "float32", "ed_min ooc shape")
    dec = decisive_rows(d_ref)
    dec[queries.shape[0]:] = False          # bucket padding rows tie everywhere
    check(torch.equal(amin[dec].long(), want_a[dec]), "ed_min ooc shape: argmin differs")
    del d_ref
    hold_fma_bits(qb, lrd, f"ooc shape {bucket}x{lrd.shape[0]}x{n}")
    hold_fma_bits(qb, payload.contiguous().view(torch.bfloat16),
                  f"bf16 ooc shape {bucket}x{num}x{n}")
    check(torch.equal(ked.decode_bf16_ed_matrix(qb, payload)[0].view(torch.int32),
                      ref.ed_matrix_fma_ref(qb, decoded).view(torch.int32)),
          "decode_bf16_ed_matrix ooc shape: outputs differ from ed_matrix_fma_ref")
    log(f"[fma] ed_min and ed_matrix over a {lrd.shape[0]}-row LRD block and its bf16 "
        f"encoding, and decode_bf16_ed_matrix: equal the fma references bit for bit")
    min_row = ed_min_row(qb, lrd, launches["ed_min"], err, reps=20, device_reps=40,
                         plain_reps=2, library_reps=10)
    for r in (lb_row, min_row):
        _bound(r)
    log_timing(lb_row)
    log_timing(min_row)
    return row, min_row, shapes


def _bound(r: dict) -> None:
    t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = r["ops"] / r.get("ops_per_s", FP32_FLOPS) * 1e3
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def phase_kernel_timing(data, queries, local, launches, wave_launches, shard_lb):
    """The kernels line's rows at the main path's shapes, and apart the
    ``ed_matrix`` shape of an out-of-core block; ``wave_launches`` maps a wave's query rows to
    the ``lb_sax_matrix`` launches of phase 6 at that shape, ``shard_lb`` is (a shard's
    padded rows, the ``lb_sax_matrix`` launches of phase 7's ``sharded`` calls)."""
    import torch
    from repro_torch.core import summaries as S
    from repro_torch.kernels import ed as ked, lb_sax as klb, ref

    rows = []
    bucket = 1 << (queries.shape[0] - 1).bit_length()
    qb = torch.cat([queries, queries.new_zeros((bucket - queries.shape[0],
                                                queries.shape[1]))])
    num, n = data.shape

    # lb_sax_matrix: one query row against the whole LSD sidecar (phase 3),
    # and against one shard's (phase 7's sharded calls; the sidecar's first
    # rows stand in for a shard's: the same shape and the same work)
    lsd_all = local.index.layout.lsd
    m = lsd_all.shape[1]
    q_paa = S.paa(queries[:1], m)
    for lsd, count, tag in ((lsd_all, launches["lb_sax_matrix"], "main"),
                            (lsd_all[:shard_lb[0]], shard_lb[1], "shard")):
        got = klb.lb_sax_matrix(q_paa, lsd, n)
        want = ref.lb_sax_matrix_ref(q_paa, lsd, n)
        err = assert_close(got, want, "float32", f"lb_sax {tag} shape")
        check(torch.equal(got, want), f"lb_sax {tag} shape: bits differ")
        rows.append(dict(
            name="lb_sax_matrix", route="cuda",
            source="src/repro_torch/kernels/csrc/lb_sax.cu",
            replaces="src/repro/kernels/lb_sax.py:69",
            shape=[1, lsd.shape[0], m], launches=count, max_abs_err=err,
            ms=time_ms(lambda: klb.lb_sax_matrix(q_paa, lsd, n), reps=50, warmup=3),
            device_ms=device_ms(lambda: klb.lb_sax_matrix(q_paa, lsd, n), reps=200),
            plain_ms=time_ms(lambda: ref.lb_sax_matrix_ref(q_paa, lsd, n), reps=5),
            library_ms=None,
            bytes=q_paa.numel() * 4 + lsd.numel() + 2 * 256 * 4 + got.numel() * 4,
            ops=got.numel() * (6 * m + 1)))
    lsd = lsd_all

    # lb_sax_matrix: a wave's phase 3, the wave's PAA matrix against the
    # whole LSD sidecar in one launch a wave call: the query bucket's (phase
    # 6's local wave calls) and the 32 slots' (its local serving run)
    for q_rows, tag in ((bucket, "wave"), (SERVE_SLOTS, "serving wave")):
        q_paa = S.paa(qb[:q_rows], m)
        got = klb.lb_sax_matrix(q_paa, lsd, n)
        want = ref.lb_sax_matrix_ref(q_paa, lsd, n)
        err = assert_close(got, want, "float32", f"lb_sax {tag} shape")
        check(torch.equal(got, want), f"lb_sax {tag} shape: bits differ")
        del got, want
        rows.append(dict(
            name="lb_sax_matrix", route="cuda",
            source="src/repro_torch/kernels/csrc/lb_sax.cu",
            replaces="src/repro/kernels/lb_sax.py:69",
            shape=[q_rows, lsd.shape[0], m], launches=wave_launches[q_rows],
            max_abs_err=err,
            ms=time_ms(lambda: klb.lb_sax_matrix(q_paa, lsd, n), reps=10, warmup=2),
            device_ms=device_ms(lambda: klb.lb_sax_matrix(q_paa, lsd, n), reps=10),
            plain_ms=time_ms(lambda: ref.lb_sax_matrix_ref(q_paa, lsd, n), reps=2),
            library_ms=None,
            bytes=q_paa.numel() * 4 + lsd.numel() + q_rows * lsd.shape[0] * 4,
            ops=q_rows * lsd.shape[0] * (6 * m + 1)))

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
    t0 = time.perf_counter()
    hold_fma_bits(qb, data, f"{bucket}x{num}x{n}", matrix=False)
    log(f"[fma] ed_min {bucket}x{num}x{n}: distances and indices equal ed_min_fma_ref bit "
        f"for bit (reference {time.perf_counter() - t0:.1f}s)")
    rows.append(ed_min_row(qb, data, launches["ed_min"], err, reps=5, device_reps=5,
                           plain_reps=1, library_reps=3))

    # ed_matrix: the k>1 scan's shape (the query bucket against one 4096-row
    # scan block; ooc-scan raw k>1 folds the same), and 131,072 rows (an
    # out-of-core block's worth). ms is the host loop's time, as in every
    # row, device_ms a CUDA graph's of back-to-back launches; the ed_min
    # witness holds at both
    extra = []
    for num_rows in (4096, 1 << 17):
        blk = data[:num_rows]
        small = num_rows == 4096
        got = ked.ed_matrix(qb, blk)
        err = assert_close(got, ref.ed_matrix_ref(qb, blk), "float32",
                           f"ed_matrix {bucket}x{num_rows}")
        del got
        hold_witness(qb, blk, None, f"{bucket}x{num_rows}x{n}")
        if not small:
            hold_fma_bits(qb, blk, f"{bucket}x{num_rows}x{n}")
            hold_fma_bits(qb, blk.to(torch.bfloat16), f"bf16 {bucket}x{num_rows}x{n}")
            log(f"[fma] ed_matrix (f32, bf16) and ed_min {bucket}x{num_rows}x{n}: equal "
                f"the fma references bit for bit")
        lib_mat = lambda: torch.cdist(qb, blk, compute_mode="use_mm_for_euclid_dist").square()
        (rows if small else extra).append(dict(
            name="ed_matrix", route="cuda", source="src/repro_torch/kernels/csrc/ed.cu",
            replaces="src/repro/kernels/ed.py:110", shape=[bucket, num_rows, n],
            launches=launches["ed_matrix"] if small else 0, max_abs_err=err,
            ms=time_ms(lambda: ked.ed_matrix(qb, blk), reps=200 if small else 20,
                       warmup=5),
            device_ms=device_ms(lambda: ked.ed_matrix(qb, blk), reps=500 if small else 40),
            plain_ms=time_ms(lambda: ref.ed_matrix_ref(qb, blk), reps=10 if small else 2),
            library_ms=time_ms(lib_mat, reps=50 if small else 10, warmup=3),
            bytes=(qb.numel() + blk.numel() + bucket * num_rows) * 4,
            ops=2 * bucket * num_rows * n))
    log(f"[witness] ed_matrix (f32, bf16) row minima and first argmins equal ed_min's at "
        f"{bucket}x4096x{n} and {bucket}x{1 << 17}x{n}")

    for r in rows + extra:
        _bound(r)
        log_timing(r)
    return rows, extra


def ed_min_row(qb, series, launches: int, err: float, reps: int, device_reps: int,
               plain_reps: int, library_reps: int) -> dict:
    """A kernels-line row of ``ed_min`` over all of ``series`` (float32):
    host-loop, CUDA-graph, plain-version and library (``cdist(...).square()
    .min(1)``) times, and the bytes and operations of its bound."""
    import torch
    from repro_torch.kernels import ed as ked, ref

    num, n = series.shape
    run = lambda: ked.ed_min(qb, series, valid_n=num)
    lib = lambda: torch.cdist(qb, series, compute_mode="use_mm_for_euclid_dist").square().min(1)
    return dict(
        name="ed_min", route="cuda", source="src/repro_torch/kernels/csrc/ed.cu",
        replaces="src/repro/kernels/ed.py:141", shape=[qb.shape[0], num, n],
        launches=launches, max_abs_err=err,
        ms=time_ms(run, reps=reps, warmup=2), device_ms=device_ms(run, reps=device_reps),
        plain_ms=time_ms(lambda: ref.ed_min_ref(qb, series, valid_n=num), reps=plain_reps),
        library_ms=time_ms(lib, reps=library_reps, warmup=1),
        bytes=(qb.numel() + series.numel()) * 4 + qb.shape[0] * 8,
        ops=2 * qb.shape[0] * num * n)


def log_timing(r: dict) -> None:
    dev = f" (device {r['device_ms']:.4f} ms)" if "device_ms" in r else ""
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    plain = "not measured" if r["plain_ms"] is None else f"{r['plain_ms']:.4f} ms"
    log(f"[timing] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms{dev}, plain "
        f"{plain}, library {lib}, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}: {r['bytes']} B, {r['ops']} ops); the kernel at "
        f"{r['bound_ms'] / r['ms']:.1%} of the bound")


def phase_profile(data, queries, local):
    """Opt-in (``--profile``): trace 16 queries per backend with
    torch.profiler and report wall time, summed device-kernel time (one
    stream, so kernels do not overlap), the device idle share and the
    operators that hold the device longest."""
    from repro_torch.core.engine import QueryEngine, make_backend

    q = queries[:16]
    for name, backend, k in (("local", local, 1), ("local", local, 10),
                             ("scan", make_backend("scan", data), 1),
                             ("scan", make_backend("scan", data), 10)):
        eng = QueryEngine(backend)
        eng.knn(q, k=k)
        trace(f"{name} k={k}, 16 queries", lambda: eng.knn(q, k=k))


def trace(label: str, run) -> None:
    """Trace one call of ``run`` with torch.profiler: wall time, summed
    device time of the kernels (one compute stream, so they do not overlap)
    and of the copies (a side stream; they may overlap the kernels), the
    device idle share and the operations that hold the device longest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e for e in events if "memcpy" in e.name.lower()]
    kernels = [e for e in events if "memcpy" not in e.name.lower()]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    copy_ms = sum(e.time_range.elapsed_us() for e in copies) / 1e3
    by_name: dict = {}
    for e in events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"[profile] {label}: wall {wall_ms:.2f} ms, kernels busy {busy_ms:.2f} ms, "
        f"copies {copy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
        f"{len(kernels)} kernel launches, {len(copies)} copies")
    for kname, (t, c) in top:
        log(f"[profile]   {t:9.3f} ms {c:6d}x  {kname[:110]}")


def phase_cpu_agreement():
    """The card's answers equal the CPU's on a small input, bit for bit for
    the index (same arithmetic on both devices) and by ids for the scans."""
    import numpy as np
    import torch
    from repro_torch.core.dtw import dtw_knn
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
    res, trees, dtw = {}, {}, {}
    for dev in ("cpu", "cuda"):
        for name in ("local", "scan"):
            backend = make_backend(name, x, index_config=icfg, device=dev)
            if name == "local":
                trees[dev] = backend.index.tree
                dtw[dev] = dtw_knn(backend.index.layout, torch.from_numpy(q), k=3,
                                   band=DTW_BAND)
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
    for a, b, what in zip(dtw["cpu"], dtw["cuda"], ("dists", "positions")):
        check(torch.equal(words32(a), words32(b.cpu())),
              f"dtw_knn on the card: {what} differ from the CPU's")
    log("[agree] 8192 x 256, 16 queries, k in (1, 5): the card builds the CPU's tree "
        "bit for bit; its local answers equal the CPU's in every field; scan ids and "
        f"dists equal; dtw_knn (k=3, band {DTW_BAND}) dists and positions equal the "
        "CPU's bit for bit")


# ---------------------------------------------------------------------------
# LM serving: rwkv6-7b and the wkv6 kernel
# ---------------------------------------------------------------------------

LM_REQUESTS, LM_PROMPT, LM_NEW, LM_SLOTS = 8, 512, 32, 4
# The depth each LM is served at where it is cut, at full width, for the
# run's time; serving depth is the first thing ROADMAP.md allows to be cut.
# rwkv6-7b (phase 12) went to 16 of 32 layers when phases 22-26 brought the
# run within 60 s of its 1,200 s limit, then to 8, with minicpm-2b (phase
# 14) at 20 of 40 and granite-moe-1b-a400m (phase 17) at 12 of 24, when
# phases 27-29 took it past 1,080 s. Their training phases keep every layer.
SERVE_DEPTH = {"rwkv6-7b": 8, "minicpm-2b": 20, "granite-moe-1b-a400m": 12}


def _served(cfg):
    """``cfg`` at the depth it is served at (``SERVE_DEPTH``)."""
    import dataclasses
    return dataclasses.replace(cfg, num_layers=SERVE_DEPTH.get(cfg.name, cfg.num_layers))


# the warm-up request before each timed serving run (cuBLAS set-up, the
# weights' compute-dtype copies) decodes this many tokens: a prefill and a
# decode step see every shape the timed run does
WARM_NEW = 2
# A wave and a request alone run other matmul shapes, so their bf16
# activations round differently, and 32 layers of random weights amplify
# that: bf16 first-token logits of a wave and of its requests alone differ
# by up to 0.97 (one H100), beyond every top-2 margin at random weights, so
# no bf16 first token could be held. The serving logic is held in float32
# with the same weights, where the gap was 5e-4: the logits of a wave and
# of each request alone agree within F32_LOGIT_TOL, and the first tokens the
# engine serves equal the solo ones wherever the solo top-2 margin exceeds
# twice it (a flip needs a margin under twice the gap).
F32_LOGIT_TOL = 5e-3


def _wkv_inputs(g, b, t, h, dk, dv, dtype=None):
    """r, k, v (in ``dtype``, default float32), w, u, a nonzero state."""
    import torch
    dev = torch.device("cuda")

    def n(*shape):
        return torch.randn(shape, generator=g, device=dev)

    r, k, v = n(b, t, h, dk), n(b, t, h, dk), n(b, t, h, dv)
    if dtype is not None:
        r, k, v = r.to(dtype), k.to(dtype), v.to(dtype)
    return r, k, v, torch.sigmoid(n(b, t, h, dk)), n(h, dk), n(b, h, dk, dv)


def _wkv_cost(b, t, h, dk, dv, esize):
    """(bytes, operations) the recurrence needs: r, k, v of ``esize``
    bytes and w float32 read once, out (``esize``) written once, u read and
    the float32 state read and written; per (b, t, h) one FMA per (i, j)
    for out (``sum_i r_i S_ij + v_j sum_i r_i u_i k_i``) and a multiply
    and an FMA per (i, j) for the update."""
    steps = b * t * h
    nbytes = (esize * steps * (2 * dk + 2 * dv) + 4 * steps * dk + 4 * h * dk
              + 2 * 4 * b * h * dk * dv)
    return nbytes, steps * (5 * dk * dv + 3 * dk + 2 * dv)


def wkv_words(x):
    """int32 words of a float32 or bf16 tensor (bf16 bits zero-extended),
    every NaN as one word -1: the card's fmaf and the reference's float64
    operations give NaNs other payloads."""
    import torch
    x = x.contiguous()
    words = x.view(torch.int32) if x.dtype == torch.float32 else \
        x.view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(torch.isnan(x.float()), torch.full_like(words, -1), words)


def hold_wkv6_bits(args, got, what: str) -> None:
    """``got``, the ``wkv6`` kernel's (out, final state) on ``args``, equals
    ``kernels/ref.py::wkv6_fma_ref`` (the kernel's fmaf chains through a
    correctly rounded fmaf) in every bit, NaNs as one word."""
    from repro_torch.kernels import ref
    for name, a, b in zip(("out", "state"), got, ref.wkv6_fma_ref(*args)):
        bad = int((wkv_words(a) != wkv_words(b)).sum())
        check(bad == 0, f"wkv6 {what}: {bad} {name} words differ from wkv6_fma_ref")


def phase_wkv6_kernel():
    """``wkv6`` against its plain version (within the tolerances) and
    against the exact fma reference (bit for bit) on the card at the LM
    path's prefill and decode shapes, with bf16 r, k, v as served and in
    float32 (phase 13's path), and on the extreme decays and the
    overflow-then-reset case; times at both shapes by the host loop and by a
    CUDA graph. Returns the kernel's row for the ``{"kernels": ...}`` line
    (its launches are filled in by the serving phase), with ``by_shape``:
    ``ms``, ``device_ms`` and bound of each timed shape."""
    import torch
    from repro_torch.kernels import ref, wkv6 as kwkv

    g = torch.Generator(device="cuda").manual_seed(13)
    shapes = {"prefill": (4, LM_PROMPT, 64, 64, 64), "decode": (4, 1, 64, 64, 64)}
    args, err = {}, {}
    for dtype in ("float32", "bfloat16"):
        for kind, shape in shapes.items():
            args[kind, dtype] = a = _wkv_inputs(g, *shape, getattr(torch, dtype))
            got = kwkv.wkv6(*a)
            want_o, want_s = ref.wkv6_ref(*a)
            check(got[0].dtype == a[0].dtype, f"wkv6 {dtype}: out is {got[0].dtype}")
            err[kind, dtype] = max(
                assert_close(got[0], want_o, dtype, f"wkv6 {kind} shape {dtype} out"),
                assert_close(got[1], want_s, "float32", f"wkv6 {kind} shape {dtype} state"))
            hold_wkv6_bits(a, got, f"{kind} shape {dtype}")
    # w == 0 at some rows of steps 40-42 only: that chunk runs the select,
    # the others the reset-free loop
    a = list(args["prefill", "bfloat16"])
    a[3] = a[3].clone()
    a[3][:, 40:43] = torch.where(torch.rand(a[3][:, 40:43].shape, generator=g, device="cuda")
                                 < 0.3, 0.0, a[3][:, 40:43])
    hold_wkv6_bits(a, kwkv.wkv6(*a), "prefill shape bf16, w == 0 in one chunk")
    # the extreme decays of tests/test_kernels.py:148-190 at a small shape
    b, t, h, dk, dv = 1, 64, 1, 4, 4
    rx, kx, vx, _, ux, sx = _wkv_inputs(g, b, t, h, dk, dv)
    cols = [torch.zeros(b, t, h), torch.ones(b, t, h), torch.full((b, t, h), 1e-38),
            torch.full((b, t, h), 1.0 - 1e-6)]
    sweeps = [torch.full((b, t, h, dk), wv, device="cuda")
              for wv in (0.0, 1e-38, 1.0 - 1e-6, 1.0)] + [torch.stack(cols, -1).cuda()]
    for wx in sweeps:
        a = (rx, kx, vx, wx, ux, sx)
        o, s = got = kwkv.wkv6(*a)
        check(bool(torch.isfinite(o).all()), "wkv6 extreme decay: non-finite output")
        wo, ws = ref.wkv6_ref(*a)
        assert_close(o, wo, "float32", "wkv6 extreme decay out")
        assert_close(s, ws, "float32", "wkv6 extreme decay state")
        hold_wkv6_bits(a, got, f"extreme decay w[0] = {float(wx.flatten()[0]):.3g}")
    kx, vx = kx[:, :24].clone(), vx[:, :24].clone()
    kx[:, :8] = 2e19
    vx[:, :8] = 2e19
    wx = torch.ones(b, 24, h, dk, device="cuda")
    wx[:, 8] = 0.0
    a = (rx[:, :24], kx, vx, wx, ux, torch.zeros_like(sx))
    o, s = got = kwkv.wkv6(*a)
    wo, ws = ref.wkv6_ref(*a)
    check(bool(torch.isfinite(o[:, 9:]).all()), "wkv6 overflow-reset: non-finite after reset")
    assert_close(o[:, 9:], wo[:, 9:], "float32", "wkv6 overflow-reset out")
    assert_close(s, ws, "float32", "wkv6 overflow-reset state")
    hold_wkv6_bits(a, got, "overflow-then-reset (every step)")
    torch.cuda.synchronize()
    by_shape = {}
    for (kind, dtype), a in args.items():
        nbytes, ops = _wkv_cost(*shapes[kind], 2 if dtype == "bfloat16" else 4)
        reps = 20 if kind == "prefill" else 200

        def run(a=a):
            return kwkv.wkv6(*a)

        by_shape[f"{kind} {dtype}"] = dict(
            shape=list(shapes[kind]), ms=time_ms(run, reps=reps, warmup=2),
            device_ms=device_ms(run, reps=reps),
            bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS))
        if kind == "decode":        # the plain version at one step (prefill's is the row's)
            by_shape[f"{kind} {dtype}"]["plain_ms"] = time_ms(
                lambda a=a: ref.wkv6_ref(*a), reps=20, warmup=2)
    served = by_shape["prefill bfloat16"]
    row = dict(
        name="wkv6", route="cuda", source="src/repro_torch/kernels/csrc/wkv6.cu",
        replaces="src/repro/kernels/wkv6.py:98", shape=served["shape"], launches=None,
        max_abs_err=err["prefill", "bfloat16"], ms=served["ms"],
        device_ms=served["device_ms"],
        plain_ms=time_ms(lambda: ref.wkv6_ref(*args["prefill", "bfloat16"]), reps=2),
        library_ms=None, by_shape=by_shape)
    row["bytes"], row["ops"] = _wkv_cost(*served["shape"], 2)
    _bound(row)
    log(f"[wkv6] agrees with its plain version at the prefill shape {shapes['prefill']} "
        f"(max abs err bf16 r/k/v {err['prefill', 'bfloat16']:.3e}, float32 "
        f"{err['prefill', 'float32']:.3e}), the decode shape {shapes['decode']}, the "
        f"extreme decays and the overflow-then-reset case, and equals wkv6_fma_ref in "
        f"every bit at all of them")
    log(f"[timing] wkv6, plain {row['plain_ms']:.4f} ms (prefill, bf16), decode "
        f"{by_shape['decode bfloat16']['plain_ms']:.4f} (bf16) / "
        f"{by_shape['decode float32']['plain_ms']:.4f} (float32), library none; "
        f"kernel host loop / device (bound): " + "; ".join(
            f"{name} {r['ms']:.4f} / {r['device_ms']:.4f} ({r['bound_ms']:.5f}, "
            f"{r['bound_ms'] / r['device_ms']:.1%})" for name, r in by_shape.items()))
    return row


def _top2_margin(logits):
    import torch
    two = torch.topk(logits, 2, dim=-1).values
    return two[..., 0] - two[..., 1]


def _first_tokens_vs_solo(model, cfg, params, toks, served):
    """Each request's first-token logits in its wave (prefilled 4 at a time)
    against the request alone, within F32_LOGIT_TOL; the first tokens
    ``served`` equal the solo argmax where the solo top-2 margin exceeds
    twice that. Returns (largest logit gap, margins, equal count, held
    count)."""
    import torch
    gaps, margins, agree, held = [], [], 0, 0
    for w0 in range(0, LM_REQUESTS, LM_SLOTS):
        wave, _ = model.prefill(params, {"tokens": toks[w0:w0 + LM_SLOTS]}, cfg,
                                model.init_cache(cfg, LM_SLOTS, LM_PROMPT))
        for i in range(w0, w0 + LM_SLOTS):
            lg, _ = model.prefill(params, {"tokens": toks[i:i + 1]}, cfg,
                                  model.init_cache(cfg, 1, LM_PROMPT))
            solo = lg[0, -1]
            check(bool(torch.isfinite(solo).all()), f"{cfg.dtype} solo logits not finite")
            gaps.append(float((solo - wave[i - w0, -1]).abs().max()))
            margins.append(float(_top2_margin(solo)))
            same = int(torch.argmax(solo)) == served[i]
            agree += same
            if margins[-1] > 2 * F32_LOGIT_TOL:
                held += 1
                check(same, f"{cfg.dtype} request {i}: first token {served[i]} differs "
                            f"from its solo run at top-2 margin {margins[-1]:.4f}")
    check(max(gaps) <= F32_LOGIT_TOL, f"{cfg.dtype} wave vs solo first-token logits "
                                      f"differ by {max(gaps):.3e} > {F32_LOGIT_TOL}")
    return max(gaps), margins, agree, held


def phase_lm_serve(profile: bool = False):
    """rwkv6-7b at full width, SERVE_DEPTH of its 32 layers, through
    ``ServeEngine``. Returns the ``wkv6`` launches of the served run and a
    summary."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import wkv6 as kwkv
    from repro_torch.models import get_model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = _served(get_config("rwkv6-7b"))
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[lm] rwkv6-7b: {cfg.num_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.d_model // cfg.rwkv_head_size} heads of "
        f"{cfg.rwkv_head_size}, {cfg.dtype} compute; {n_params} float32 parameters "
        f"({n_params * 4 / 2**30:.2f} GiB) made on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT))
    scfg = ServeConfig(max_seq=LM_PROMPT + LM_NEW + 8, batch_slots=LM_SLOTS,
                       max_new_tokens=LM_NEW)
    warm = ServeEngine(model, cfg, params, dataclasses.replace(scfg, max_new_tokens=WARM_NEW))
    warm.submit(prompts[0, :16])
    warm.run()
    eng = ServeEngine(model, cfg, params, scfg)
    rids = [eng.submit(p) for p in prompts]
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kwkv.wkv6.launches
    others = read_counters()
    tokens = sum(len(out[r]) for r in rids)
    want = cfg.num_layers * LM_NEW * (LM_REQUESTS // LM_SLOTS)
    log(f"[lm] served {len(out)} requests, {tokens} tokens in {run_s:.3f}s "
        f"({tokens / run_s:.1f} tok/s); wkv6 launches {launches} (want {want}), other kernels {others}")
    check(launches == want, f"wkv6 launched {launches} times in the served run, not {want}")
    check(all(c == 0 for c in others.values()), f"kNN kernels launched in the LM run: {others}")
    check(sorted(out) == rids and all(len(out[r]) == LM_NEW for r in rids),
          "the engine did not return LM_NEW tokens for every request")

    # the same waves again, step by step: timed, logits kept (counted apart)
    toks = torch.from_numpy(prompts.astype(np.int32)).cuda()
    prefill_ms, decode_ms = [], []
    for w0 in range(0, LM_REQUESTS, LM_SLOTS):
        batch = {"tokens": toks[w0:w0 + LM_SLOTS]}
        cache = model.init_cache(cfg, LM_SLOTS, LM_PROMPT + LM_NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.prefill(params, batch, cfg, cache)
        torch.cuda.synchronize()
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
        check(bool(torch.isfinite(lg).all()), "prefill logits are not finite")
        tok = torch.argmax(lg[:, -1], dim=-1)
        seq = [tok]
        for _ in range(LM_NEW - 1):
            t0 = time.perf_counter()
            lg, cache = model.decode_step(params, tok[:, None].to(torch.int32), cfg, cache)
            tok = torch.argmax(lg[:, 0], dim=-1)
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t0))
            check(bool(torch.isfinite(lg).all()), "decode logits are not finite")
            seq.append(tok)
        again = torch.stack(seq, 1).tolist()
        check(again == [out[r] for r in rids[w0:w0 + LM_SLOTS]],
              f"the wave at {w0} driven step by step differs from the engine's tokens")
    dec_sorted = sorted(decode_ms)
    log(f"[lm] prefill of a 4 x {LM_PROMPT} wave: {prefill_ms[0]:.2f} / {prefill_ms[1]:.2f} ms; "
        f"decode step (4 rows): median {dec_sorted[len(dec_sorted) // 2]:.3f} ms, min "
        f"{dec_sorted[0]:.3f}, max {dec_sorted[-1]:.3f} over {len(decode_ms)} steps; "
        f"every logit finite; step-by-step tokens equal the engine's")

    # the same requests served in float32 with the same weights, one token
    # each, against each request alone (counted apart)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    eng32 = ServeEngine(model, cfg32, params,
                        ServeConfig(max_seq=LM_PROMPT + 8, batch_slots=LM_SLOTS,
                                    max_new_tokens=1))
    rids32 = [eng32.submit(p) for p in prompts]
    out32 = eng32.run()
    gap32, margins32, agree32, held32 = _first_tokens_vs_solo(
        model, cfg32, params, toks, [out32[r][0] for r in rids32])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[lm] float32 (same weights), first token served in its wave vs the request "
        f"alone: logit gap {gap32:.3e} (limit {F32_LOGIT_TOL}), top-2 margins "
        f"{[round(x, 4) for x in margins32]}, first tokens equal in {agree32} of "
        f"{LM_REQUESTS}, {held32} held (margin > {2 * F32_LOGIT_TOL}); peak device "
        f"memory {peak:.2f} GiB")
    if profile:
        cache = model.init_cache(cfg, LM_SLOTS, LM_PROMPT + 2)
        batch = {"tokens": toks[:LM_SLOTS]}
        lg, cache = model.prefill(params, batch, cfg, cache)
        trace(f"rwkv6-7b prefill of a 4 x {LM_PROMPT} wave",
              lambda: model.prefill(params, batch, cfg, model.init_cache(cfg, LM_SLOTS, 0)))
        step = torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)
        trace("rwkv6-7b decode step, 4 rows", lambda: model.decode_step(params, step, cfg, cache))
    summary = {"run_s": run_s, "tok_per_s": tokens / run_s, "prefill_ms": prefill_ms,
               "decode_ms_median": dec_sorted[len(dec_sorted) // 2], "peak_gib": peak,
               "first_token_logit_gap_f32": gap32,
               "wkv6_launches": launches,
               "wkv6_prefill_launches": cfg.num_layers * (LM_REQUESTS // LM_SLOTS)}
    return launches, summary


def phase_lm_cpu_agreement():
    """Full width, 2 layers, float32, the same weights on the card (the
    wkv6 kernel) and on the CPU (its plain version): a 64-token prefill and
    4 decode steps give logits within 1e-4 and the same greedy tokens."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_config("rwkv6-7b"), num_layers=2, dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(1), cfg)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 64)).astype(np.int32))
    runs = {}
    for dev in ("cuda", "cpu"):
        params.to(dev)
        t0 = time.perf_counter()
        lg, cache = model.prefill(params, {"tokens": prompt.to(dev)}, cfg,
                                  model.init_cache(cfg, 1, 72, dev))
        logits, toks = [lg[0, -1].cpu()], [int(torch.argmax(lg[0, -1]))]
        for _ in range(4):
            lg, cache = model.decode_step(
                params, torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev), cfg, cache)
            logits.append(lg[0, 0].cpu())
            toks.append(int(torch.argmax(lg[0, 0])))
        runs[dev] = (torch.stack(logits), toks, time.perf_counter() - t0)
    err = assert_close(runs["cuda"][0], runs["cpu"][0], "float32",
                       "rwkv6 full width, 2 layers: card vs CPU logits")
    check(runs["cuda"][1] == runs["cpu"][1],
          f"rwkv6 card tokens {runs['cuda'][1]} differ from the CPU's {runs['cpu'][1]}")
    log(f"[lm-agree] full width, 2 layers, float32: the card's logits are within 1e-4 of "
        f"the CPU's (max abs err {err:.3e}) over a 64-token prefill and 4 decode steps; "
        f"tokens equal {runs['cuda'][1]} (card {runs['cuda'][2]:.2f}s, CPU "
        f"{runs['cpu'][2]:.2f}s)")


DENSE_ARCH = "minicpm-2b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 6
# minicpm's schedule (WSD), at its peak rate from the first step: warmup 1
# (the default 100 would leave these steps at under 6% of the rate), the
# decay beyond total_steps
TRAIN_OPT = dict(learning_rate=3e-4, warmup_steps=1, total_steps=1000, schedule="wsd")


def _all_launches() -> dict:
    from repro_torch.kernels import dtw as kdtw, rg_lru as krg, wkv6 as kwkv
    return {**read_counters(), "wkv6": kwkv.wkv6.launches, "dtw_band": kdtw.dtw_band.launches,
            "rg_lru_scan": krg.rg_lru_scan.launches, "wkv6_bwd": kwkv.wkv6_bwd.launches,
            "rg_lru_scan_bwd": krg.rg_lru_scan_bwd.launches}


def _rg_key(variant: str, shape) -> str:
    return f"{variant} {'x'.join(map(str, shape))}"


def _rg_launches_by() -> dict:
    """The RG-LRU kernels' launches since the last reset, by variant and
    (B, T, R), as the wrappers count them where they launch:
    {kernel: {"v2 4x512x2560": n, ...}}."""
    from repro_torch.kernels import rg_lru as krg
    return {fn.__name__: {_rg_key(v, shape): n for (v, shape), n in fn.launches_by.items()}
            for fn in (krg.rg_lru_scan, krg.rg_lru_scan_bwd)}


def _init_on_card(tag: str, cfg, model, serving: bool = False):
    """The model's random parameters (seed 0) made on the card, logged with
    their count, bytes and seconds. Returns (params, count)."""
    import torch
    t0 = time.perf_counter()
    kwargs = {"serving": True} if serving else {}
    params = model.init(torch.Generator(device="cuda").manual_seed(0), cfg, **kwargs)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.num_heads} heads of "
        f"{cfg.resolved_head_dim} (kv {cfg.num_kv_heads}), {cfg.dtype} compute; {n_params} "
        f"parameters ({'a serving tree, matrices in ' + cfg.dtype if serving else 'float32'}:"
        f" {nbytes / 1e9:.2f} GB) made on the card in {time.perf_counter() - t0:.2f}s")
    return params, n_params


def _serve_lm(tag: str, cfg, model, params, want: dict, profile: bool = False,
              prompt: int = LM_PROMPT, extras: list | None = None) -> dict:
    """LM_REQUESTS random ``prompt``-token prompts (seed 0) through
    ``ServeEngine`` in waves of LM_SLOTS, LM_NEW new tokens each, after a
    warm-up request of WARM_NEW tokens;
    ``extras`` (one dict of host arrays a request, or None) are the
    requests' other model inputs (an audio request's ``frames``). The
    served run's kernel launches must equal ``want`` (a kernel not named
    there: 0). Then the same waves step by step through ``prefill`` /
    ``decode_step``, each wave's extras stacked, timed: every logit finite,
    the tokens the engine's. ``profile`` traces a prefill wave and a decode
    step. Returns the summary (``rg_launches_by``: the served run's RG-LRU
    launches by variant and shape); the peak is since the caller's last
    reset."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.serve import ServeConfig, ServeEngine

    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (LM_REQUESTS, prompt))
    extras = extras or [{}] * LM_REQUESTS
    scfg = ServeConfig(max_seq=prompt + LM_NEW + 8, batch_slots=LM_SLOTS,
                       max_new_tokens=LM_NEW)
    warm = ServeEngine(model, cfg, params, dataclasses.replace(scfg, max_new_tokens=WARM_NEW))
    warm.submit(prompts[0, :16], extras[0])
    warm.run()
    eng = ServeEngine(model, cfg, params, scfg)
    rids = [eng.submit(p, e) for p, e in zip(prompts, extras)]
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, rg_by = _all_launches(), _rg_launches_by()
    tokens = sum(len(out[r]) for r in rids)
    log(f"[{tag}] served {len(out)} requests, {tokens} tokens in {run_s:.3f}s "
        f"({tokens / run_s:.1f} tok/s); the port's kernels launched {launches} (want "
        f"{want or 'none'}; attention, MLPs, experts and head are torch ops)")
    check(all(c == want.get(k, 0) for k, c in launches.items()),
          f"{cfg.name}: kernel launches {launches} in the served run, not {want or 'none'}")
    check(sorted(out) == rids and all(len(out[r]) == LM_NEW for r in rids),
          "the engine did not return LM_NEW tokens for every request")

    toks = torch.from_numpy(prompts.astype(np.int32)).cuda()

    def wave(w0, n=LM_SLOTS):
        batch = {"tokens": toks[w0:w0 + n]}
        for k in extras[w0]:
            batch[k] = torch.stack([torch.as_tensor(e[k]) for e in extras[w0:w0 + n]]).cuda()
        return batch

    prefill_ms, decode_ms = [], []
    with torch.no_grad():
        for w0 in range(0, LM_REQUESTS, LM_SLOTS):
            batch = wave(w0)
            cache = model.init_cache(cfg, LM_SLOTS, prompt + LM_NEW, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = model.prefill(params, batch, cfg, cache)
            torch.cuda.synchronize()
            prefill_ms.append(1e3 * (time.perf_counter() - t0))
            check(bool(torch.isfinite(lg).all()), f"{cfg.name} prefill logits are not finite")
            tok = torch.argmax(lg[:, -1], dim=-1)
            seq = [tok]
            for _ in range(LM_NEW - 1):
                t0 = time.perf_counter()
                lg, cache = model.decode_step(params, tok[:, None].to(torch.int32), cfg, cache)
                tok = torch.argmax(lg[:, 0], dim=-1)
                torch.cuda.synchronize()
                decode_ms.append(1e3 * (time.perf_counter() - t0))
                check(bool(torch.isfinite(lg).all()), f"{cfg.name} decode logits are not finite")
                seq.append(tok)
            check(torch.stack(seq, 1).tolist() == [out[r] for r in rids[w0:w0 + LM_SLOTS]],
                  f"{cfg.name}: the wave at {w0} driven step by step differs from the "
                  f"engine's tokens")
        if profile:
            batch = wave(0)
            trace(f"{cfg.name} prefill of a 4 x {prompt} wave",
                  lambda: model.prefill(params, batch, cfg,
                                        model.init_cache(cfg, LM_SLOTS, prompt + 2, "cuda")))
            lg, cache = model.prefill(params, batch, cfg,
                                      model.init_cache(cfg, LM_SLOTS, prompt + 2, "cuda"))
            nxt = torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)
            trace(f"{cfg.name} decode step, 4 rows",
                  lambda: model.decode_step(params, nxt, cfg, cache))
    dec = sorted(decode_ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] {cfg.name} prefill of a 4 x {prompt} wave: {prefill_ms[0]:.2f} / "
        f"{prefill_ms[1]:.2f} ms; decode step (4 rows): median {dec[len(dec) // 2]:.3f} ms, "
        f"min {dec[0]:.3f}, max {dec[-1]:.3f} over {len(dec)} steps; every logit finite; "
        f"step-by-step tokens equal the engine's; peak device memory {peak:.2f} GiB")
    return {"run_s": run_s, "tok_per_s": tokens / run_s, "prefill_ms": prefill_ms,
            "decode_ms_median": dec[len(dec) // 2], "decode_ms_min": dec[0],
            "peak_gib": peak, "launches": launches, "rg_launches_by": rg_by}


def phase_dense_serve(profile: bool = False):
    """minicpm-2b at its published width, SERVE_DEPTH of its 40 layers (bf16
    compute, float32 parameters, random weights) through ``ServeEngine``: 8 requests
    of 512-token prompts in two waves of 4, 32 new tokens each; logits
    finite; the waves replayed step by step through ``prefill`` /
    ``decode_step`` give the engine's tokens. Returns the phase's summary."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = _served(get_config(DENSE_ARCH))
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, n_params = _init_on_card("dense", cfg, model)
    check(n_params == cfg.param_count() + cfg.num_layers * 2 * cfg.d_model + cfg.d_model,
          f"{DENSE_ARCH}: {n_params} parameters, not the analytic count plus the norms")
    return {"params": n_params, **_serve_lm("dense", cfg, model, params, {}, profile)}


def phase_dense_train(profile: bool = False):
    """minicpm-2b trained at its published width and depth: TRAIN_STEPS
    steps of ``make_train_step`` (AdamW, WSD, float32 moments, remat) at
    B=4, S=512 on one repeated ``synth_batch``; loss and grad norm finite,
    the last loss below the first (``profile`` traces one step more); then
    one step with int8 moments from a fresh state. No checkpoint is written
    (~48 GB). Returns the summary."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import get_model
    from repro_torch.train import AdamWConfig, TrainConfig, adamw_init, make_train_step
    from repro_torch.train.train_step import init_train_state

    cfg = get_config(DENSE_ARCH)
    check(cfg.remat, f"{DENSE_ARCH}'s config trains with remat")
    model = get_model(cfg)
    tcfg = TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT))
    torch.cuda.reset_peak_memory_stats()
    params, opt = init_train_state(model, cfg, tcfg,
                                   torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(model, cfg, tcfg)
    batch = synth_batch(0, 0, cfg, TRAIN_B, TRAIN_S, "cuda")
    losses, gnorms, step_s = [], [], []
    reset_counters()
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    launches = _all_launches()
    check(all(math.isfinite(v) for v in losses + gnorms),
          f"train losses {losses} or grad norms {gnorms} not finite")
    check(losses[-1] < losses[0], f"the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    check(all(c == 0 for c in launches.values()), f"kernels launched in training: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = TRAIN_B * TRAIN_S
    med = sorted(step_s[1:])[len(step_s[1:]) // 2]
    flops = 6 * cfg.param_count() * tokens
    log(f"[train] {DENSE_ARCH} full width and depth, B={TRAIN_B} S={TRAIN_S}, remat, bf16 "
        f"compute, float32 params and moments, AdamW {TRAIN_OPT}: losses "
        f"{[round(v, 4) for v in losses]}, grad norms {[round(v, 4) for v in gnorms]}; step "
        f"s {[round(v, 3) for v in step_s]} (median after the first {med:.3f}s, "
        f"{tokens / med:.1f} tokens/s, {flops / med / 1e12:.1f} TFLOP/s by 6*N*D, "
        f"N={cfg.param_count()}); peak device memory {peak:.2f} GiB")
    if profile:
        trace(f"{DENSE_ARCH} train step, B={TRAIN_B} S={TRAIN_S}",
              lambda: step(params, opt, batch))
    del opt
    torch.cuda.empty_cache()
    tcfg8 = TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT, moment_dtype="int8"))
    opt8 = adamw_init(params, tcfg8.optimizer)
    step8 = make_train_step(model, cfg, tcfg8)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt8, m8 = step8(params, opt8, batch)
    torch.cuda.synchronize()
    s8 = time.perf_counter() - t0
    peak8 = torch.cuda.max_memory_allocated() / 2**30
    check(math.isfinite(float(m8["loss"])) and math.isfinite(float(m8["grad_norm"])),
          "the int8-moment step's loss or grad norm is not finite")
    log(f"[train] one step with int8 moments (fresh state) after those: loss "
        f"{float(m8['loss']):.4f}, grad norm {float(m8['grad_norm']):.4f}, {s8:.3f}s "
        f"({tokens / s8:.1f} tokens/s); peak device memory {peak8:.2f} GiB")
    return {"losses": losses, "grad_norms": gnorms, "step_s": step_s, "step_s_median": med,
            "tokens_per_s": tokens / med, "tflops_6nd": flops / med / 1e12, "peak_gib": peak,
            "int8_step_s": s8, "int8_loss": float(m8["loss"]), "int8_peak_gib": peak8}


def _load_example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _checkpoint_resume(arch: str, tag: str):
    """``arch``'s smoke config on the card: 2 steps, a checkpoint saved and
    loaded, 2 more steps, against 4 straight steps, within 1e-6. Returns
    (the largest parameter difference, the loaded state)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import get_model
    from repro_torch.train import (AdamWConfig, TrainConfig, load_checkpoint, make_train_step,
                                   save_checkpoint)
    from repro_torch.train.train_step import init_train_state

    scfg = get_smoke(arch)
    smodel = get_model(scfg)
    stcfg = TrainConfig(optimizer=AdamWConfig(learning_rate=1e-3, warmup_steps=2))
    sstep = make_train_step(smodel, scfg, stcfg)

    def run(params, opt, steps):
        for t in steps:
            params, opt, _ = sstep(params, opt, synth_batch(4, t, scfg, 4, 16, "cuda"))
        return params, opt

    straight, _ = run(*init_train_state(smodel, scfg, stcfg,
                                        torch.Generator(device="cuda").manual_seed(2)), range(4))
    half = run(*init_train_state(smodel, scfg, stcfg,
                                 torch.Generator(device="cuda").manual_seed(2)), range(2))
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        save_checkpoint(ckpt, 2, {"params": half[0], "opt": half[1]}, {"rng_seed": 4})
        state, meta = load_checkpoint(ckpt, device="cuda")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    resumed, _ = run(smodel.params_from_numpy(state["params"], scfg, "cuda"), state["opt"],
                     range(meta["step"], 4))
    err_ckpt = max(float((a.detach() - b.detach()).abs().max())
                   for a, b in zip(straight.parameters(), resumed.parameters()))
    check(err_ckpt <= 1e-6, f"{scfg.name}: training on from a checkpoint differs by "
                            f"{err_ckpt:.3e} from an uninterrupted run")
    log(f"[{tag}] {scfg.name}: 2 steps, a checkpoint written on the card and reloaded, "
        f"2 more steps: within {err_ckpt:.3e} of 4 straight steps")
    return err_ckpt, state


def phase_dense_cpu_agreement():
    """The card against the CPU: minicpm-2b at full width and 2 layers in
    float32 (forward logits, the train step's loss and metrics within 1e-4,
    each gradient within 1e-4 of its tensor's largest magnitude, the grad
    norm within 1e-4 relative; AdamW on the card's gradients within 1e-6);
    a smoke-size checkpoint written on the card, reloaded and trained on,
    within 1e-6 of an uninterrupted run; the retrieval example's path on
    the card, exact against brute force, ``lb_sax_matrix`` launched."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import common as C
    from repro_torch.models import get_model
    from repro_torch.train import AdamWConfig, TrainConfig, adamw_init, adamw_update
    from repro_torch.train.optimizer import global_norm

    cfg = dataclasses.replace(get_config(DENSE_ARCH), num_layers=2, dtype="float32")
    model = get_model(cfg)
    tcfg = TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT))
    gpu = model.init(torch.Generator(device="cuda").manual_seed(1), cfg)
    cpu = model.params_from_numpy(C.stack_tree(gpu.tree(), gpu.stacked_blocks), cfg, "cpu")
    t0 = time.perf_counter()
    errs, gg, gc = _card_vs_cpu_train(cfg, model, gpu, cpu, "dense-agree",
                                      f"{DENSE_ARCH} full width, 2 layers")
    ng, nc = float(global_norm(gg)), float(global_norm(gc))
    check(abs(ng - nc) <= 1e-4 * nc, f"grad norm card {ng} vs CPU {nc}")
    gg_cpu = C.tree_map(lambda g: g.cpu(), gg)
    adamw_update(gpu, gg, adamw_init(gpu, tcfg.optimizer), tcfg.optimizer)
    adamw_update(cpu, gg_cpu, adamw_init(cpu, tcfg.optimizer), tcfg.optimizer)
    err_adam = 0.0
    for a, b in zip(gpu.parameters(), cpu.parameters()):
        err = float((a.detach().cpu() - b.detach()).abs().max())
        err_adam = max(err_adam, err)
        check(err <= 1e-6, f"AdamW on the same gradients: card vs CPU params differ by {err:.3e}")
    log(f"[dense-agree] grad norm {ng:.6f} vs {nc:.6f}, AdamW params within {err_adam:.3e} "
        f"({time.perf_counter() - t0:.2f}s)")
    del gpu, cpu, gg, gc, gg_cpu
    torch.cuda.empty_cache()

    err_ckpt, _ = _checkpoint_resume(DENSE_ARCH, "dense-agree")

    # the retrieval example's path on the card
    ex = _load_example("torch_retrieval_lm")
    t0 = time.perf_counter()
    params, metrics = ex.train("cuda")
    vecs = ex.embed(params, ex.draw_tokens(1, (2048, 32), "cuda"))
    qvecs = ex.embed(params, ex.draw_tokens(2, (5, 32), "cuda"))
    reset_counters()
    _, res, bf_d, bf_i = ex.retrieve(vecs, qvecs)
    torch.cuda.synchronize()
    launches = _all_launches()
    check(launches["lb_sax_matrix"] > 0, f"the retrieval example's search launched no "
                                         f"lb_sax_matrix: {launches}")
    check(torch.allclose(res.dists, bf_d, rtol=1e-3, atol=1e-3),
          "retrieval example: the index's distances differ from brute force")
    check(torch.equal(res.ids.long(), bf_i.long()),
          "retrieval example: the index's ids differ from brute force")
    check(math.isfinite(float(metrics["loss"])), "retrieval example: loss not finite")
    log(f"[dense-agree] retrieval example on the card: 20 steps to loss "
        f"{float(metrics['loss']):.4f}, 2048 corpus and 5 prompt embeddings, exact k=3 kNN "
        f"equal to brute force (ids equal, dists within 1e-3); launches {launches} "
        f"({time.perf_counter() - t0:.2f}s)")
    return {**errs, "adamw_err": err_adam, "ckpt_err": err_ckpt,
            "retrieval_launches": launches}


# ---------------------------------------------------------------------------
# the mixture-of-experts and Griffin families, and the rg_lru_scan kernel
# ---------------------------------------------------------------------------

MOE_ARCHS = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b")
SERVING_TREE = "moonshot-v1-16b-a3b"    # 112.2 GB in float32: served as a bf16 tree
MOE_CAPACITY = {"granite-moe-1b-a400m": 168, "moonshot-v1-16b-a3b": 64}   # at S=512
GRIFFIN_ARCH = "recurrentgemma-2b"
GRIFFIN_PARAMS = 3_549_934_080         # the tree; param_count() leaves out the gates
MOE_TRAIN_ARCH = "granite-moe-1b-a400m"
MOE_TRAIN_OPT = dict(learning_rate=3e-4, warmup_steps=1, total_steps=1000)
RG_SHAPES = {"prefill": (LM_SLOTS, LM_PROMPT, 2560), "decode": (LM_SLOTS, 1, 2560)}


def _analytic_count(cfg) -> int:
    """``param_count()`` plus the norm gains (two a layer and the final
    one), which the formula leaves out."""
    return cfg.param_count() + cfg.num_layers * 2 * cfg.d_model + cfg.d_model


def phase_moe_serve(profile: bool = False):
    """granite-moe-1b-a400m (float32 parameters; SERVE_DEPTH of its 24
    layers) and moonshot-v1-16b-a3b (a serving tree: matrices held in bf16
    only, 56.1 GB; every layer) at their published widths, random weights,
    through ``ServeEngine`` as phase 14
    serves minicpm; capacities 168 and 64 at S=512, 8 at decode; no kernel
    of the port launches; moonshot's peak under 80 GB. ``profile`` traces a
    moonshot prefill wave and decode step. Returns the summaries by arch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.moe import moe_capacity

    out = {}
    for arch in MOE_ARCHS:
        cfg = _served(get_config(arch))
        model = get_model(cfg)
        serving = arch == SERVING_TREE
        caps = (moe_capacity(cfg, LM_PROMPT), moe_capacity(cfg, 1))
        check(caps == (MOE_CAPACITY[arch], 8), f"{arch}: capacities {caps} at S={LM_PROMPT} "
                                               f"and 1, not ({MOE_CAPACITY[arch]}, 8)")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, n_params = _init_on_card("moe", cfg, model, serving)
        check(n_params == _analytic_count(cfg),
              f"{arch}: {n_params} parameters, not the analytic count plus the norms")
        s = _serve_lm("moe", cfg, model, params, {}, profile and serving)
        peak_bytes = s["peak_gib"] * 2**30
        if serving:
            check(peak_bytes < 80e9, f"{arch}: peak {peak_bytes / 1e9:.2f} GB, not under 80 GB")
        out[arch] = {"params": n_params, "serving_tree": serving, "capacity": caps,
                     "peak_gb": peak_bytes / 1e9, **s}
        del params, model
    torch.cuda.empty_cache()
    return out


def phase_moe_train(profile: bool = False):
    """granite-moe-1b-a400m trained at its published width and depth:
    TRAIN_STEPS steps of ``make_train_step`` (AdamW, float32 moments, remat,
    the MoE auxiliary loss at weight 1e-2) at B=4, S=512 on one repeated
    ``synth_batch``; loss, ``moe_aux`` and grad norm finite, the last loss
    below the first; TFLOP/s by 6*N*D with N the active parameters. Returns
    the summary."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import get_model
    from repro_torch.train import AdamWConfig, TrainConfig, make_train_step
    from repro_torch.train.train_step import init_train_state

    cfg = get_config(MOE_TRAIN_ARCH)
    check(cfg.remat, f"{MOE_TRAIN_ARCH}'s config trains with remat")
    n_active = cfg.active_param_count()
    check(n_active == 478_943_232, f"{MOE_TRAIN_ARCH}: {n_active} active parameters")
    model = get_model(cfg)
    tcfg = TrainConfig(optimizer=AdamWConfig(**MOE_TRAIN_OPT))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, opt = init_train_state(model, cfg, tcfg,
                                   torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(model, cfg, tcfg)
    batch = synth_batch(0, 0, cfg, TRAIN_B, TRAIN_S, "cuda")
    losses, auxes, gnorms, step_s = [], [], [], []
    reset_counters()
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["moe_aux"]))
        gnorms.append(float(metrics["grad_norm"]))
    launches = _all_launches()
    check(all(math.isfinite(v) for v in losses + auxes + gnorms),
          f"MoE train losses {losses}, aux {auxes} or grad norms {gnorms} not finite")
    check(losses[-1] < losses[0], f"the MoE loss did not fall over {TRAIN_STEPS} steps: "
                                  f"{losses}")
    check(all(c == 0 for c in launches.values()), f"kernels launched in MoE training: "
                                                    f"{launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = TRAIN_B * TRAIN_S
    med = sorted(step_s[1:])[len(step_s[1:]) // 2]
    flops = 6 * n_active * tokens
    log(f"[moe-train] {MOE_TRAIN_ARCH} full width and depth, B={TRAIN_B} S={TRAIN_S}, remat, "
        f"bf16 compute, float32 params and moments, AdamW {MOE_TRAIN_OPT}: losses "
        f"{[round(v, 4) for v in losses]}, moe_aux {[round(v, 4) for v in auxes]}, grad "
        f"norms {[round(v, 4) for v in gnorms]}; step s {[round(v, 3) for v in step_s]} "
        f"(median after the first {med:.3f}s, {tokens / med:.1f} tokens/s, "
        f"{flops / med / 1e12:.1f} TFLOP/s by 6*N*D, N={n_active} active); peak device "
        f"memory {peak:.2f} GiB")
    if profile:
        trace(f"{MOE_TRAIN_ARCH} train step, B={TRAIN_B} S={TRAIN_S}",
              lambda: step(params, opt, batch))
    del params, opt
    torch.cuda.empty_cache()
    return {"losses": losses, "moe_aux": auxes, "grad_norms": gnorms, "step_s": step_s,
            "step_s_median": med, "tokens_per_s": tokens / med,
            "tflops_6nd": flops / med / 1e12, "peak_gib": peak}


def _rg_cost(b, t, r):
    """(bytes, operations) of the scan: a and g read and y written once (4
    bytes each), h0 read and hT written once; a multiply and an add an
    element."""
    return 12 * b * t * r + 8 * b * r, 2 * b * t * r


def _rg_bwd_cost(b, t, r):
    """(bytes, operations) of the scan's gradient: a, y and dy read and da
    and dg written once (4 bytes each), h0 and dhT read and dh0 written
    once; an add and two multiplies an element."""
    return 20 * b * t * r + 12 * b * r, 3 * b * t * r


# the scan's edge shapes beside the path's (phases 19 and 23): a ragged shape,
# v2's tile tail (T = 515), R % 32 != 0 with R % 4 == 0, and T = 0; and the
# path's shape one float into its buffers (not 16-byte aligned: v1)
RG_EDGES = {"ragged": (3, 37, 77), "tail": (4, 515, 2560), "r36": (2, 100, 36),
            "empty": (2, 0, 5)}
RG_MISALIGNED = "misaligned"


def _rg_place(x, offset: int):
    """``x`` ``offset`` floats into a new buffer: a contiguous view whose
    storage offset leaves it off the 16-byte boundary."""
    import torch
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    buf[offset:] = x.reshape(-1)
    return buf[offset:].view(x.shape)


def _rg_hold_bits(fn, ref_fn, x, names, what: str) -> str:
    """The wrapper ``fn(*x)``, every output held to ``ref_fn`` on the card
    and on the CPU in every bit; one launch (none at T=0), counted under
    the variant that ``kernels/rg_lru.py::_plan`` picks for ``x``. Returns
    that variant."""
    from repro_torch.kernels import rg_lru as krg
    b, t, r = x[0].shape
    planned = krg._plan(t, r, krg._aligned(*(v for v in x if v.ndim == 3)))
    want, cpu = ref_fn(*x), ref_fn(*(v.cpu() for v in x))
    key = (planned, (b, t, r))
    before, by = fn.launches, fn.launches_by[key]
    got = fn(*x)
    n = 1 if t and b * r else 0
    check(fn.launches == before + n and fn.launches_by[key] == by + n,
          f"{what}: {fn.launches - before} launches in one call, "
          f"{fn.launches_by[key] - by} of them {planned}; want {n} {planned}")
    for name, q, w, c in zip(names, got, want, cpu):
        bad = int((words32(q) != words32(w)).sum())
        check(bad == 0, f"{what} ({planned}): {bad} {name} words differ from the plain "
                        f"version on the card")
        bad = int((words32(q).cpu() != words32(c)).sum())
        check(bad == 0, f"{what} ({planned}): {bad} {name} words differ from the plain "
                        f"version on the CPU")
    return planned


def phase_rg_lru_kernel():
    """``rg_lru_scan`` equal to its plain version ``rg_lru_scan_ref`` in
    every bit on the card (and to the plain version on the CPU), through
    the variant ``_plan`` picks, at the Griffin path's prefill (4, 512,
    2560) shape with a nonzero h0 (v2), its decode shape (T=1, v1), the
    edges of ``RG_EDGES`` and the prefill shape one float into its buffers
    (v1); host-loop and CUDA-graph times at both main shapes beside the
    plain version's and the bound. Returns the kernel's rows at the
    prefill and decode shapes, each with the ``variant`` timed here (their
    launches, and the check that the path's took that variant, come from
    phases 20 and 25)."""
    import torch
    from repro_torch.kernels import ref, rg_lru as krg

    g = torch.Generator(device="cuda").manual_seed(19)
    args, plans = {}, {}
    cases = {**RG_SHAPES, **RG_EDGES, RG_MISALIGNED: RG_SHAPES["prefill"]}
    for kind, shape in cases.items():
        b, t, r = shape
        a = torch.rand((b, t, r), generator=g, device="cuda")
        gated = torch.randn((b, t, r), generator=g, device="cuda")
        h0 = torch.randn((b, r), generator=g, device="cuda")
        if kind == RG_MISALIGNED:
            a, gated = _rg_place(a, 1), _rg_place(gated, 1)
        args[kind] = (a, gated, h0)
        plans[kind] = _rg_hold_bits(krg.rg_lru_scan, ref.rg_lru_scan_ref, args[kind],
                                    ("y", "hT"), f"rg_lru_scan {kind} {shape}")
    torch.cuda.synchronize()
    want = {"prefill": "v2", "decode": "v1", RG_MISALIGNED: "v1"}
    check(all(plans[k] == v for k, v in want.items()),
          f"rg_lru_scan: _plan chose {plans}, not {want} at those shapes")
    log(f"[rg_lru] rg_lru_scan equals rg_lru_scan_ref bit for bit (on the card and on the "
        f"CPU) through the planned variant, at "
        + ", ".join(f"{k} {cases[k]} ({v})" for k, v in plans.items())
        + "; prefill with a nonzero h0")
    by_shape = {}
    for kind, shape in RG_SHAPES.items():
        a = args[kind]
        nbytes, ops = _rg_cost(*shape)
        reps = 50 if kind == "prefill" else 500
        r = dict(shape=list(shape), bytes=nbytes, ops=ops, variant=plans[kind],
                 ms=time_ms(lambda a=a: krg.rg_lru_scan(*a), reps=reps, warmup=2),
                 device_ms=device_ms(lambda a=a: krg.rg_lru_scan(*a), reps=reps),
                 plain_ms=time_ms(lambda a=a: ref.rg_lru_scan_ref(*a), reps=3 if
                                  kind == "prefill" else 100, warmup=1))
        _bound(r)
        by_shape[kind] = r
    rows = [dict(name="rg_lru_scan", route="cuda", source="src/repro_torch/kernels/csrc/rg_lru.cu",
                 replaces="src/repro/models/recurrentgemma.py:114 (_rg_lru's lax.scan; "
                          "reference code outside Pallas, no TPU kernel)",
                 launches=None, max_abs_err=0.0, library_ms=None, **r)
            for r in by_shape.values()]
    log("[timing] rg_lru_scan, library none; host loop / device / plain (bound): " + "; ".join(
        f"{kind} {r['shape']} {r['variant']} {r['ms']:.4f} / {r['device_ms']:.4f} / "
        f"{r['plain_ms']:.4f} ({r['bound_ms']:.5f} by {r['bound_by']}, "
        f"{r['bound_ms'] / r['device_ms']:.1%})"
        for kind, r in by_shape.items()))
    return rows


def phase_griffin_serve(profile: bool = False):
    """recurrentgemma-2b at its published width and depth (26 layers, 18
    recurrent, window 2048; float32 parameters, bf16 compute, random
    weights) through ``ServeEngine`` as phase 14 serves minicpm;
    ``rg_lru_scan`` must launch 18 x (1 + 31) x 2 = 1,152 times in the
    served run (18 x 2 = 36 prefills, 1,116 decode steps; the wrapper counts
    them by variant and shape, ``rg_launches_by``). Returns the summary."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.recurrentgemma import _pattern

    cfg = get_config(GRIFFIN_ARCH)
    model = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, n_params = _init_on_card("griffin", cfg, model)
    check(n_params == GRIFFIN_PARAMS, f"{GRIFFIN_ARCH}: {n_params} parameters in the tree, "
                                      f"not {GRIFFIN_PARAMS}")
    n_rec = sum(kind == "rec" for kind in _pattern(cfg))
    want = n_rec * LM_NEW * (LM_REQUESTS // LM_SLOTS)
    log(f"[griffin] {n_rec} recurrent layers; param_count() {cfg.param_count()} (the "
        f"reference's formula, without w_input_gate and w_rec_gate)")
    out = {"params": n_params, "param_count": cfg.param_count(), "rec_layers": n_rec,
           **_serve_lm("griffin", cfg, model, params, {"rg_lru_scan": want}, profile)}
    del params
    torch.cuda.empty_cache()
    return out


def _card_vs_cpu_train(cfg, model, gpu, cpu, tag: str, what: str, cpu_cfg=None):
    """Forward logits and aux, the train step's metrics and gradients of
    ``gpu`` (on the card) against ``cpu`` (the same weights on the CPU), in
    float32, B=2 S=32: logits, aux and metrics within 1e-4, each gradient
    within 1e-4 of its tensor's largest magnitude. ``cpu_cfg`` (default
    ``cfg``) is the CPU side's config. Returns (errors, the card's
    gradients, the CPU's)."""
    import torch
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import common as C
    from repro_torch.train import TrainConfig
    from repro_torch.train.train_step import make_grad_fn

    batch = synth_batch(1, 0, cfg, 2, 32, "cpu")
    with torch.no_grad():
        lg, ag = model.forward(gpu, {k: v.cuda() for k, v in batch.items()}, cfg)
        lc, ac = model.forward(cpu, batch, cfg)
    err = assert_close(lg, lc, "float32", f"{what}: card vs CPU logits")
    assert_close(ag, ac, "float32", f"{what}: card vs CPU aux")
    mg, gg = make_grad_fn(model, cfg, TrainConfig())(gpu,
                                                     {k: v.cuda() for k, v in batch.items()})
    mc, gc = make_grad_fn(model, cpu_cfg or cfg, TrainConfig())(cpu, batch)
    for k in mc:
        assert_close(mg[k], mc[k], "float32", f"{what}: train-step metric {k}, card vs CPU")
    worst, worst_at = 0.0, ""
    check(gpu.stacked_blocks == cpu.stacked_blocks,
          f"{what}: the card's and the CPU's trees differ in their blocks' layout")
    groups = list(zip(C.leaf_groups(gg, gpu.stacked_blocks),
                      C.leaf_groups(gc, cpu.stacked_blocks), strict=True))
    for (path, gs), (cpath, cs) in groups:
        check(path == cpath and len(gs) == len(cs),
              f"{what}: gradient {path} of the card paired with {cpath} of the CPU")
        for i, (a, b) in enumerate(zip(gs, cs)):
            b = b.to(a.device)          # exact operations: the same numbers, on the card
            rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            at = "/".join(map(str, path)) + (f"[{i}]" if len(gs) > 1 else "")
            if rel > worst:
                worst, worst_at = rel, at
            check(rel <= 1e-4, f"{what}: gradient {at}, card vs CPU differ by {rel:.3e} of "
                               f"its largest magnitude")
    log(f"[{tag}] {what}, float32, B=2 S=32: logits max abs err {err:.3e}, aux "
        f"{float(ag):.6f} vs {float(ac):.6f}, "
        + ", ".join(f"{k} {float(mg[k]):.6f} vs {float(mc[k]):.6f}"
                    for k in ("loss", "moe_aux") if k in mc)
        + f", gradients within {worst:.3e} of each tensor's largest magnitude ({worst_at})")
    return {"logits_err": err, "grad_rel_err": worst}, gg, gc


def phase_moe_griffin_cpu_agreement():
    """The card against the CPU in float32: granite-moe at full width and 2
    layers and moonshot at its smoke config (logits, aux, the train step's
    loss and metrics, gradients; ``_card_vs_cpu_train``), and recurrentgemma
    at full width and 3 layers (rec, rec, attn): a 64-token prefill and 4
    decode steps, logits within 1e-4, tokens equal."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import get_model

    out = {}
    for tag, cfg in ((f"{MOE_TRAIN_ARCH} full width, 2 layers",
                      dataclasses.replace(get_config(MOE_TRAIN_ARCH), num_layers=2,
                                          dtype="float32")),
                     ("moonshot-v1-16b-a3b smoke", get_smoke("moonshot-v1-16b-a3b"))):
        model = get_model(cfg)
        gpu = model.init(torch.Generator(device="cuda").manual_seed(1), cfg)
        cpu = model.params_from_numpy(gpu.tree(), cfg, "cpu")
        out[tag] = _card_vs_cpu_train(cfg, model, gpu, cpu, "moe-agree", tag)[0]
        del gpu, cpu
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config(GRIFFIN_ARCH), num_layers=3, dtype="float32")
    model = get_model(cfg)
    gpu = model.init(torch.Generator(device="cuda").manual_seed(1), cfg)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 64)).astype(np.int32))
    runs = {}
    with torch.no_grad():
        for dev, params in (("cuda", gpu), ("cpu", model.params_from_numpy(gpu.tree(), cfg,
                                                                            "cpu"))):
            t0 = time.perf_counter()
            lg, cache = model.prefill(params, {"tokens": prompt.to(dev)}, cfg,
                                      model.init_cache(cfg, 1, 72, dev))
            logits, toks = [lg[0, -1].cpu()], [int(torch.argmax(lg[0, -1]))]
            for _ in range(4):
                lg, cache = model.decode_step(
                    params, torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev), cfg,
                    cache)
                logits.append(lg[0, 0].cpu())
                toks.append(int(torch.argmax(lg[0, 0])))
            runs[dev] = (torch.stack(logits), toks, time.perf_counter() - t0)
    err = assert_close(runs["cuda"][0], runs["cpu"][0], "float32",
                       f"{GRIFFIN_ARCH} full width, 3 layers: card vs CPU logits")
    check(runs["cuda"][1] == runs["cpu"][1],
          f"{GRIFFIN_ARCH} card tokens {runs['cuda'][1]} differ from the CPU's "
          f"{runs['cpu'][1]}")
    log(f"[griffin-agree] full width, 3 layers (rec, rec, attn), float32: the card's logits "
        f"are within 1e-4 of the CPU's (max abs err {err:.3e}) over a 64-token prefill and 4 "
        f"decode steps; tokens equal {runs['cuda'][1]} (card {runs['cuda'][2]:.2f}s, CPU "
        f"{runs['cpu'][2]:.2f}s)")
    out[GRIFFIN_ARCH] = {"logits_err": err}
    del gpu
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# training the two recurrent families: the backward kernels
# ---------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-7b"
RWKV_TRAIN_LAYERS = 12          # of 32: 3,161,161,728 parameters, 50.6 GB with AdamW
WKV_TRAIN_SHAPE = (TRAIN_B, TRAIN_S, 64, 64, 64)
WKV_CHECK_SHAPE = (2, 67, 3, 64, 64)
RWKV_V1_GAP = 7.736e-05         # phase 26's rwkv6 gradient gap with wkv6_bwd v1
RG_TRAIN_SHAPE = (TRAIN_B, TRAIN_S, 2560)
GRAD_REL_TOL = 1e-5             # a kernel's gradient against its plain version, of the max
BF16_GRAD_REL_TOL = 8e-3        # bf16 gradients: a bf16 step (2^-8) of the max, with room


def _wkv_bwd_cost(b, t, h, dk, dv, esize):
    """(bytes, operations) of the gradient: r, k, v and dout (``esize``
    bytes) and w read once, dr, dk, dv (``esize``) and dw written once, s0
    and dsT read and ds0 written, u read and du written; per (b, t, h) and
    state element 14 operations (forming S_{t-1}: a multiply and an FMA; an
    FMA each for dr, dk, dw and dv; a multiply and an FMA for the next G),
    and per row and column the bonus, v . do, sum u r k and du terms."""
    steps = b * t * h
    nbytes = (esize * steps * (4 * dk + 3 * dv) + 8 * steps * dk + 3 * 4 * b * h * dk * dv
              + 2 * 4 * h * dk)
    return nbytes, steps * (14 * dk * dv + 12 * dk + 2 * dv)


def _rel_err(got, want) -> float:
    """max |got - want| over the largest |want| (float32, on want's device)."""
    got, want = got.float().to(want.device), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


WKV_GRAD_NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _hold_wkv6_bwd(args, got, tol: float, what: str) -> float:
    """Each of ``got`` (the kernel's gradients) within ``tol`` of its
    tensor's largest magnitude from ``wkv6_bwd_ref`` on ``args``; dw exactly
    0 where w == 0 (a reset row of a finite state). Returns the worst
    relative error."""
    import torch
    from repro_torch.kernels import ref
    want = ref.wkv6_bwd_ref(*args)
    worst = 0.0
    for name, a, b in zip(WKV_GRAD_NAMES, got, want):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"wkv6_bwd {what}: {name} is {a.dtype} {tuple(a.shape)}, not {b.dtype} "
              f"{tuple(b.shape)}")
        check(bool(torch.isfinite(a).all()), f"wkv6_bwd {what}: {name} not finite")
        if a.numel():
            rel = _rel_err(a, b)
            check(rel <= tol, f"wkv6_bwd {what}: {name} differs from wkv6_bwd_ref by {rel:.3e} "
                              f"of its largest magnitude (limit {tol})")
            worst = max(worst, rel)
    zero = args[3] == 0.0
    check(bool((got[3][zero] == 0.0).all()), f"wkv6_bwd {what}: dw is not 0 where w == 0")
    return worst


def hold_wkv6_bwd_bits(args, got, what: str) -> None:
    """``got``, the ``wkv6_bwd`` kernel's gradients on ``args``, equals
    ``kernels/ref.py::wkv6_bwd_fma_ref`` (the kernel's sums in its order,
    through a correctly rounded fmaf) in every bit, NaNs as one word."""
    from repro_torch.kernels import ref
    for name, a, b in zip(WKV_GRAD_NAMES, got, ref.wkv6_bwd_fma_ref(*args)):
        bad = int((wkv_words(a) != wkv_words(b)).sum())
        check(bad == 0, f"wkv6_bwd {what}: {bad} {name} words differ from wkv6_bwd_fma_ref")


def source_variant(name: str) -> str:
    """The design tag (``v2``, ...) that ends the first line of
    ``csrc/<name>.cu``."""
    from repro_torch.kernels import _build
    with open(_build.CSRC / f"{name}.cu") as f:
        first = f.readline()
    m = re.search(r"\b(v\d+)\.?\s*$", first)
    check(m is not None, f"csrc/{name}.cu: no design tag ending its first line: {first!r}")
    return m.group(1)


def phase_wkv6_bwd_kernel():
    """``wkv6_bwd`` against its plain version ``wkv6_bwd_ref`` on the card:
    float32 at (2, 67, 3, 64, 64) with w == 0 at some rows of steps 40-42,
    every gradient within 1e-5 of its tensor's largest magnitude and dw 0
    at those rows; ragged K and V, T=1 and T=0; bf16 r, k, v at the
    training shape (4, 512, 64, 64, 64) within a bf16 step; bit for bit
    ``wkv6_bwd_fma_ref`` at the check shape and the ragged shapes; two
    launches bit-equal at both shapes. Times at the training shape by the
    host loop and by a CUDA graph, the plain version's once. Returns the
    kernel's row (its launches are filled in by phase 24)."""
    import torch
    from repro_torch.kernels import ref, wkv6 as kwkv

    variant = source_variant("wkv6_bwd")
    g = torch.Generator(device="cuda").manual_seed(22)

    def grads_in(shape, dtype=None):
        b, t, h, dk, dv = shape
        a = list(_wkv_inputs(g, b, t, h, dk, dv, dtype))
        dout = torch.randn((b, t, h, dv), generator=g, device="cuda").to(a[0].dtype)
        dst = torch.randn((b, h, dk, dv), generator=g, device="cuda")
        return a + [dout, dst]

    args = grads_in(WKV_CHECK_SHAPE)
    w = args[3]
    w[:, 40:43] = torch.where(torch.rand(w[:, 40:43].shape, generator=g, device="cuda") < 0.3,
                              0.0, w[:, 40:43])
    check(bool((w == 0).any()), "wkv6_bwd: no w == 0 in the check")
    got = kwkv.wkv6_bwd(*args)
    err32 = _hold_wkv6_bwd(args, got, GRAD_REL_TOL, f"{WKV_CHECK_SHAPE} float32, w == 0 at "
                                                    f"steps 40-42")
    hold_wkv6_bwd_bits(args, got, f"{WKV_CHECK_SHAPE} float32")
    again = kwkv.wkv6_bwd(*args)
    for name, a, b in zip(WKV_GRAD_NAMES, got, again):
        check(torch.equal(words32(a), words32(b)), f"wkv6_bwd: two launches differ in {name}")
    for shape in ((1, 5, 2, 33, 17), (2, 40, 1, 64, 7), (2, 1, 4, 64, 64), (1, 0, 2, 8, 8)):
        a = grads_in(shape)
        got_a = kwkv.wkv6_bwd(*a)
        _hold_wkv6_bwd(a, got_a, GRAD_REL_TOL, f"{shape} float32")
        hold_wkv6_bwd_bits(a, got_a, f"{shape} float32")
    train = grads_in(WKV_TRAIN_SHAPE, torch.bfloat16)
    t0 = time.perf_counter()
    want = ref.wkv6_bwd_ref(*train)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    got = kwkv.wkv6_bwd(*train)
    err16 = 0.0
    for name, a, b in zip(WKV_GRAD_NAMES, got, want):
        rel = _rel_err(a, b)
        err16 = max(err16, rel)
        check(a.dtype == b.dtype and rel <= BF16_GRAD_REL_TOL,
              f"wkv6_bwd {WKV_TRAIN_SHAPE} bf16: {name} ({a.dtype}) differs from wkv6_bwd_ref "
              f"by {rel:.3e} of its largest magnitude (limit {BF16_GRAD_REL_TOL})")
    max_abs = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    again = kwkv.wkv6_bwd(*train)
    for name, a, b in zip(WKV_GRAD_NAMES, got, again):
        check(torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else words32(a),
                          b.view(torch.int16) if b.dtype == torch.bfloat16 else words32(b)),
              f"wkv6_bwd {WKV_TRAIN_SHAPE} bf16: two launches differ in {name}")
    del want, again
    torch.cuda.synchronize()
    log(f"[wkv6_bwd] {variant}: within {err32:.3e} of wkv6_bwd_ref's largest "
        f"magnitudes at {WKV_CHECK_SHAPE} float32 (w == 0 at steps 40-42, dw 0 there; limit "
        f"{GRAD_REL_TOL}), at ragged K/V, T=1 and T=0; bit for bit wkv6_bwd_fma_ref at "
        f"{WKV_CHECK_SHAPE} and the ragged shapes; within {err16:.3e} at {WKV_TRAIN_SHAPE} bf16 "
        f"(limit {BF16_GRAD_REL_TOL}); two launches bit-equal at both shapes")

    def run():
        return kwkv.wkv6_bwd(*train)

    row = dict(name="wkv6_bwd", route="cuda", source="src/repro_torch/kernels/csrc/wkv6_bwd.cu",
               replaces="src/repro/kernels/ref.py:55 (jax.vjp of wkv6_ref, which the reference "
                        "trains through; no TPU kernel: src/repro/kernels/wkv6.py has no "
                        "backward)",
               variant=variant, shape=list(WKV_TRAIN_SHAPE), launches=None,
               max_abs_err=max_abs,
               ms=time_ms(run, reps=10, warmup=2), device_ms=device_ms(run, reps=10),
               plain_ms=plain_ms, library_ms=None)
    row["bytes"], row["ops"] = _wkv_bwd_cost(*WKV_TRAIN_SHAPE, 2)
    _bound(row)
    log(f"[timing] wkv6_bwd {variant} {WKV_TRAIN_SHAPE} bf16: host loop "
        f"{row['ms']:.4f} ms, device "
        f"{row['device_ms']:.4f}, plain {plain_ms:.1f} (one run), library none; bound "
        f"{row['bound_ms']:.4f} by {row['bound_by']} ({row['bytes'] / 1e6:.1f} MB, "
        f"{row['ops'] / 1e9:.3f} G operations; {row['bound_ms'] / row['device_ms']:.1%})")
    return row


def phase_rg_lru_bwd_kernel():
    """``rg_lru_scan_bwd`` equal to its plain version ``rg_lru_scan_bwd_ref``
    in every bit on the card (and to the plain version on the CPU), through
    the variant ``_plan`` picks, at the training shape (4, 512, 2560) with
    a nonzero dhT (v2), the decode shape (T=1, v1), the edges of
    ``RG_EDGES`` and the training shape one float into its buffers (v1);
    host-loop and CUDA-graph times at the training shape beside the plain
    version's and the bound. Returns the kernel's row, with the
    ``variant`` timed here (its launches come from phase 25)."""
    import torch
    from repro_torch.kernels import ref, rg_lru as krg

    g = torch.Generator(device="cuda").manual_seed(23)
    args, plans = {}, {}
    cases = {"train": RG_TRAIN_SHAPE, "decode": RG_SHAPES["decode"], **RG_EDGES,
             RG_MISALIGNED: RG_TRAIN_SHAPE}
    for kind, shape in cases.items():
        b, t, r = shape
        a = torch.rand((b, t, r), generator=g, device="cuda")
        gated = torch.randn((b, t, r), generator=g, device="cuda")
        h0 = torch.randn((b, r), generator=g, device="cuda")
        y, _ = krg.rg_lru_scan(a, gated, h0)
        dy = torch.randn((b, t, r), generator=g, device="cuda")
        dht = torch.randn((b, r), generator=g, device="cuda")
        if kind == RG_MISALIGNED:
            a, y, dy = (_rg_place(v, 1) for v in (a, y, dy))
        args[kind] = (a, y, h0, dy, dht)
        plans[kind] = _rg_hold_bits(krg.rg_lru_scan_bwd, ref.rg_lru_scan_bwd_ref, args[kind],
                                    ("da", "dg", "dh0"), f"rg_lru_scan_bwd {kind} {shape}")
    torch.cuda.synchronize()
    want = {"train": "v2", "decode": "v1", RG_MISALIGNED: "v1"}
    check(all(plans[k] == v for k, v in want.items()),
          f"rg_lru_scan_bwd: _plan chose {plans}, not {want} at those shapes")
    log(f"[rg_lru_bwd] rg_lru_scan_bwd equals rg_lru_scan_bwd_ref bit for bit (on the card and "
        f"on the CPU) through the planned variant, at "
        + ", ".join(f"{k} {cases[k]} ({v})" for k, v in plans.items())
        + "; train with a nonzero dhT")
    x = args["train"]
    nbytes, ops = _rg_bwd_cost(*RG_TRAIN_SHAPE)
    row = dict(name="rg_lru_scan_bwd", route="cuda",
               source="src/repro_torch/kernels/csrc/rg_lru.cu",
               replaces="src/repro/models/recurrentgemma.py:114 (jax.grad of _rg_lru's "
                        "lax.scan; reference code outside Pallas, no TPU kernel)",
               shape=list(RG_TRAIN_SHAPE), launches=None, max_abs_err=0.0, library_ms=None,
               bytes=nbytes, ops=ops, variant=plans["train"],
               ms=time_ms(lambda: krg.rg_lru_scan_bwd(*x), reps=50, warmup=2),
               device_ms=device_ms(lambda: krg.rg_lru_scan_bwd(*x), reps=50),
               plain_ms=time_ms(lambda: ref.rg_lru_scan_bwd_ref(*x), reps=3, warmup=1))
    _bound(row)
    log(f"[timing] rg_lru_scan_bwd {RG_TRAIN_SHAPE} {row['variant']}: host loop "
        f"{row['ms']:.4f} ms, device {row['device_ms']:.4f}, plain {row['plain_ms']:.4f}, "
        f"library none; bound {row['bound_ms']:.5f} by {row['bound_by']} "
        f"({row['bound_ms'] / row['device_ms']:.1%})")
    return row


def fill_recurrent_launches(rg_rows, bwd_rows, summary) -> None:
    """The launches of the kernels line's recurrent rows, each at its own
    shape. ``rg_lru_scan`` (``rg_rows``: prefill, decode) and
    ``rg_lru_scan_bwd`` (``bwd_rows[1]``): the launches that the wrappers
    counted, by variant and shape, in the served run (phase 20) and the
    trained run (phase 25, its int8 step included), at the row's shape.
    Every such launch must have taken the row's ``variant`` (the one its
    time was taken with), fall on a row, and add up to the runs' plain
    counts. ``wkv6_bwd`` (``bwd_rows[0]``): phase 24's launches, its int8
    step's included. Logs and records launches x (device ms - bound) of
    the ``rg_lru`` rows (``rg_lru_loss_ms``)."""
    serve, train = summary["griffin_serve"], summary["griffin_train"]
    rg = (*rg_rows, bwd_rows[1])
    for name in ("rg_lru_scan", "rg_lru_scan_bwd"):
        by: dict = {}
        for run in (serve, train):
            for key, n in run["rg_launches_by"][name].items():
                by[key] = by.get(key, 0) + n
        total = (serve["launches"][name] + train["launches"][name]
                 + train["int8_launches"][name])
        check(sum(by.values()) == total,
              f"{name}: {by} by variant and shape in phases 20 and 25, not the {total} counted")
        rows = [r for r in rg if r["name"] == name]
        for r in rows:
            shape = "x".join(map(str, r["shape"]))
            at = {k: n for k, n in by.items() if k.split()[1] == shape}
            check(list(at) == [_rg_key(r["variant"], r["shape"])],
                  f"{name} {r['shape']}: the path launched {at or 'nothing'} there, not only "
                  f"the {r['variant']} that was timed")
            r["launches"] = at[_rg_key(r["variant"], r["shape"])]
        check(sum(r["launches"] for r in rows) == total,
              f"{name}: launches {by} in phases 20 and 25 at shapes no row has")
    rwkv = summary["rwkv_train"]
    bwd_rows[0]["launches"] = (rwkv["launches"]["wkv6_bwd"]
                               + rwkv["int8_launches"]["wkv6_bwd"])
    summary["rg_lru_loss_ms"] = {f"{r['name']} {r['shape']}":
                                 r["launches"] * (r["device_ms"] - r["bound_ms"]) for r in rg}
    log("[recurrent] rg_lru launches x (device ms - bound) in this run: " + "; ".join(
        f"{k}: {v:.4f} ms" for k, v in summary["rg_lru_loss_ms"].items())
        + f"; {sum(summary['rg_lru_loss_ms'].values()):.4f} ms in all ("
        + ", ".join(f"{r['name']} {r['shape']} {r['launches']} launches, {r['variant']}"
                    for r in rg) + ")")


def _recurrent_train(tag: str, cfg, per_step: dict, n_params: int) -> dict:
    """``cfg`` trained as phase 15 trains minicpm: TRAIN_STEPS steps of
    ``make_train_step`` (AdamW at TRAIN_OPT, float32 moments, remat) at
    B=4, S=512 on one repeated ``synth_batch``; loss and grad norm finite,
    the last loss below the first; each kernel's launches a step equal to
    ``per_step`` (and no kernel of the kNN paths launched); then one step
    with int8 moments from a fresh state, with the same launches
    (``int8_launches``). Returns the summary (``rg_launches_by``: the
    RG-LRU launches of all seven steps by variant and shape)."""
    import torch
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import get_model
    from repro_torch.train import AdamWConfig, TrainConfig, adamw_init, make_train_step
    from repro_torch.train.train_step import init_train_state

    check(cfg.remat, f"{cfg.name} trains with remat")
    model = get_model(cfg)
    tcfg = TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt = init_train_state(model, cfg, tcfg,
                                   torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    count = sum(p.numel() for p in params.parameters())
    check(count == n_params, f"{cfg.name}: {count} parameters, not {n_params}")
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}; {count} float32 parameters and float32 moments "
        f"({16 * count / 1e9:.1f} GB with gradients) made on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    step = make_train_step(model, cfg, tcfg)
    batch = synth_batch(0, 0, cfg, TRAIN_B, TRAIN_S, "cuda")
    losses, gnorms, step_s = [], [], []
    reset_counters()
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    launches = _all_launches()
    check(all(math.isfinite(v) for v in losses + gnorms),
          f"{cfg.name} train losses {losses} or grad norms {gnorms} not finite")
    check(losses[-1] < losses[0], f"{cfg.name}: the loss did not fall over {TRAIN_STEPS} "
                                  f"steps: {losses}")
    want = {k: TRAIN_STEPS * per_step.get(k, 0) for k in launches}
    check(launches == want, f"{cfg.name} training launches {launches}, not {want} "
                            f"({per_step} a step)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = TRAIN_B * TRAIN_S
    med = sorted(step_s[1:])[len(step_s[1:]) // 2]
    flops = 6 * count * tokens
    log(f"[{tag}] {cfg.name}, B={TRAIN_B} S={TRAIN_S}, remat, {cfg.dtype} compute, float32 "
        f"params and moments, AdamW {TRAIN_OPT}: losses {[round(v, 4) for v in losses]}, grad "
        f"norms {[round(v, 4) for v in gnorms]}; step s {[round(v, 3) for v in step_s]} (median "
        f"after the first {med:.3f}s, {tokens / med:.1f} tokens/s, "
        f"{flops / med / 1e12:.1f} TFLOP/s by 6*N*D, N={count}); peak device memory "
        f"{peak:.2f} GiB; launches a step {per_step}")
    del opt
    params.to("cuda")           # the held-out evaluation's casts
    torch.cuda.empty_cache()
    tcfg8 = TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT, moment_dtype="int8"))
    opt8 = adamw_init(params, tcfg8.optimizer)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt8, m8 = make_train_step(model, cfg, tcfg8)(params, opt8, batch)
    torch.cuda.synchronize()
    s8 = time.perf_counter() - t0
    launches8 = {k: v - launches[k] for k, v in _all_launches().items()}
    rg_by = _rg_launches_by()
    check(launches8 == {k: per_step.get(k, 0) for k in launches8},
          f"{cfg.name} int8-moment step launches {launches8}, not {per_step}")
    peak8 = torch.cuda.max_memory_allocated() / 2**30
    check(math.isfinite(float(m8["loss"])) and math.isfinite(float(m8["grad_norm"])),
          f"{cfg.name}: the int8-moment step's loss or grad norm is not finite")
    log(f"[{tag}] one step with int8 moments (fresh state) after those: loss "
        f"{float(m8['loss']):.4f}, grad norm {float(m8['grad_norm']):.4f}, {s8:.3f}s "
        f"({tokens / s8:.1f} tokens/s); peak device memory {peak8:.2f} GiB")
    del params, opt8
    torch.cuda.empty_cache()
    return {"params": count, "losses": losses, "grad_norms": gnorms, "step_s": step_s,
            "step_s_median": med, "tokens_per_s": tokens / med,
            "tflops_6nd": flops / med / 1e12, "peak_gib": peak, "launches": launches,
            "int8_step_s": s8, "int8_loss": float(m8["loss"]), "int8_peak_gib": peak8,
            "int8_launches": launches8, "rg_launches_by": rg_by}


def phase_rwkv_train():
    """rwkv6-7b at its published width (d 4096, 64 heads of 64), cut to 12
    of 32 layers (32 layers with float32 AdamW state take 120.6 GB), trained
    by :func:`_recurrent_train`: 24 ``wkv6`` launches a step (remat runs
    each layer's forward twice) and 12 ``wkv6_bwd``."""
    import dataclasses
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(RWKV_ARCH), num_layers=RWKV_TRAIN_LAYERS)
    n = RWKV_TRAIN_LAYERS
    return _recurrent_train("rwkv-train", cfg, {"wkv6": 2 * n, "wkv6_bwd": n},
                            3_161_161_728)


def phase_griffin_train():
    """recurrentgemma-2b at its published width and depth (26 layers, 18
    recurrent) trained by :func:`_recurrent_train`: 36 ``rg_lru_scan``
    launches a step and 18 ``rg_lru_scan_bwd``."""
    from repro_torch.configs import get_config
    from repro_torch.models.recurrentgemma import _pattern

    cfg = get_config(GRIFFIN_ARCH)
    n_rec = sum(kind == "rec" for kind in _pattern(cfg))
    return _recurrent_train("griffin-train", cfg,
                            {"rg_lru_scan": 2 * n_rec, "rg_lru_scan_bwd": n_rec},
                            GRIFFIN_PARAMS)


@contextlib.contextmanager
def _wkv6_probe(layers: int):
    """Records, for the first ``layers`` calls of ``ops.wkv6`` on each kind
    of device that need grad (the layers' first forward pass; a remat
    recompute comes later), its inputs, the gradient its output receives
    (``dout``), the gradients it hands to r, k, v and w (``dr`` ...) and
    the gradient of the group norm's output after it (``dgn``), as detached
    copies: ``{"cuda": [layer 0, layer 1, ...], "cpu": [...]}``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import rwkv6

    rec = {"cuda": [], "cpu": []}
    orig, orig_gn = ops.wkv6, rwkv6._group_norm

    def save(e, name):
        def hook(g):
            e[name] = g.detach().clone()
        return hook

    def wkv6(r, k, v, w, u, state, **kw):
        out, st = orig(r, k, v, w, u, state, **kw)
        calls = rec[r.device.type]
        if torch.is_grad_enabled() and r.requires_grad and len(calls) < layers:
            e = {"in": [x.detach().clone() for x in (r, k, v, w, u, state)]}
            for name, x in zip(("dr", "dk", "dv", "dw"), (r, k, v, w)):
                x.register_hook(save(e, name))
            out.register_hook(save(e, "dout"))
            calls.append(e)
        return out, st

    def group_norm(x, *args):
        y = orig_gn(x, *args)
        calls = rec[x.device.type]
        if torch.is_grad_enabled() and y.requires_grad and calls and "gn" not in calls[-1]:
            calls[-1]["gn"] = True
            y.register_hook(save(calls[-1], "dgn"))
        return y

    ops.wkv6, rwkv6._group_norm = wkv6, group_norm
    try:
        yield rec
    finally:
        ops.wkv6, rwkv6._group_norm = orig, orig_gn


def _wkv6_gap_report(rec: dict, gg: dict, gc: dict, what: str) -> list:
    """Where the card's RWKV-6 gradients part from the CPU's, layer by
    layer (each number a max abs difference over the second tensor's
    largest magnitude): the wkv6 inputs, the gradient of the group norm's
    output and the incoming ``dout`` (the group norm's input), card vs CPU
    (the forward's and the head's rounding); ``WKV6Fn``'s gradients on
    the card against ``wkv6_bwd_ref`` on the same card tensors (the kernel
    alone); ``wkv6_bwd_ref`` on the card's tensors against the CPU's
    gradients (the plain function's amplification of the inputs' gaps);
    and the layer's ``tm`` projections' gradients, card vs CPU."""
    import torch
    from repro_torch.kernels.ref import wkv6_bwd_ref

    def rel(a, b):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    out = []
    check(len(rec["cuda"]) == len(rec["cpu"]) == len(gg["blocks"]),
          f"{what}: the wkv6 probe saw {len(rec['cuda'])} card and {len(rec['cpu'])} CPU "
          f"layers")
    for layer, (ec, eh) in enumerate(zip(rec["cuda"], rec["cpu"])):
        ins = [x.cpu() for x in ec["in"]]
        d_ref = wkv6_bwd_ref(*ins, ec["dout"].cpu(), torch.zeros_like(ins[5]))
        names = ("dr", "dk", "dv", "dw")
        row = {"layer": layer,
               "inputs": {n: rel(a, b) for n, a, b in zip("rkvw", ec["in"], eh["in"])},
               "dgn": rel(ec["dgn"], eh["dgn"]),
               "dout": rel(ec["dout"], eh["dout"]),
               "kernel_vs_ref": {n: rel(ec[n], d) for n, d in zip(names, d_ref)},
               "ref_card_inputs_vs_cpu": {n: rel(d, eh[n]) for n, d in zip(names, d_ref)},
               "card_vs_cpu": {n: rel(ec[n], eh[n]) for n in names},
               "weights": {n: rel(gg["blocks"][layer]["tm"][n], gc["blocks"][layer]["tm"][n])
                           for n in ("w_r", "w_k", "w_v", "w_lora_b")}}
        check(max(row["kernel_vs_ref"].values()) <= 1e-5,
              f"{what}, layer {layer}: WKV6Fn's card gradients differ from wkv6_bwd_ref on "
              f"the same tensors by {row['kernel_vs_ref']}")
        log(f"[recurrent-agree] {what}, layer {layer}, relative gaps: wkv6 inputs card vs CPU "
            + ", ".join(f"{n} {x:.3e}" for n, x in row["inputs"].items())
            + f"; the group norm's output gradient {row['dgn']:.3e}, its input's (dout) "
            + f"{row['dout']:.3e}; WKV6Fn on the card vs wkv6_bwd_ref on its tensors "
            + ", ".join(f"{n} {x:.3e}" for n, x in row["kernel_vs_ref"].items())
            + "; wkv6_bwd_ref on the card's tensors vs the CPU's gradients "
            + ", ".join(f"{n} {x:.3e}" for n, x in row["ref_card_inputs_vs_cpu"].items())
            + "; card vs CPU "
            + ", ".join(f"{n} {x:.3e}" for n, x in row["card_vs_cpu"].items())
            + "; weight gradients card vs CPU "
            + ", ".join(f"tm/{n} {x:.3e}" for n, x in row["weights"].items()))
        out.append(row)
    return out


def phase_recurrent_cpu_agreement():
    """The card against the CPU in float32: rwkv6-7b at full width and 2
    layers and recurrentgemma-2b at full width and 3 layers (rec, rec,
    attn): logits, the train step's loss and metrics, each gradient within
    1e-4 of its tensor's largest magnitude (``_card_vs_cpu_train``; the
    card's gradients through the backward kernels with remat, as phases 24
    and 25 train, the CPU's through the plain backward versions without),
    the grad norm within 1e-4 relative, the kernels' launches counted; for
    rwkv6, where the card's gradients part from the CPU's, layer by layer
    (``_wkv6_gap_report``); AdamW on
    the card's gradients of recurrentgemma's smoke config (its list layout
    of moments) within 1e-6; a recurrentgemma smoke checkpoint
    written on the card (the list layout), reloaded and trained on, within
    1e-6 of an uninterrupted run."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import common as C
    from repro_torch.models import get_model
    from repro_torch.models.recurrentgemma import _pattern
    from repro_torch.train import AdamWConfig, TrainConfig, adamw_init, adamw_update
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import make_grad_fn

    out = {}
    tcfg = TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT))
    for arch, layers in ((RWKV_ARCH, 2), (GRIFFIN_ARCH, 3)):
        # the card trains with remat, as phases 24-25 do; remat changes no
        # value (tests/test_torch_recurrent_train.py), so the CPU runs each
        # layer's forward once
        cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype="float32",
                                  remat=True)
        model = get_model(cfg)
        t0 = time.perf_counter()
        gpu = model.init(torch.Generator(device="cuda").manual_seed(1), cfg)
        cpu = model.params_from_numpy(gpu.tree(), cfg, "cpu")
        t_copy = time.perf_counter() - t0
        reset_counters()
        tag = f"{arch} full width, {layers} layers"
        with _wkv6_probe(layers) as rec:
            errs, gg, gc = _card_vs_cpu_train(cfg, model, gpu, cpu, "recurrent-agree", tag,
                                              dataclasses.replace(cfg, remat=False))
        t_grads = time.perf_counter() - t0 - t_copy
        launches = _all_launches()
        if arch == RWKV_ARCH:
            fwd, bwd, n = "wkv6", "wkv6_bwd", layers
        else:
            fwd, bwd, n = "rg_lru_scan", "rg_lru_scan_bwd", sum(
                kind == "rec" for kind in _pattern(cfg))
        # the no-grad forward once, the gradient's forward twice (remat)
        check(launches[fwd] == 3 * n and launches[bwd] == n,
              f"{tag}: {launches[fwd]} {fwd} and {launches[bwd]} {bwd} launches, not "
              f"{3 * n} and {n}: {launches}")
        ng, nc = float(global_norm(gg)), float(global_norm(gc))
        check(abs(ng - nc) <= 1e-4 * nc, f"{tag}: grad norm card {ng} vs CPU {nc}")
        out[arch] = {**errs, "grad_norms": [ng, nc]}
        if arch == RWKV_ARCH:
            out[arch]["gaps"] = _wkv6_gap_report(rec, gg, gc, tag)
            log(f"[recurrent-agree] {tag}: the largest gradient gap, card vs CPU, is "
                f"{errs['grad_rel_err']:.3e} of its tensor's largest magnitude against the "
                f"1e-4 limit (wkv6_bwd v1: {RWKV_V1_GAP:.3e})")
        del rec
        log(f"[recurrent-agree] {tag}: grad norm {ng:.6f} vs {nc:.6f}; launches {launches} "
            f"(s: copy {t_copy:.2f}, forward and gradients {t_grads:.2f})")
        del gpu, cpu, gg, gc
        torch.cuda.empty_cache()

    # AdamW in the list layout's moments (phase 16 holds the stacked layout's
    # at full width; here the smoke config, since the CPU's eager update of
    # 1.4 B float32 parameters alone takes ~40 s)
    scfg = get_smoke(GRIFFIN_ARCH)
    smodel = get_model(scfg)
    gpu = smodel.init(torch.Generator(device="cuda").manual_seed(1), scfg)
    cpu = smodel.params_from_numpy(gpu.tree(), scfg, "cpu")
    _, gg = make_grad_fn(smodel, scfg, tcfg)(gpu, synth_batch(3, 0, scfg, 2, 24, "cuda"))
    adamw_update(gpu, gg, adamw_init(gpu, tcfg.optimizer), tcfg.optimizer)
    adamw_update(cpu, C.tree_map(lambda g: g.cpu(), gg), adamw_init(cpu, tcfg.optimizer),
                 tcfg.optimizer)
    err_adam = max(float((a.detach().cpu() - b.detach()).abs().max())
                   for a, b in zip(gpu.parameters(), cpu.parameters()))
    check(err_adam <= 1e-6, f"{scfg.name}: AdamW on the same gradients, card vs CPU params "
                            f"differ by {err_adam:.3e}")
    log(f"[recurrent-agree] {scfg.name}: AdamW (moments a list of layers) on the card's "
        f"gradients, card vs CPU params within {err_adam:.3e}")
    out["adamw_err"] = err_adam
    del gpu, cpu, gg

    out["ckpt_err"], state = _checkpoint_resume(GRIFFIN_ARCH, "recurrent-agree")
    check(isinstance(state["params"]["blocks"], list)
          and isinstance(state["opt"]["m"]["blocks"], list),
          f"{GRIFFIN_ARCH}: the checkpoint's blocks are not the reference's list layout")
    return out


# ---------------------------------------------------------------------------
# the audio family: whisper-large-v3 served and trained, the LM loader
# ---------------------------------------------------------------------------

WHISPER_ARCH = "whisper-large-v3"
WHISPER_PROMPT = 128            # inside Whisper's 224-token prompt and 448-token context
WHISPER_TRAIN_S = 448           # the decoder's text context


def _whisper_count(cfg) -> int:
    """The tree's parameters from ``param_count()``, which counts the tied
    head twice (``arch.py``: ``v * d`` at both ends) and leaves out the
    LayerNorms (two a encoder layer, three a decoder layer, two final, a
    gain and a bias each) and the MLP biases (``d_ff + d`` a layer)."""
    d = cfg.d_model
    norms = 2 * d * (2 * cfg.encoder_layers + 3 * cfg.num_layers + 2)
    biases = (cfg.d_ff + d) * (cfg.encoder_layers + cfg.num_layers)
    return cfg.param_count() - cfg.vocab_size * d + norms + biases


def _whisper_flops(cfg, b: int, s: int) -> int:
    """6 N D of a training step (forward and backward matmuls, remat's
    second forward not counted): the encoder layers' parameters and each
    decoder layer's cross-attention K/V projections over the B x F encoder
    frames, the rest of the decoder layers and the tied head over the B x S
    decoder tokens; the attention's score products are not counted."""
    d = cfg.d_model
    enc = cfg.encoder_layers * (4 * d * d + 2 * d * cfg.d_ff)
    cross_kv = cfg.num_layers * 2 * d * d
    dec = cfg.num_layers * (6 * d * d + 2 * d * cfg.d_ff) + cfg.vocab_size * d
    return 6 * (b * cfg.num_frames * (enc + cross_kv) + b * s * dec)


def phase_whisper_serve(profile: bool = False):
    """whisper-large-v3 at its published width and depth (32 encoder and 32
    decoder layers, d 1280, 20 heads, vocab 51,866, 1,500 frames, bf16
    compute, float32 parameters, random weights from seed 0 made on the
    card) through ``ServeEngine``: 8 requests, each with 1,500 random frames
    and a 128-token prompt, in two waves of 4, 32 new tokens each; no
    kernel of the port launches; the waves replayed step by step through
    ``prefill`` / ``decode_step`` give the engine's tokens, every logit
    finite. Returns (the summary, the parameters for phase 28)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = get_config(WHISPER_ARCH)
    model = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, n_params = _init_on_card("whisper", cfg, model)
    want = _whisper_count(cfg)
    check(n_params == want, f"{WHISPER_ARCH}: {n_params} parameters, not {want}")
    log(f"[whisper] {cfg.encoder_layers} encoder layers, {cfg.num_frames} frames; "
        f"param_count() {cfg.param_count()} counts the tied head twice and no norm or MLP "
        f"bias: the tree holds {n_params}")
    rng = np.random.default_rng(1)
    extras = [{"frames": rng.standard_normal((cfg.num_frames, cfg.d_model), np.float32)}
              for _ in range(LM_REQUESTS)]
    out = _serve_lm("whisper", cfg, model, params, {}, profile, WHISPER_PROMPT, extras)
    return {"params": n_params, **out}, params


def phase_whisper_train(params):
    """whisper-large-v3 trained at full width and depth from phase 27's
    parameters: TRAIN_STEPS steps of ``make_train_step`` (AdamW at
    TRAIN_OPT, float32 moments, remat) at B=4, 1,500 frames, S=448, batch t
    ``synth_batch(0, t)`` drawn on the host and staged on the card by the
    port's ``DoubleBufferedLoader``, each staged batch equal to the one
    drawn directly; loss and grad norm finite, no kernel of the port
    launched. Each step sees a fresh batch of random tokens and frames, so
    the training losses differ by the batches' own spread; the fall is
    read on one held-out batch (t = TRAIN_STEPS, never trained on before
    the int8 step), whose loss must fall from before the first step to
    after the last. Then one step with int8 moments from a fresh state on
    that batch; then a smoke checkpoint resumed on the card within 1e-6
    (``_checkpoint_resume``). Returns the summary."""
    import torch
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data.pipeline import DoubleBufferedLoader
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import get_model
    from repro_torch.train import AdamWConfig, TrainConfig, adamw_init, make_train_step
    from repro_torch.train.train_step import make_eval_step

    cfg = get_config(WHISPER_ARCH)
    check(cfg.remat, f"{WHISPER_ARCH}'s config trains with remat")
    model = get_model(cfg)
    b, s = TRAIN_B, WHISPER_TRAIN_S
    held = synth_batch(0, TRAIN_STEPS, cfg, b, s, "cuda")
    evaluate = make_eval_step(model, cfg)
    held_before = float(evaluate(params, held)["ce"])
    # ``to`` drops the frozen tree's cached bf16 casts (ParamTree.mat): a
    # parameter being trained is cast afresh at every use
    params.to("cuda")
    params.requires_grad_(True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT))
    opt = adamw_init(params, tcfg.optimizer)
    step = make_train_step(model, cfg, tcfg)

    def make(t):
        return synth_batch(0, t, cfg, b, s, "cpu")

    loader = DoubleBufferedLoader(make, device="cuda")
    losses, gnorms, step_s, host_s = [], [], [], []
    reset_counters()
    for t in range(TRAIN_STEPS + 1):
        t0 = time.perf_counter()
        batch = next(loader)
        host_s.append(time.perf_counter() - t0)
        check(loader.state == t + 1, f"loader state {loader.state} after batch {t}")
        if t == TRAIN_STEPS:
            break
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        direct = make(t)
        check(set(batch) == set(direct) == {"tokens", "frames"}
              and all(torch.equal(batch[k].cpu(), direct[k]) for k in direct),
              f"the loader's batch {t} differs from synth_batch(0, {t})")
    launches = _all_launches()
    held_after = float(evaluate(params, held)["ce"])
    check(all(math.isfinite(v) for v in losses + gnorms),
          f"{WHISPER_ARCH} train losses {losses} or grad norms {gnorms} not finite")
    check(held_after < held_before, f"{WHISPER_ARCH}: the held-out batch's loss did not fall "
                                    f"over {TRAIN_STEPS} steps: {held_before} -> {held_after}")
    check(all(c == 0 for c in launches.values()), f"kernels launched in training: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = sorted(step_s[1:])[len(step_s[1:]) // 2]
    flops = _whisper_flops(cfg, b, s)
    log(f"[whisper-train] {WHISPER_ARCH} full width and depth, B={b}, {cfg.num_frames} frames, "
        f"S={s}, remat, bf16 compute, float32 params and moments, AdamW {TRAIN_OPT}, batches "
        f"synth_batch(0, t) through DoubleBufferedLoader (each equal to the direct draw; host s "
        f"a next() {[round(v, 3) for v in host_s]}): losses {[round(v, 4) for v in losses]}, "
        f"held-out batch's cross-entropy {held_before:.4f} -> {held_after:.4f}, grad norms {[round(v, 4) for v in gnorms]}; step s {[round(v, 3) for v in step_s]} "
        f"(median after the first {med:.3f}s, {b * s / med:.1f} decoder tokens/s, "
        f"{flops / med / 1e12:.1f} TFLOP/s by 6*N*D = {flops / 1e12:.2f} TFLOP a step: the "
        f"encoder's and the cross K/V's parameters x {b * cfg.num_frames} frames, the rest "
        f"of the decoder's and the head's x {b * s} tokens); peak device memory {peak:.2f} GiB")
    del opt
    params.to("cuda")           # the held-out evaluation's casts
    torch.cuda.empty_cache()
    tcfg8 = TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT, moment_dtype="int8"))
    opt8 = adamw_init(params, tcfg8.optimizer)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt8, m8 = make_train_step(model, cfg, tcfg8)(params, opt8, batch)
    torch.cuda.synchronize()
    s8 = time.perf_counter() - t0
    peak8 = torch.cuda.max_memory_allocated() / 2**30
    check(math.isfinite(float(m8["loss"])) and math.isfinite(float(m8["grad_norm"])),
          f"{WHISPER_ARCH}: the int8-moment step's loss or grad norm is not finite")
    log(f"[whisper-train] one step with int8 moments (fresh state) on batch {TRAIN_STEPS}: "
        f"loss {float(m8['loss']):.4f}, grad norm {float(m8['grad_norm']):.4f}, {s8:.3f}s; "
        f"peak device memory {peak8:.2f} GiB")
    del params, opt8, batch, held, loader
    torch.cuda.empty_cache()
    err_ckpt, state = _checkpoint_resume(WHISPER_ARCH, "whisper-train")
    scfg = get_smoke(WHISPER_ARCH)
    check(tuple(state["params"]["enc"]["attn"]["wq"].shape)
          == (scfg.encoder_layers, scfg.d_model, scfg.d_model)
          and tuple(state["opt"]["m"]["dec"]["mlp"]["w_up"].shape)
          == (scfg.num_layers, scfg.d_model, scfg.d_ff),
          f"{WHISPER_ARCH}: the checkpoint's enc and dec are not stacked on a leading layer "
          f"axis")
    return {"losses": losses, "held_out_ce": [held_before, held_after], "grad_norms": gnorms,
            "step_s": step_s, "step_s_median": med, "decoder_tokens_per_s": b * s / med, "tflops_6nd": flops / med / 1e12,
            "flops_6nd": flops, "host_s": host_s, "peak_gib": peak, "int8_step_s": s8,
            "int8_loss": float(m8["loss"]), "int8_peak_gib": peak8, "ckpt_err": err_ckpt}


def phase_whisper_cpu_agreement():
    """The card against the CPU at whisper's smoke config in float32:
    logits, the train step's loss and metrics, each gradient within 1e-4
    of its tensor's largest magnitude (``_card_vs_cpu_train``), and the
    greedy tokens of a 12-token prefill with frames and 8 decode steps
    equal, their logits within 1e-4."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.models import get_model

    cfg = get_smoke(WHISPER_ARCH)
    model = get_model(cfg)
    gpu = model.init(torch.Generator(device="cuda").manual_seed(1), cfg)
    cpu = model.params_from_numpy(gpu.tree(), cfg, "cpu")
    reset_counters()
    errs, _, _ = _card_vs_cpu_train(cfg, model, gpu, cpu, "whisper-agree", f"{cfg.name}")
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12))
                                        .astype(np.int32)),
             "frames": torch.from_numpy(rng.standard_normal((2, cfg.num_frames, cfg.d_model),
                                                            np.float32))}
    runs = {}
    with torch.no_grad():
        for dev, params in (("cuda", gpu), ("cpu", cpu)):
            lg, cache = model.prefill(params, {k: v.to(dev) for k, v in batch.items()}, cfg,
                                      model.init_cache(cfg, 2, 24, dev))
            logits, toks = [lg[:, -1].cpu()], [torch.argmax(lg[:, -1], -1)]
            for _ in range(8):
                lg, cache = model.decode_step(params, toks[-1][:, None].to(torch.int32), cfg,
                                              cache)
                logits.append(lg[:, 0].cpu())
                toks.append(torch.argmax(lg[:, 0], -1))
            runs[dev] = (torch.stack(logits), torch.stack(toks, 1).cpu().tolist())
    err = assert_close(runs["cuda"][0], runs["cpu"][0], "float32",
                       f"{cfg.name}: card vs CPU decode logits")
    check(runs["cuda"][1] == runs["cpu"][1],
          f"{cfg.name}: card tokens {runs['cuda'][1]} differ from the CPU's {runs['cpu'][1]}")
    launches = _all_launches()
    check(all(c == 0 for c in launches.values()), f"kernels launched: {launches}")
    log(f"[whisper-agree] {cfg.name}, float32: a 12-token prefill with frames and 8 decode "
        f"steps, logits within {err:.3e}, tokens equal {runs['cuda'][1]}")
    return {**errs, "decode_logits_err": err}


PIPE_LAYERS, PIPE_STAGES, PIPE_MICRO = 8, 4, 4     # rwkv6-7b layers, GPipe stages, microbatches
PIPE_TOKENS = 512                                  # a microbatch: (1, 512) tokens' embeddings
PIPE_OUT_TOL, PIPE_GRAD_TOL = 1e-5, 1e-4           # of each tensor's largest magnitude
COMP_STEPS = 2                                     # compressed all-reduce steps (error feedback)
COMP_CPU_ENTRIES = 1 << 18                         # a tensor's entries the CPU run takes
MESH_PHASES_BUDGET_S = 30.0                        # phases 30-33 together


def phase_specs() -> dict:
    """Phase 30: ``param_specs`` of all ten archs on ``meta`` (bytes a tree,
    llama3-405b's within 10% of 2 x ``param_count()``: it keeps bf16
    parameters) and the bytes one chip holds under ``shard_params_tree`` on
    the production meshes (16 x 16 and 2 x 16 x 16 of ``meta`` devices);
    the card's allocation must not move."""
    import torch
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.distributed.sharding import flatten_paths, shard_params_tree
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import param_specs, tree_bytes

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    meshes = {"16x16": make_production_mesh(), "2x16x16": make_production_mesh(multi_pod=True)}
    out = {}
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        spec = param_specs(cfg)
        leaves = flatten_paths(spec)
        check(all(x.is_meta for x in leaves.values()), f"{arch}: a spec leaf is not on meta")
        total, n = tree_bytes(spec), cfg.param_count()
        row = {"bytes": total, "param_count": n, "leaves": len(leaves)}
        for name, mesh in meshes.items():
            shards = flatten_paths(shard_params_tree(spec, mesh))
            row[f"per_chip_{name}"] = sum(math.prod(shards[p].shard_shape(x.shape))
                                          * x.element_size() for p, x in leaves.items())
        out[arch] = row
        log(f"[specs] {arch}: {len(leaves)} leaves, {total / 1e9:.3f} GB of {cfg.param_dtype} "
            f"parameters ({total / n:.4f} bytes a counted parameter); a chip holds "
            f"{row['per_chip_16x16'] / 1e9:.4f} GB on 16 x 16, "
            f"{row['per_chip_2x16x16'] / 1e9:.4f} GB on 2 x 16 x 16")
    big = out["llama3-405b"]
    check(abs(big["bytes"] - 2 * big["param_count"]) / (2 * big["param_count"]) < 0.1,
          f"llama3-405b's spec bytes {big['bytes']} are not within 10% of 2 x {big['param_count']}")
    torch.cuda.synchronize()
    after, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    check(after == before and peak == before,
          f"the specs allocated on the card: {before} -> {after} bytes, peak {peak}")
    log(f"[specs] no allocation on the card ({before} bytes before and after, peak {peak})")
    return out


def _pipe_stage(cfg):
    """One GPipe stage of rwkv6 layers: each layer from zero states, as
    ``rwkv6._run`` runs a fresh cache."""
    import torch
    from repro_torch.models import rwkv6

    h, hs = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size

    def stage(layers, x):
        b, dev = x.shape[0], x.device
        for p in layers:
            x = rwkv6._layer(p, x, torch.zeros((b, cfg.d_model), device=dev),
                             torch.zeros((b, cfg.d_model), device=dev),
                             torch.zeros((b, h, hs, hs), device=dev), cfg)[0]
        return x

    return stage


def _hold_wkv6_pair(shape, dtype: str) -> dict:
    """``wkv6`` and ``wkv6_bwd`` on random card inputs at ``shape`` with r,
    k, v (and dout) in ``dtype``: the forward within TOL of ``wkv6_ref``
    and bit for bit ``wkv6_fma_ref``, the gradients within a ``dtype``
    step of ``wkv6_bwd_ref``'s largest magnitudes. Returns the errors."""
    import torch
    from repro_torch.kernels import ref, wkv6 as kwkv

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(31)
    dt = getattr(torch, dtype)
    a = _wkv_inputs(g, *shape, dt)
    got = kwkv.wkv6(*a)
    want_o, want_s = ref.wkv6_ref(*a)
    what = f"{shape} {dtype}"
    fwd = max(assert_close(got[0], want_o, dtype, f"wkv6 {what} out"),
              assert_close(got[1], want_s, "float32", f"wkv6 {what} state"))
    hold_wkv6_bits(a, got, what)
    b, t, h, _, dv = shape
    grads_in = [*a, torch.randn((b, t, h, dv), generator=g, device="cuda").to(dt),
                torch.randn(tuple(a[5].shape), generator=g, device="cuda")]
    bwd = _hold_wkv6_bwd(grads_in, kwkv.wkv6_bwd(*grads_in),
                         BF16_GRAD_REL_TOL if dtype == "bfloat16" else GRAD_REL_TOL, what)
    secs = time.perf_counter() - t0
    log(f"[pipeline] wkv6 at {what}: within {fwd:.3e} of wkv6_ref and bit for bit "
        f"wkv6_fma_ref; wkv6_bwd within {bwd:.3e} of wkv6_bwd_ref's largest magnitudes "
        f"(held in {secs:.2f}s)")
    return {"wkv6_max_abs_err": fwd, "wkv6_bwd_rel_err": bwd, "held_s": secs}


def phase_pipeline() -> tuple[dict, object, list]:
    """Phase 31: GPipe over rwkv6-7b at full width, PIPE_LAYERS of its 32
    layers (random weights, seed 0) in PIPE_STAGES stages of 2 on a
    ``stage`` mesh of four ``cuda:0`` entries, PIPE_MICRO microbatches of
    (1, PIPE_TOKENS) random embeddings in the compute dtype: the forward
    and the backward of sum(out**2) against the same layers run one
    microbatch at a time without the pipeline (``torch.autograd.grad`` a
    microbatch, summed in microbatch order). Outputs within PIPE_OUT_TOL
    and gradients within PIPE_GRAD_TOL of each tensor's largest magnitude;
    ``wkv6`` and ``wkv6_bwd`` launched PIPE_LAYERS x PIPE_MICRO times each
    at (1, PIPE_TOKENS, H, 64, 64) and no other kernel, in each of the
    three runs (the pipeline, the pipeline again, the plain run). Before
    them, outside the counted runs, both kernels are held to their plain
    versions at that shape (and ``wkv6`` to ``wkv6_fma_ref`` bit for bit):
    no other phase launches them at B = 1. Returns (summary, the layers,
    each microbatch's gradient of stage 0's layers: phase 32's workers)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import pipeline_forward, split_stages
    from repro_torch.kernels import wkv6 as kwkv
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import common as C, rwkv6

    cfg = dataclasses.replace(get_config(RWKV_ARCH), num_layers=PIPE_LAYERS)
    hs = cfg.rwkv_head_size
    shape = (1, PIPE_TOKENS, cfg.d_model // hs, hs, hs)
    key = "x".join(map(str, shape))
    want_n = PIPE_LAYERS * PIPE_MICRO
    kernel_err = _hold_wkv6_pair(shape, cfg.dtype)
    per_stage = PIPE_LAYERS // PIPE_STAGES
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = C.ParamTree({"blocks": [rwkv6.init_layer(gen, cfg) for _ in range(PIPE_LAYERS)]},
                       stacked=True)
    tree.requires_grad_(True)
    blocks = list(tree.blocks)
    plist = [list(b.parameters()) for b in blocks]
    mbs = torch.randn((PIPE_MICRO, 1, PIPE_TOKENS, cfg.d_model), generator=gen,
                      device="cuda").to(getattr(torch, cfg.dtype))
    devs = np.empty(PIPE_STAGES, dtype=object)
    devs[:] = [torch.device("cuda", 0)] * PIPE_STAGES
    mesh = Mesh(devs, ("stage",))
    stage = _pipe_stage(cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for ps in plist for p in ps)
    log(f"[pipeline] {cfg.name}: {PIPE_LAYERS} of 32 layers at d_model {cfg.d_model}, "
        f"{n_params} float32 parameters made on the card in {time.perf_counter() - t0:.2f}s; "
        f"{PIPE_STAGES} stages of {per_stage} on {mesh}, {PIPE_MICRO} microbatches of "
        f"(1, {PIPE_TOKENS}, {cfg.d_model}) {cfg.dtype} embeddings")

    def held_launches(what: str) -> dict:
        """The launches since the last ``reset_counters``: want_n of
        ``wkv6`` and of ``wkv6_bwd``, all at ``shape``, and nothing else."""
        launches = _all_launches()
        by = {name: {"x".join(map(str, k)): n for k, n in fn.launches_by.items()}
              for name, fn in (("wkv6", kwkv.wkv6), ("wkv6_bwd", kwkv.wkv6_bwd))}
        check(launches == {k: want_n if k in ("wkv6", "wkv6_bwd") else 0 for k in launches},
              f"{what} launched {launches}, not {want_n} wkv6 and wkv6_bwd and nothing else")
        check(by == {"wkv6": {key: want_n}, "wkv6_bwd": {key: want_n}},
              f"{what}'s wkv6 launches by shape {by}, not {want_n} each at {key}")
        return by

    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipeline_forward(stage, split_stages(blocks, PIPE_STAGES), mbs, mesh)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    by = held_launches("the pipeline")
    pipe_grads = [[p.grad for p in ps] for ps in plist]
    for ps in plist:
        for p in ps:
            p.grad = None
    # again, the card's allocator warm: the pipeline's time beside the plain run's
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = pipeline_forward(stage, split_stages(blocks, PIPE_STAGES), mbs, mesh)
    again.float().square().sum().backward()
    torch.cuda.synchronize()
    pipe_warm_s = time.perf_counter() - t0
    held_launches("the pipeline's second run")
    check(torch.equal(again, out) and all(torch.equal(p.grad, g) for ps, gs in
                                           zip(plist, pipe_grads) for p, g in zip(ps, gs)),
          "the pipeline's second run differs from its first")
    del again
    for ps in plist:
        for p in ps:
            p.grad = None

    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_out, plain_grads, workers = [], None, []
    flat = [p for ps in plist for p in ps]
    for m in range(PIPE_MICRO):
        y = mbs[m]
        for b in blocks:
            y = stage([b], y)
        g = torch.autograd.grad(y.float().square().sum(), flat)
        plain_out.append(y.detach())
        plain_grads = ([x.clone() for x in g] if plain_grads is None
                       else [a.add_(x) for a, x in zip(plain_grads, g)])
        stage0 = [list(g[i * len(plist[0]):(i + 1) * len(plist[0])]) for i in range(per_stage)]
        workers.append([C.tree_unflatten(blocks[i].tree(), ws) for i, ws in enumerate(stage0)])
        del g
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    held_launches("the plain run")
    plain_out = torch.stack(plain_out)
    out_err = _rel_err(out.detach(), plain_out)
    flat_pipe = [g for gs in pipe_grads for g in gs]
    grad_errs = [_rel_err(a, b) for a, b in zip(flat_pipe, plain_grads)]
    grads_equal = sum(torch.equal(a, b) for a, b in zip(flat_pipe, plain_grads))
    out_equal = torch.equal(out.detach(), plain_out)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(out_err <= PIPE_OUT_TOL, f"pipeline outputs differ from the plain run by {out_err:.3e}")
    check(max(grad_errs) <= PIPE_GRAD_TOL,
          f"pipeline gradients differ from the plain run by {max(grad_errs):.3e}")
    flops = 6 * n_params * PIPE_MICRO * PIPE_TOKENS
    log(f"[pipeline] GPipe, {PIPE_MICRO} + {PIPE_STAGES} - 1 = "
        f"{PIPE_MICRO + PIPE_STAGES - 1} clock steps: forward + backward {pipe_s:.3f}s, "
        f"again {pipe_warm_s:.3f}s ({flops / pipe_warm_s / 1e12:.1f} TFLOP/s by 6*N*D; the "
        f"same outputs and gradients bit for bit); the plain run, one microbatch at a "
        f"time, {plain_s:.3f}s ({flops / plain_s / 1e12:.1f} TFLOP/s); wkv6 / wkv6_bwd launches by "
        f"shape {by} in each of the three runs, nothing else; outputs within {out_err:.3e} of the plain run's largest "
        f"magnitude (bit for bit: {out_equal}), gradients within {max(grad_errs):.3e} "
        f"({grads_equal} of {len(grad_errs)} tensors bit for bit); peak device memory "
        f"{peak:.2f} GiB")
    del pipe_grads, flat_pipe, plain_grads, out, plain_out, mbs
    tree.requires_grad_(False)
    return ({"pipeline_s": pipe_s, "pipeline_again_s": pipe_warm_s, "plain_s": plain_s, "launches_by": by,
             "kernel_err": kernel_err, "out_err": out_err, "out_bit_equal": out_equal,
             "grad_err": max(grad_errs), "grads_bit_equal": grads_equal,
             "grads": len(grad_errs), "peak_gib": peak, "params": n_params},
            tree, workers)


def phase_compressed_allreduce(workers: list) -> dict:
    """Phase 32: ``compressed_psum`` over len(workers) workers on as
    many ``cuda:0`` entries, each holding one microbatch's gradient of
    stage 0's layers from phase 31, COMP_STEPS steps with error feedback
    (the same gradients each step). Over every entry of every step
    (:func:`_hold_compressed`): the codes, error buffers and means exactly
    the reference's arithmetic recomputed in float64, each mean within
    0.51 x its scale of the exact mean; every worker's mean the same
    tensor. Then the same function on the CPU, over the same gradients' entries
    that the card gathers for it (:func:`_cpu_entries`: a tensor's first
    COMP_CPU_ENTRIES and, for every worker and step, the entry of largest
    magnitude, so every scale is the whole tensor's): ``compress_int8``'s
    codes and scales and each step's means and error buffers equal the
    card's at those entries bit for bit."""
    import torch
    from repro_torch.models import common as C
    from repro_torch.train import compress_int8, compressed_psum, init_error_buffer

    n = len(workers)
    numel = sum(t.numel() for t in C.tree_leaves(workers[0]))
    log(f"[allreduce] {n} workers on cuda:0, {len(C.tree_leaves(workers[0]))} tensors, {numel} "
        f"gradients a worker: an int8 payload of {numel / 1e9:.3f} GB a worker against "
        f"{4 * numel / 1e9:.3f} GB in float32")

    def run(grads):
        """COMP_STEPS steps of the psum from zero buffers, and each worker's
        ``compress_int8``: ([(means, errs, the errs it started from)], codes,
        seconds a step)."""
        errs = [init_error_buffer(g) for g in grads]
        steps, secs = [], []
        for _ in range(COMP_STEPS):
            prev = [C.tree_leaves(e) for e in errs]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            means, errs = compressed_psum(grads, errs)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            steps.append(([C.tree_leaves(m) for m in means], [C.tree_leaves(e) for e in errs],
                          prev))
        codes = [[compress_int8(t) for t in C.tree_leaves(g)] for g in grads]
        return steps, codes, secs

    card_steps, card_codes, card_s = run(workers)
    leaves = [C.tree_leaves(g) for g in workers]
    worst = 0.0
    t0 = time.perf_counter()
    for means, errs, prev in card_steps:
        for i, got in enumerate(means[0]):
            check(all(m[i] is got for m in means[1:]),
                  "the workers on one card do not share their mean")
            worst = max(worst, _hold_compressed([lv[i] for lv in leaves], [p[i] for p in prev],
                                                got, [e[i] for e in errs]))
    held_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = _cpu_entries(leaves, card_steps)
    host = [[t.reshape(-1)[j].cpu() for t, j in zip(lv, idx)] for lv in leaves]
    cpu_steps, cpu_codes, cpu_s = run(host)
    for (cm, ce, _), (hm, he, _) in zip(card_steps, cpu_steps):
        for i, j in enumerate(idx):
            check(torch.equal(cm[0][i].reshape(-1)[j].cpu(), hm[0][i]),
                  "a compressed mean differs between card and CPU")
            check(all(torch.equal(ce[w][i].reshape(-1)[j].cpu(), he[w][i]) for w in range(n)),
                  "an error buffer differs between card and CPU")
    for cw, hw in zip(card_codes, cpu_codes):
        for (q, sc), (hq, hs), j in zip(cw, hw, idx):
            check(torch.equal(q.reshape(-1)[j].cpu(), hq) and torch.equal(sc.cpu(), hs),
                  "compress_int8's codes or scale differ between card and CPU")
    cpu_s_all = time.perf_counter() - t0
    entries = sum(len(j) for j in idx)
    log(f"[allreduce] {COMP_STEPS} steps with error feedback: card {[round(x, 4) for x in card_s]}s "
        f"a step; over every entry, every code, error buffer and mean the reference's "
        f"arithmetic recomputed in float64, and each mean within {worst:.4f} x its scale of "
        f"the exact mean (limit 0.51), held in {held_s:.2f}s; the CPU run over {entries} of the {numel} entries a worker (each tensor's first "
        f"{COMP_CPU_ENTRIES} and its largest): {[round(x, 3) for x in cpu_s]}s a step, codes, "
        f"scales, means and error buffers equal to the card's there bit for bit "
        f"({cpu_s_all:.2f}s with the copies and comparisons)")
    del card_steps, cpu_steps, card_codes, cpu_codes, host, leaves
    torch.cuda.empty_cache()
    return {"workers": n, "numel": numel, "payload_bytes": numel, "float32_bytes": 4 * numel,
            "card_step_s": card_s, "cpu_step_s": cpu_s, "cpu_entries": entries,
            "worst_err_over_scale": worst, "held_s": held_s, "cpu_check_s": cpu_s_all}


def _hold_compressed(grads: list, prev: list, mean, errs: list) -> float:
    """One tensor of one compressed step, on its device, over every entry:
    with each float32 operation of the reference recomputed as a float64
    operation rounded to float32 (the same value: float64 has more than
    2 x 24 + 2 bits, so rounding twice after +, -, x or / is harmless),
    x_w = g_w + e_w, the scale max_w max|x_w| / 127, the codes q_w =
    round(x_w / scale) (half to even) with |q_w| <= 127, each worker's new
    buffer exactly x_w - q_w * scale and the mean exactly (sum_w q_w) *
    scale / n. Also the mean within 0.51 x scale of the exact mean of the
    x_w. Returns |mean - exact mean| / scale at its largest."""
    import torch

    def f32(x):                        # float64 rounded to float32, kept in float64
        return x.to(torch.float32).to(torch.float64)

    n = len(grads)
    xs = [f32(g.double() + e.double()) for g, e in zip(grads, prev)]
    scale = max(f32(x.abs().max() / 127.0) for x in xs)
    div = torch.clamp_min(scale, float(torch.tensor(1e-20, dtype=torch.float32)))
    summed = torch.zeros_like(xs[0])
    for w, x in enumerate(xs):
        q = torch.round(f32(x / div))
        check(float(q.abs().max()) <= 127, f"a compressed code is {float(q.abs().max())}")
        want = f32(x - f32(q * scale)).to(torch.float32)
        bad = int((errs[w] != want).sum())
        check(bad == 0, f"worker {w}'s error buffer differs from x - q x scale at {bad} entries")
        summed += q
        del q, want
    want = f32(f32(summed * scale) / n).to(torch.float32)
    bad = int((mean != want).sum())
    check(bad == 0, f"a compressed mean differs from sum(q) x scale / n at {bad} entries")
    exact = sum(xs[1:], xs[0].clone()) / n
    err = float((mean.double() - exact).abs().max())
    scale = float(scale)
    check(err <= 0.51 * scale + 1e-12,
          f"a compressed mean is {err:.3e} from the exact mean, past 0.51 x {scale:.3e}")
    return err / scale if scale else 0.0


def _cpu_entries(leaves: list, steps: list) -> list:
    """For each tensor (``leaves[w][i]``, worker w's), the flat indices the
    CPU run takes, the same for every worker, on the card: the first
    COMP_CPU_ENTRIES, and for each worker and step the entry where the
    step's input (gradient plus carried error) is largest in magnitude. So
    every max, and every scale, over them is the whole tensor's."""
    import torch

    out = []
    for i, first in enumerate(leaves[0]):
        picks = [torch.arange(min(first.numel(), COMP_CPU_ENTRIES), device=first.device)]
        for _, _, prev in steps:
            picks += [(lv[i].float() + p[i]).abs().reshape(-1).argmax().reshape(1)
                      for lv, p in zip(leaves, prev)]
        out.append(torch.unique(torch.cat(picks)))
    return out


def phase_reshard(tree) -> dict:
    """Phase 33: phase 31's layers in the reference's layout (stacked on a
    leading layer axis) as host numpy, placed by ``reshard_checkpoint``
    under ``param_spec`` on a (data 2, model 2) mesh of ``cuda:0``, then on
    (data 1, model 4): every piece's shape is its ``shard_shape``, and every
    gathered leaf equals, bit for bit, the card tensor that the host array
    was copied from."""
    import numpy as np
    import torch
    from repro_torch.distributed.sharding import NamedSharding, flatten_paths, param_spec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common as C
    from repro_torch.train import reshard_checkpoint

    t0 = time.perf_counter()
    card = flatten_paths(C.stack_tree(tree.tree(), True))
    host = C.nest((("params", *p.split("/")), t.cpu().numpy()) for p, t in card.items())
    to_host_s = time.perf_counter() - t0
    out = {"to_host_s": to_host_s}
    for grid in ((2, 2), (1, 4)):
        mesh = make_host_mesh(grid[1], devices=["cuda:0"] * 4)

        def rules(path, leaf):
            return NamedSharding(mesh, param_spec(path[len("params/"):], leaf.shape, mesh))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        placed = flatten_paths(reshard_checkpoint(host, mesh, rules))
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        sharded = 0
        for path, st in placed.items():
            want = card[path[len("params/"):]]
            for piece in st.pieces.flat:
                check(tuple(piece.shape) == st.sharding.shard_shape(st.shape)
                      and piece.device == torch.device("cuda", 0),
                      f"{path}: a piece of {tuple(piece.shape)} on {piece.device}, not "
                      f"{st.sharding.shard_shape(st.shape)} on cuda:0")
            check(torch.equal(st.gather("cuda:0"), want),
                  f"{path}: gathered from {st.sharding.spec} it is not the host array")
            sharded += any(st.sharding.spec)
        specs = collections.Counter(str(tuple(st.sharding.spec)) for st in placed.values())
        log(f"[reshard] {mesh}: {len(placed)} leaves ({sharded} sharded) placed in "
            f"{place_s:.2f}s, every piece its shard_shape, every gather bit for bit; leaves "
            f"by spec {dict(specs)}")
        out[f"{grid[0]}x{grid[1]}"] = {"place_s": place_s, "sharded": sharded,
                                      "leaves": len(placed)}
        del placed
    del card, host
    torch.cuda.empty_cache()
    log(f"[reshard] the host copy of {sum(p.numel() for p in tree.parameters())} parameters "
        f"took {to_host_s:.2f}s")
    return out


def phases_mesh(timed, phase_s: dict, alone: bool = False) -> dict:
    """Phases 30-33, the multi-device layer, through ``timed`` (which
    writes each phase's seconds into ``phase_s``). After phase 29 they must
    take at most MESH_PHASES_BUDGET_S together; ``alone`` (``--mesh-only``)
    only logs their time, since there phase 30 also pays the package's
    first imports and traces. Returns their summaries."""
    import torch

    t_mesh = time.perf_counter()
    out = {"specs": timed("specs", phase_specs)}
    out["pipeline"], ptree, workers = timed("pipeline", phase_pipeline)
    out["allreduce"] = timed("allreduce", phase_compressed_allreduce, workers)
    del workers
    out["reshard"] = timed("reshard", phase_reshard, ptree)
    del ptree
    torch.cuda.empty_cache()
    mesh_s = time.perf_counter() - t_mesh
    log(f"[mesh] phases 30-33 took {phase_s['specs']} / {phase_s['pipeline']} / "
        f"{phase_s['allreduce']} / {phase_s['reshard']}s, {mesh_s:.1f}s together (budget "
        f"{MESH_PHASES_BUDGET_S:.0f}s)")
    check(alone or mesh_s <= MESH_PHASES_BUDGET_S,
          f"phases 30-33 took {mesh_s:.1f}s, past their {MESH_PHASES_BUDGET_S:.0f}s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-series", type=int, default=FULL_SERIES)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--profile", action="store_true",
                    help="also trace 16 queries per backend, a prefill wave and a "
                         "decode step of rwkv6-7b, of minicpm-2b, of "
                         "moonshot-v1-16b-a3b and of whisper-large-v3, and a "
                         "minicpm-2b train step, with torch.profiler")
    ap.add_argument("--disk-dir", default=None,
                    help="directory for the disk phase's index (default: a new "
                         "temporary directory); removed at the end")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build the kernels, then run only phases 30-33 (the "
                         "multi-device layer) and print their summaries; no "
                         "kernels line and no ok line")
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
    phase_s: dict = {}

    def timed(label, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        phase_s[label] = round(time.perf_counter() - t0, 1)
        return out

    name, smi = phase_device()
    timed("build", phase_build)
    if args.mesh_only:
        log(f"[main] summary {json.dumps(phases_mesh(timed, phase_s, alone=True))}")
        log(f"[done] {time.perf_counter() - t_start:.1f}s; by phase (s): {phase_s}")
        print(smi)
        return 0
    timed("adversarial", phase_adversarial)
    data, queries, local, launches, answers, summary = timed(
        "main", phase_main, args.num_series, args.queries)
    root = disk_root(args.disk_dir, *data.shape)
    try:
        disk_launches, blocks, summary["disk"], hx = timed(
            "disk", phase_disk, data, queries, local, answers, root, args.profile)
        try:
            summary["sanitize"] = timed("sanitize", phase_sanitize, hx, queries, answers,
                                        summary["disk"])
            summary["waves"] = timed("waves", phase_waves, queries, local, answers, hx,
                                     summary)
            summary["shards"] = timed("shards", phase_shards, data, queries, local, answers,
                                      hx, summary)
            dtw_rows, dtw_shapes, summary["dtw"] = timed("dtw", phase_dtw, queries, local)
            summary["store"] = timed("store", phase_store, hx, data, queries, summary)
        finally:
            hx.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        log(f"[disk] removed {root}")
    # lb_sax_matrix over the whole LSD sidecar in phase 6: once a local wave
    # call for the query bucket, once a local serving wave call (the bad
    # request's members served alone included) for the 32 slots
    n_pad, qn = local.index.layout.lsd.shape[0], len(queries)
    bucket = 1 << (qn - 1).bit_length()
    wl = summary["waves"]["launches"]
    wave_launches = {bucket: summary["waves"]["lb_sax_wave_launches"],
                     SERVE_SLOTS: wl["serving local"]["lb_sax_matrix"]}
    shard_lb = (summary["shards"]["shard_n_pad"],
                sum(c["lb_sax_matrix"] for t, c in summary["shards"]["launches"].items()
                    if t.startswith("sharded")))
    rows, shapes = timed("kernel_timing", phase_kernel_timing, data, queries, local, launches,
                         wave_launches, shard_lb)
    disk_row, ooc_min_row, disk_shapes = timed("disk_kernels", phase_disk_kernels, queries,
                                               blocks, disk_launches)
    rows += [disk_row, ooc_min_row, *dtw_rows]
    shapes += disk_shapes + dtw_shapes
    del blocks
    # launches per run of the kernels at each timed shape (query rows,
    # series rows) in phases 4-7: ed_matrix runs on 4096-row blocks only
    # (the k>1 scan, ooc-scan raw k>1); decode_bf16_ed_matrix on 131,072-row
    # blocks in ooc-scan and on leaves padded to max_leaf rows in ooc-local;
    # lb_sax_matrix once a query over the whole LSD sidecar in local (phase
    # 4), once a wave call over it (phase 6, the bucket's rows or the 32
    # slots), and on 131,072-row LSD blocks (the last of each call partial)
    # in ooc-local and dist-ooc (whose shards pad leaves to the global
    # max_leaf), and once a query over a shard's LSD in sharded (phase 7).
    # The ooc-local serving run's launches (32-row waves over LSD blocks and
    # leaves) fall in no timed shape and are counted apart
    calls = [(t, c["launches"]) for t, c in summary["disk"]["calls"].items()]
    calls += [(t, c) for t, c in wl.items() if not t.startswith("serving")]
    calls += [(t, c) for t, c in summary["shards"]["launches"].items()
              if t.startswith("dist-ooc")]

    def count(kname, prefix):
        return sum(c[kname] for t, c in calls if t.startswith(prefix))

    per_run = {
        ("lb_sax_matrix", 1, n_pad): launches["lb_sax_matrix"],
        ("lb_sax_matrix", bucket, n_pad): wave_launches[bucket],
        ("lb_sax_matrix", SERVE_SLOTS, n_pad): wave_launches[SERVE_SLOTS],
        ("lb_sax_matrix", 1, shard_lb[0]): shard_lb[1],
        ("lb_sax_matrix", bucket, 1 << 17): (count("lb_sax_matrix", "ooc-local")
                                             + count("lb_sax_matrix", "dist-ooc")),
        ("ed_matrix", bucket, 4096): launches["ed_matrix"] + count("ed_matrix", ""),
        ("ed_matrix", bucket, 1 << 17): 0,
        ("ed_min", bucket, data.shape[0]): launches["ed_min"],
        ("ed_min", bucket, 1 << 17): count("ed_min", "ooc-scan"),
        ("decode_bf16_ed_matrix", bucket, 1 << 17): count("decode_bf16_ed_matrix",
                                                          "ooc-scan"),
        ("decode_bf16_ed_matrix", bucket, 4096): (count("decode_bf16_ed_matrix",
                                                        "ooc-local")
                                                  + count("decode_bf16_ed_matrix",
                                                          "dist-ooc")),
    }
    log(f"[timing] launches of the ooc-local serving run (32-row waves, in no timed shape): "
        f"{wl['serving ooc-local bf16']}")
    for r in rows + shapes:
        key = (r["name"], r["shape"][0], r["shape"][1])
        if key in per_run and "launches_per_run" not in r:
            r["launches_per_run"] = per_run[key]
    summary["kernel_shapes"] = [
        {k: r[k] for k in ("name", "shape", "ms", "device_ms", "plain_ms", "library_ms",
                           "bound_ms", "launches_per_run")}
        for r in rows + shapes if "launches_per_run" in r]
    log(f"[timing] kernels by shape (ms host loop / device, bound, launches per run): "
        + "; ".join(f"{r['name']} {r['shape']}: {r['ms']:.4f} / {r['device_ms']:.4f}, "
                    f"{r['bound_ms']:.4f}, {r['launches_per_run']}"
                    for r in summary["kernel_shapes"]))
    if args.profile:
        timed("profile", phase_profile, data, queries, local)
    del data, queries, local, answers
    torch.cuda.empty_cache()
    timed("cpu_agreement", phase_cpu_agreement)
    t_lm = time.perf_counter()
    wkv_row = phase_wkv6_kernel()
    wkv_row["launches"], summary["lm"] = phase_lm_serve(args.profile)
    rows.append(wkv_row)
    # launches x (device time - bound) of the served run, by shape
    by_shape = summary["wkv6_shapes"] = wkv_row.pop("by_shape")
    pre = summary["lm"]["wkv6_prefill_launches"]
    loss = {kind: n * (by_shape[f"{kind} bfloat16"]["device_ms"]
                       - by_shape[f"{kind} bfloat16"]["bound_ms"])
            for kind, n in (("prefill", pre), ("decode", wkv_row["launches"] - pre))}
    summary["wkv6_loss_ms"] = loss
    log(f"[lm] wkv6 launches x (device ms - bound) in the served run: prefill {pre} x, "
        f"{loss['prefill']:.4f} ms; decode {wkv_row['launches'] - pre} x, "
        f"{loss['decode']:.4f} ms")
    torch.cuda.empty_cache()
    phase_lm_cpu_agreement()
    summary["lm"]["phases_s"] = time.perf_counter() - t_lm
    log(f"[lm] the LM phases (11-13) took {summary['lm']['phases_s']:.1f}s")
    phase_s["lm"] = round(summary["lm"]["phases_s"], 1)
    torch.cuda.empty_cache()
    summary["dense_serve"] = timed("dense_serve", phase_dense_serve, args.profile)
    torch.cuda.empty_cache()
    summary["dense_train"] = timed("dense_train", phase_dense_train, args.profile)
    torch.cuda.empty_cache()
    summary["dense_agree"] = timed("dense_agree", phase_dense_cpu_agreement)
    log(f"[dense] phases 14-16 took {phase_s['dense_serve']} / {phase_s['dense_train']} / "
        f"{phase_s['dense_agree']}s")
    torch.cuda.empty_cache()
    summary["moe_serve"] = timed("moe_serve", phase_moe_serve, args.profile)
    summary["moe_train"] = timed("moe_train", phase_moe_train)
    rg_rows = timed("rg_lru", phase_rg_lru_kernel)
    summary["griffin_serve"] = timed("griffin_serve", phase_griffin_serve)
    rows += rg_rows
    summary["moe_griffin_agree"] = timed("moe_griffin_agree", phase_moe_griffin_cpu_agreement)
    log(f"[moe] phases 17-21 took {phase_s['moe_serve']} / {phase_s['moe_train']} / "
        f"{phase_s['rg_lru']} / {phase_s['griffin_serve']} / {phase_s['moe_griffin_agree']}s")
    torch.cuda.empty_cache()
    bwd_rows = [timed("wkv6_bwd", phase_wkv6_bwd_kernel),
                timed("rg_lru_bwd", phase_rg_lru_bwd_kernel)]
    summary["rwkv_train"] = timed("rwkv_train", phase_rwkv_train)
    summary["griffin_train"] = timed("griffin_train", phase_griffin_train)
    fill_recurrent_launches(rg_rows, bwd_rows, summary)
    rows += bwd_rows
    summary["recurrent_agree"] = timed("recurrent_agree", phase_recurrent_cpu_agreement)
    log(f"[recurrent] phases 22-26 took {phase_s['wkv6_bwd']} / {phase_s['rg_lru_bwd']} / "
        f"{phase_s['rwkv_train']} / {phase_s['griffin_train']} / "
        f"{phase_s['recurrent_agree']}s")
    torch.cuda.empty_cache()
    summary["whisper_serve"], wparams = timed("whisper_serve", phase_whisper_serve, args.profile)
    summary["whisper_train"] = timed("whisper_train", phase_whisper_train, wparams)
    del wparams
    summary["whisper_agree"] = timed("whisper_agree", phase_whisper_cpu_agreement)
    log(f"[whisper] phases 27-29 took {phase_s['whisper_serve']} / "
        f"{phase_s['whisper_train']} / {phase_s['whisper_agree']}s")
    torch.cuda.empty_cache()
    summary.update(phases_mesh(timed, phase_s))
    log(f"[main] summary {json.dumps(summary)}")
    log(f"[done] {time.perf_counter() - t_start:.1f}s; by phase (s): {phase_s}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "bytes", "ops",
            "device_ms")
    print(json.dumps({"kernels": [{**{k: r[k] for k in keys},
                                   **{k: r[k] for k in ("variant", "lanes") if k in r}}
                                  for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
