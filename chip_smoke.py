#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Hercules on one CUDA card.

    python3 chip_smoke.py                      # the full run (2**22 x 256)
    python3 chip_smoke.py --num-series 65536   # a short check
    python3 chip_smoke.py --disk-dir /big/tmp  # put the disk index there

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
   (dists bit-identical, positions equal); ``dtw_band`` bit for bit equal
   to its plain version ``dtw_band_ref`` on the card at 1 query x 4,096
   rows and at a refinement round (16 x 256); host-loop and CUDA-graph
   times at those shapes and at the brute force's (1 x every row);
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
   generations side by side at the compaction's peak, about 14 GB at the
   full size) is removed after this phase, also on failure;
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
12. LM serving at full width: ``rwkv6-7b`` (all 32 layers, d_model 4096,
   bf16 compute, float32 parameters) with random weights from a seed, 8
   requests of 512-token prompts through ``ServeEngine`` in two waves of 4,
   32 new tokens each; ``wkv6`` must launch 32 x (1 + 31) x 2 = 2,048
   times in that run; logits finite; the waves replayed step by step give
   the engine's tokens; served again in float32 with the same weights, each
   first token equals the request's solo run wherever its top-2 margin
   exceeds twice the float32 logit tolerance;
13. the card against the CPU at full width and 2 layers in float32: a
   64-token prefill and 4 decode steps, logits within 1e-4, equal tokens;
14. dense LM serving at full width: ``minicpm-2b`` (all 40 layers, d_model
   2304, vocab 122,753, bf16 compute, float32 parameters, ~3.0 B
   parameters) with random weights from a seed, 8 requests of 512-token
   prompts through ``ServeEngine`` in two waves of 4, 32 new tokens each;
   logits finite; the waves replayed step by step give the engine's
   tokens; prefill ms a wave, decode ms a step, tok/s and peak memory;
15. training at full width: the same model, 6 steps of ``make_train_step``
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
17. mixture-of-experts serving at full width and depth, as phase 14 serves:
   ``granite-moe-1b-a400m`` (24 layers, 32 experts top-8, float32
   parameters) and ``moonshot-v1-16b-a3b`` (48 layers, 64 experts top-6,
   28.06 B parameters held as a bf16 serving tree, 56.1 GB; peak under 80
   GB); capacities 168 and 64 at S=512, 8 at decode; no kernel of the port
   launches (experts, routing and combine are torch ops);
18. MoE training: ``granite-moe-1b-a400m``, 6 steps at B=4, S=512 (AdamW,
   float32 moments, remat, the auxiliary loss at 1e-2); loss, ``moe_aux``
   and grad norm finite, the last loss below the first; TFLOP/s by 6*N*D
   with N the 478,943,232 active parameters;
19. ``rg_lru_scan`` equal to its plain version bit for bit at the Griffin
   path's prefill (4, 512, 2560, nonzero h0) and decode (T=1) shapes, a
   ragged shape and T=0, on the card and against the CPU; host-loop and
   CUDA-graph times beside the plain version's and the bound;
20. ``recurrentgemma-2b`` served at full width and depth as phase 14 serves
   (26 layers, 18 recurrent, window 2048, 3,549,934,080 float32
   parameters); ``rg_lru_scan`` must launch 18 x 32 x 2 = 1,152 times;
21. the card against the CPU in float32: granite-moe at full width and 2
   layers and moonshot at its smoke config (logits and aux within 1e-4,
   the train step's metrics within 1e-4, each gradient within 1e-4 of its
   tensor's largest magnitude), recurrentgemma at full width and 3 layers
   (rec, rec, attn; a 64-token prefill and 4 decode steps within 1e-4,
   tokens equal).

The line before the last two is ``{"kernels": [...]}`` (every row with
``device_ms``, a CUDA graph's time; the ``dtw_band`` row from phase 7b at
1 x 4,096, its other shapes in the summary; ``rg_lru_scan`` at the prefill
and decode shapes, each row with the run's launches); then the card's ``nvidia-smi`` name
and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
    krg.rg_lru_scan.launches = 0
    kdtw.dtw_band.launches = 0
    klb.lb_sax_matrix.launches = 0
    ked.ed_matrix.launches = 0
    ked.ed_min.launches = 0
    ked.decode_bf16_ed_matrix.launches = 0
    kwkv.wkv6.launches = 0


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
    # lsd of 1/16 of the rows; then generation 1 over both: about 14 GB
    jrows = journal_rows(num) * 2
    need = int((2 * num + jrows) * (6 * n + 20) * 1.05) + (128 << 20)
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


def dtw_cost(pairs: int, n: int, band: int) -> tuple[int, int]:
    """(bytes, operations) of ``pairs`` banded-DTW pairs of length ``n``:
    each candidate row read once and each distance written once, and ~5
    FP32 operations (subtract, multiply, two minima, add) a band cell."""
    band = min(band, n - 1)
    cells = n * (2 * band + 1) - band * (band + 1)
    return pairs * (n + 1) * 4, 5 * pairs * cells


def words32(x):
    import torch
    return x.contiguous().view(torch.int32)


def phase_dtw(queries, local):
    """Exact banded-DTW kNN on phase 4's in-memory index (before the
    journal): ``dtw_knn`` over the first ``DTW_QUERIES`` queries at band
    ``DTW_BAND``, k = 1 and 10, held against a brute-force ``dtw_band`` over
    every row with a stable top-k (dists bit-identical, positions equal);
    ``dtw_band`` held bit for bit to ``dtw_band_ref`` on the card at 1 query
    x 4,096 rows; both times at that shape, at the brute force's (1 query x
    every row) and at a refinement round's (the queries x one chunk).
    Returns (the kernels line's row, the other shapes' rows, summary)."""
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

    # the kernel against its plain version, bit for bit, then its times
    a, cands = q[0], rows[:DTW_BITS_ROWS]
    got = kdtw.dtw_band(a, cands, DTW_BAND)
    want = ref.dtw_band_ref(a, cands, DTW_BAND)
    bad = int((words32(got) != words32(want)).sum())
    check(bad == 0, f"[dtw] dtw_band: {bad} of {DTW_BITS_ROWS} distances differ from "
                    f"dtw_band_ref on the card")
    err = float((got - want).abs().max())
    qn = q.shape[0]
    rnd = rows[:qn * chunk].reshape(qn, chunk, n)
    bad = int((words32(kdtw.dtw_band(q, rnd, DTW_BAND))
               != words32(ref.dtw_band_ref(q, rnd, DTW_BAND))).sum())
    check(bad == 0, f"[dtw] dtw_band: {bad} distances of a {qn} x {chunk} round differ "
                    f"from dtw_band_ref on the card")
    log(f"[dtw] dtw_band equals dtw_band_ref bit for bit at 1 x {DTW_BITS_ROWS} x {n} and "
        f"at a refinement round's {qn} x {chunk} x {n}, band {DTW_BAND}")
    shapes = []
    # (query, candidates, shape, host-loop and graph reps, plain reps,
    # launches at the shape in dtw_knn): the bits' shape, a refinement
    # round's (every query a chunk; rounds with fewer queries left launch
    # smaller) and the brute force's (a query against every row; its plain
    # version is not timed)
    for qa, ca, shape, reps, plain_reps, per_run in (
            (a, cands, [1, DTW_BITS_ROWS, n], (50, 100), 3, 0),
            (q, rnd, [qn, chunk, n], (50, 100), 3, launches),
            (a, rows, [1, num, n], (3, 3), 0, 0)):
        run = lambda qa=qa, ca=ca: kdtw.dtw_band(qa, ca, DTW_BAND)
        nbytes, ops = dtw_cost(shape[0] * shape[1], n, DTW_BAND)
        r = dict(name="dtw_band", route="cuda", source="src/repro_torch/kernels/csrc/dtw.cu",
                 replaces="src/repro/core/dtw.py:53 (dtw_distance; reference code "
                          "outside Pallas, no TPU kernel)",
                 shape=shape, launches=launches, max_abs_err=err,
                 ms=time_ms(run, reps=reps[0], warmup=2),
                 device_ms=device_ms(run, reps=reps[1]),
                 plain_ms=(time_ms(lambda qa=qa, ca=ca: ref.dtw_band_ref(qa, ca, DTW_BAND),
                                   reps=plain_reps) if plain_reps else None),
                 library_ms=None, bytes=nbytes, ops=ops, launches_per_run=per_run)
        _bound(r)
        log_timing(r)
        shapes.append(r)
    row = shapes.pop(0)
    out["shapes"] = [{k: r[k] for k in ("shape", "ms", "device_ms", "plain_ms", "bound_ms")}
                     for r in [row] + shapes]
    return row, shapes, out


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

    # compaction to generation 1, with _BaseRows' gathers timed (on the
    # reader thread, beside the build)
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
    out.update(compact_s=compact_s, tree_s=b["tree_seconds"], write_s=b["write_seconds"],
               gather_s=gather["s"], gather_rows=gather["rows"], gather_calls=gather["calls"])
    log(f"[store] compacted {2 * seg} journal rows into generation {hx.generation} in "
        f"{compact_s:.2f}s: tree_seconds {b['tree_seconds']}, write_seconds "
        f"{b['write_seconds']} (chunks of {b['chunk_size']}, prefetch {b['prefetch']}); "
        f"_BaseRows gathered {gather['rows']} base rows in {gather['calls']} slices in "
        f"{gather['s']:.2f}s ({gather['rows'] / max(gather['s'], 1e-9):.0f} rows/s, "
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
    t_ops = r["ops"] / FP32_FLOPS * 1e3
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
    """rwkv6-7b at full width through ``ServeEngine``. Returns the ``wkv6``
    launches of the served run and a summary."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import wkv6 as kwkv
    from repro_torch.models import get_model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_config("rwkv6-7b")
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
    eng = ServeEngine(model, cfg, params,
                      ServeConfig(max_seq=LM_PROMPT + LM_NEW + 8, batch_slots=LM_SLOTS,
                                  max_new_tokens=LM_NEW))
    eng.submit(prompts[0, :16])          # warm-up: cuBLAS set-up, the bf16 weight copies
    eng.run()
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
            "rg_lru_scan": krg.rg_lru_scan.launches}


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


def _serve_lm(tag: str, cfg, model, params, want: dict, profile: bool = False) -> dict:
    """LM_REQUESTS random LM_PROMPT-token prompts (seed 0) through
    ``ServeEngine`` in waves of LM_SLOTS, LM_NEW new tokens each, after a
    warm-up request (cuBLAS set-up, the weights' compute-dtype copies). The
    served run's kernel launches must equal ``want`` (a kernel not named
    there: 0). Then the same waves step by step through ``prefill`` /
    ``decode_step``, timed: every logit finite, the tokens the engine's.
    ``profile`` traces a prefill wave and a decode step. Returns the
    summary; the peak is since the caller's last reset."""
    import numpy as np
    import torch
    from repro_torch.serve import ServeConfig, ServeEngine

    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT))
    eng = ServeEngine(model, cfg, params,
                      ServeConfig(max_seq=LM_PROMPT + LM_NEW + 8, batch_slots=LM_SLOTS,
                                  max_new_tokens=LM_NEW))
    eng.submit(prompts[0, :16])
    eng.run()
    rids = [eng.submit(p) for p in prompts]
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _all_launches()
    tokens = sum(len(out[r]) for r in rids)
    log(f"[{tag}] served {len(out)} requests, {tokens} tokens in {run_s:.3f}s "
        f"({tokens / run_s:.1f} tok/s); the port's kernels launched {launches} (want "
        f"{want or 'none'}; attention, MLPs, experts and head are torch ops)")
    check(all(c == want.get(k, 0) for k, c in launches.items()),
          f"{cfg.name}: kernel launches {launches} in the served run, not {want or 'none'}")
    check(sorted(out) == rids and all(len(out[r]) == LM_NEW for r in rids),
          "the engine did not return LM_NEW tokens for every request")

    toks = torch.from_numpy(prompts.astype(np.int32)).cuda()
    prefill_ms, decode_ms = [], []
    with torch.no_grad():
        for w0 in range(0, LM_REQUESTS, LM_SLOTS):
            cache = model.init_cache(cfg, LM_SLOTS, LM_PROMPT + LM_NEW, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = model.prefill(params, {"tokens": toks[w0:w0 + LM_SLOTS]}, cfg, cache)
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
            batch = {"tokens": toks[:LM_SLOTS]}
            trace(f"{cfg.name} prefill of a 4 x {LM_PROMPT} wave",
                  lambda: model.prefill(params, batch, cfg,
                                        model.init_cache(cfg, LM_SLOTS, LM_PROMPT + 2, "cuda")))
            lg, cache = model.prefill(params, batch, cfg,
                                      model.init_cache(cfg, LM_SLOTS, LM_PROMPT + 2, "cuda"))
            nxt = torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)
            trace(f"{cfg.name} decode step, 4 rows",
                  lambda: model.decode_step(params, nxt, cfg, cache))
    dec = sorted(decode_ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] {cfg.name} prefill of a 4 x {LM_PROMPT} wave: {prefill_ms[0]:.2f} / "
        f"{prefill_ms[1]:.2f} ms; decode step (4 rows): median {dec[len(dec) // 2]:.3f} ms, "
        f"min {dec[0]:.3f}, max {dec[-1]:.3f} over {len(dec)} steps; every logit finite; "
        f"step-by-step tokens equal the engine's; peak device memory {peak:.2f} GiB")
    return {"run_s": run_s, "tok_per_s": tokens / run_s, "prefill_ms": prefill_ms,
            "decode_ms_median": dec[len(dec) // 2], "decode_ms_min": dec[0],
            "peak_gib": peak, "launches": launches}


def phase_dense_serve(profile: bool = False):
    """minicpm-2b at its published width and depth (40 layers, bf16 compute,
    float32 parameters, random weights) through ``ServeEngine``: 8 requests
    of 512-token prompts in two waves of 4, 32 new tokens each; logits
    finite; the waves replayed step by step through ``prefill`` /
    ``decode_step`` give the engine's tokens. Returns the phase's summary."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = get_config(DENSE_ARCH)
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


def phase_dense_cpu_agreement():
    """The card against the CPU: minicpm-2b at full width and 2 layers in
    float32 (forward logits, the train step's loss and metrics within 1e-4,
    each gradient within 1e-4 of its tensor's largest magnitude, the grad
    norm within 1e-4 relative; AdamW on the card's gradients within 1e-6);
    a smoke-size checkpoint written on the card, reloaded and trained on,
    within 1e-6 of an uninterrupted run; the retrieval example's path on
    the card, exact against brute force, ``lb_sax_matrix`` launched."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import common as C
    from repro_torch.models import get_model
    from repro_torch.train import (AdamWConfig, TrainConfig, adamw_init, adamw_update,
                                   load_checkpoint, make_train_step, save_checkpoint)
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import init_train_state

    cfg = dataclasses.replace(get_config(DENSE_ARCH), num_layers=2, dtype="float32")
    model = get_model(cfg)
    tcfg = TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT))
    gpu = model.init(torch.Generator(device="cuda").manual_seed(1), cfg)
    cpu = model.params_from_numpy(C.stack_tree(gpu.tree()), cfg, "cpu")
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

    # a smoke-size checkpoint on the card: 2 steps, save, load, 2 more,
    # against 4 straight steps
    scfg = get_smoke(DENSE_ARCH)
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
    check(err_ckpt <= 1e-6, f"training on from a checkpoint differs by {err_ckpt:.3e} from an "
                            f"uninterrupted run")
    log(f"[dense-agree] {scfg.name}: 2 steps, a checkpoint written on the card and reloaded, "
        f"2 more steps: within {err_ckpt:.3e} of 4 straight steps")

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
    """granite-moe-1b-a400m (float32 parameters) and moonshot-v1-16b-a3b (a
    serving tree: matrices held in bf16 only, 56.1 GB) at their published
    widths and depths, random weights, through ``ServeEngine`` as phase 14
    serves minicpm; capacities 168 and 64 at S=512, 8 at decode; no kernel
    of the port launches; moonshot's peak under 80 GB. ``profile`` traces a
    moonshot prefill wave and decode step. Returns the summaries by arch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.moe import moe_capacity

    out = {}
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
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


def phase_rg_lru_kernel():
    """``rg_lru_scan`` equal to its plain version ``rg_lru_scan_ref`` in
    every bit on the card (and to the plain version on the CPU) at the
    Griffin path's prefill (4, 512, 2560) shape with a nonzero h0, its
    decode shape (T=1), a ragged shape and T=0; host-loop and CUDA-graph
    times at both main shapes beside the plain version's and the bound.
    Returns the kernel's rows at the prefill and decode shapes (their
    launches are filled in by phase 20)."""
    import torch
    from repro_torch.kernels import ref, rg_lru as krg

    g = torch.Generator(device="cuda").manual_seed(19)
    args = {}
    for kind, shape in {**RG_SHAPES, "ragged": (3, 37, 77), "empty": (2, 0, 5)}.items():
        b, t, r = shape
        a = torch.rand((b, t, r), generator=g, device="cuda")
        gated = torch.randn((b, t, r), generator=g, device="cuda")
        h0 = torch.randn((b, r), generator=g, device="cuda")
        args[kind] = (a, gated, h0)
        got = krg.rg_lru_scan(a, gated, h0)
        for name, x, want, cpu in zip(("y", "hT"), got, ref.rg_lru_scan_ref(a, gated, h0),
                                      ref.rg_lru_scan_ref(a.cpu(), gated.cpu(), h0.cpu())):
            bad = int((words32(x) != words32(want)).sum())
            check(bad == 0, f"rg_lru_scan {kind} {shape}: {bad} {name} words differ from "
                            f"rg_lru_scan_ref on the card")
            bad = int((words32(x).cpu() != words32(cpu)).sum())
            check(bad == 0, f"rg_lru_scan {kind} {shape}: {bad} {name} words differ from "
                            f"rg_lru_scan_ref on the CPU")
    torch.cuda.synchronize()
    log(f"[rg_lru] rg_lru_scan equals rg_lru_scan_ref bit for bit (on the card and on the "
        f"CPU) at {RG_SHAPES['prefill']} with a nonzero h0, {RG_SHAPES['decode']}, "
        f"(3, 37, 77) and T=0")
    by_shape = {}
    for kind, shape in RG_SHAPES.items():
        a = args[kind]
        nbytes, ops = _rg_cost(*shape)
        reps = 50 if kind == "prefill" else 500
        r = dict(shape=list(shape), bytes=nbytes, ops=ops,
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
        f"{kind} {r['shape']} {r['ms']:.4f} / {r['device_ms']:.4f} / {r['plain_ms']:.4f} "
        f"({r['bound_ms']:.5f} by {r['bound_by']}, {r['bound_ms'] / r['device_ms']:.1%})"
        for kind, r in by_shape.items()))
    return rows


def phase_griffin_serve(profile: bool = False):
    """recurrentgemma-2b at its published width and depth (26 layers, 18
    recurrent, window 2048; float32 parameters, bf16 compute, random
    weights) through ``ServeEngine`` as phase 14 serves minicpm;
    ``rg_lru_scan`` must launch 18 x (1 + 31) x 2 = 1,152 times in the
    served run. Returns the summary."""
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


def _card_vs_cpu_train(cfg, model, gpu, cpu, tag: str, what: str):
    """Forward logits and aux, the train step's metrics and gradients of
    ``gpu`` (on the card) against ``cpu`` (the same weights on the CPU), in
    float32, B=2 S=32: logits, aux and metrics within 1e-4, each gradient
    within 1e-4 of its tensor's largest magnitude. Returns (errors, the
    card's gradients, the CPU's)."""
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
    grad_fn = make_grad_fn(model, cfg, TrainConfig())
    mg, gg = grad_fn(gpu, {k: v.cuda() for k, v in batch.items()})
    mc, gc = grad_fn(cpu, batch)
    for k in mc:
        assert_close(mg[k], mc[k], "float32", f"{what}: train-step metric {k}, card vs CPU")
    worst = 0.0
    for (path, gs), (_, cs) in zip(C.leaf_groups(gg), C.leaf_groups(gc)):
        for a, b in zip(gs, cs):
            rel = float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            worst = max(worst, rel)
            check(rel <= 1e-4, f"{what}: gradient {'/'.join(path)}, card vs CPU differ by "
                               f"{rel:.3e} of its largest magnitude")
    log(f"[{tag}] {what}, float32, B=2 S=32: logits max abs err {err:.3e}, aux "
        f"{float(ag):.6f} vs {float(ac):.6f}, "
        + ", ".join(f"{k} {float(mg[k]):.6f} vs {float(mc[k]):.6f}"
                    for k in ("loss", "moe_aux") if k in mc)
        + f", gradients within {worst:.3e} of each tensor's largest magnitude")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-series", type=int, default=FULL_SERIES)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--profile", action="store_true",
                    help="also trace 16 queries per backend, a prefill wave and a "
                         "decode step of rwkv6-7b, of minicpm-2b and of "
                         "moonshot-v1-16b-a3b, and a minicpm-2b train step, with "
                         "torch.profiler")
    ap.add_argument("--disk-dir", default=None,
                    help="directory for the disk phase's index (default: a new "
                         "temporary directory); removed at the end")
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
            dtw_row, dtw_shapes, summary["dtw"] = timed("dtw", phase_dtw, queries, local)
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
    rows += [disk_row, ooc_min_row, dtw_row]
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
    for r in rg_rows:
        r["launches"] = summary["griffin_serve"]["launches"]["rg_lru_scan"]
    rows += rg_rows
    summary["moe_griffin_agree"] = timed("moe_griffin_agree", phase_moe_griffin_cpu_agreement)
    log(f"[moe] phases 17-21 took {phase_s['moe_serve']} / {phase_s['moe_train']} / "
        f"{phase_s['rg_lru']} / {phase_s['griffin_serve']} / {phase_s['moe_griffin_agree']}s")
    log(f"[main] summary {json.dumps(summary)}")
    log(f"[done] {time.perf_counter() - t_start:.1f}s; by phase (s): {phase_s}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "bytes", "ops",
            "device_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
