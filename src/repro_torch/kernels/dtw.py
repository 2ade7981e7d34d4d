"""Launch wrapper of the hand-written banded-DTW kernels (``csrc/dtw.cu``;
the hot loop of ``repro/core/dtw.py``'s ``dtw_distance``, which the
reference computes outside Pallas).

:func:`dtw_band` follows ``kernel_mode`` by tensor device like
``kernels/ops.py``: a CPU tensor takes the plain version
``kernels/ref.py::dtw_band_ref``, a CUDA tensor launches a kernel or
raises. Kernels and plain version agree bit for bit (each DP cell is one
rounded add of an exact minimum). ``dtw_band.launches`` counts kernel
launches.

Which kernel a call launches is :func:`_plan`'s choice from the call's
pair count, length and band: v2 (the DP band in registers) one thread a
pair where the pairs fill the card, or ``lanes`` lanes of a warp a pair
where they do not; v1 (the DP row in shared memory) for bands wider than
v2's largest instance. :func:`dtw_band_as` launches a given choice (the
card's tests and ``tools/kernel_ab.py`` hold every instance to the plain
version).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.compat import count_launch, resolve_kernel_mode

MAX_QUERIES = 65535     # queries a launch (the grid's y extent)
ROW_BANDS = (8, 16, 32)     # dtw_rows_kernel's instances (2 band + 1 cells a thread)
LANES = (16, 32)            # dtw_lanes_kernel's lanes a pair
LANE_MAX_BAND = 31          # its widest instance: 64 cells a pair
# Where each kernel is fastest (tools/kernel_ab.py --kernel dtw on the H100,
# n = 256, band 13): one thread a pair from 16,384 pairs up (0.0770 ms there
# against 0.0947 for 16 lanes; 8,192 pairs: 0.0758 against 0.0543), 16
# lanes at 4,096 to 8,192 pairs, 32 lanes at 1,024 (0.0225 ms against
# 0.0269 for 16); 2, 4 and 8 lanes were slower than one of these
# everywhere. At band 0 a pair's row is one cell, so lanes only idle: one
# thread a pair there (1 x 4,096: 0.0253 ms against 0.0321).
LANE_PAIRS = 1 << 14
WIDE_LANE_PAIRS = 2048      # up to here 32 lanes a pair, then 16
_LANE_BLOCK = 128           # dtw_lanes_kernel's threads a block: 256 / lanes pairs
_SMEM_MAX = 232448          # shared memory a block may opt in to (227 KB)


def _lane_smem(n: int, lanes: int) -> int:
    """Bytes of shared memory a lane block holds (``csrc/dtw.cu``
    ``lane_smem_bytes``): the query row and its 2 * 128 / lanes candidate
    rows, zero-padded by 64 + 32 and 64 + 96 columns."""
    return 4 * ((n + 160) * (2 * _LANE_BLOCK // lanes) + n + 64)


def _plan(pairs: int, n: int, band: int) -> tuple[str, int]:
    """(variant, lanes) of a call of ``pairs`` (query, candidate) pairs of
    length ``n``: ``("v1", 1)`` when the band (clamped to ``n - 1``) passes
    v2's largest instance, else ``("v2", lanes)``: 1 (a thread a pair) when
    ``pairs >= LANE_PAIRS``, the band is 0 or passes ``LANE_MAX_BAND``, else 32
    lanes up to ``WIDE_LANE_PAIRS`` pairs and 16 above, or the other of the
    two where a block's rows do not fit in shared memory (1 if neither
    does)."""
    b = min(band, max(n - 1, 0))
    if b > ROW_BANDS[-1]:
        return "v1", 1
    if pairs >= LANE_PAIRS or b == 0 or b > LANE_MAX_BAND:
        return "v2", 1
    for lanes in ((32, 16) if pairs <= WIDE_LANE_PAIRS else (16, 32)):
        if _lane_smem(n, lanes) <= _SMEM_MAX:
            return "v2", lanes
    return "v2", 1


def dtw_band(query: torch.Tensor, cands: torch.Tensor, band: int, *,
             mode: str = "auto") -> torch.Tensor:
    """Sakoe-Chiba-banded DTW, squared local costs: a query (n,) against
    candidates (..., n) -> (...), or queries (Q, n) against their own
    candidates (Q, B, n) -> (Q, B); float32 out."""
    return _dtw_band(query, cands, band, mode, None)


def dtw_band_as(query: torch.Tensor, cands: torch.Tensor, band: int, variant: str,
                lanes: int = 1) -> torch.Tensor:
    """:func:`dtw_band` on CUDA tensors through the given kernel: ``variant``
    "v1" or "v2", ``lanes`` 1 or one of :data:`LANES` (v2 only). Raises
    where no instance takes the band (after clamping it to ``n - 1``)."""
    if variant not in ("v1", "v2") or (variant == "v1" and lanes != 1) \
            or lanes not in (1, *LANES):
        raise ValueError(f"dtw_band: no kernel {variant!r} with {lanes} lanes")
    return _dtw_band(query, cands, band, "cuda", (variant, lanes))


def _dtw_band(query, cands, band, mode, plan):
    if band < 0:
        raise ValueError(f"dtw_band: band={band} must be >= 0")
    if query.device != cands.device:
        raise ValueError("dtw_band operands live on different devices: "
                         f"{query.device} and {cands.device}")
    if resolve_kernel_mode(mode, query.device) == "ref":
        return _ref.dtw_band_ref(query, cands, band)
    q, c, shape = _ref.dtw_operands(query, cands)
    qn, num, n = c.shape
    if qn > MAX_QUERIES:
        raise ValueError(f"dtw_band kernel takes at most {MAX_QUERIES} queries a "
                         f"launch; got {qn}")
    if num >= 2**31:
        raise ValueError("dtw_band kernel takes fewer than 2**31 candidates a query")
    out = torch.empty((qn, num), dtype=torch.float32, device=q.device)
    if qn * num == 0:
        return out.reshape(shape)
    if n == 0:
        raise ValueError("dtw: series of length 0")
    b = min(band, n - 1)
    variant, lanes = plan or _plan(qn * num, n, b)
    q, c = q.contiguous(), c.contiguous()
    lib = _build.library("dtw")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if variant == "v1":
        err = lib.dtw_band_f32(q.data_ptr(), c.data_ptr(), out.data_ptr(), qn, num, n, b,
                               stream)
    else:
        err = lib.dtw_band_v2_f32(q.data_ptr(), c.data_ptr(), out.data_ptr(), qn, num, n, b,
                                  lanes, stream)
    if err == -1:
        raise ValueError(f"dtw_band kernel {variant} ({lanes} lanes): n={n}, band={band} "
                         "fits no instance")
    _build.check(err, "dtw_band")
    count_launch(dtw_band)
    return out.reshape(shape)


dtw_band.launches = 0
