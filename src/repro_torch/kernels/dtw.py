"""Launch wrapper of the hand-written banded-DTW kernel (``csrc/dtw.cu``;
the hot loop of ``repro/core/dtw.py``'s ``dtw_distance``, which the
reference computes outside Pallas).

:func:`dtw_band` follows ``kernel_mode`` by tensor device like
``kernels/ops.py``: a CPU tensor takes the plain version
``kernels/ref.py::dtw_band_ref``, a CUDA tensor launches the kernel or
raises. Kernel and plain version agree bit for bit (each DP cell is one
rounded add of an exact minimum). ``dtw_band.launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.compat import count_launch, resolve_kernel_mode

MAX_QUERIES = 65535     # queries a launch (the grid's y extent)


def dtw_band(query: torch.Tensor, cands: torch.Tensor, band: int, *,
             mode: str = "auto") -> torch.Tensor:
    """Sakoe-Chiba-banded DTW, squared local costs: a query (n,) against
    candidates (..., n) -> (...), or queries (Q, n) against their own
    candidates (Q, B, n) -> (Q, B); float32 out."""
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
    q, c = q.contiguous(), c.contiguous()
    err = _build.library("dtw").dtw_band_f32(
        q.data_ptr(), c.data_ptr(), out.data_ptr(), qn, num, n, min(band, n - 1),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err == -1:
        raise ValueError(f"dtw_band kernel: n={n}, band={band} needs more shared "
                         "memory than one block has")
    _build.check(err, "dtw_band")
    count_launch(dtw_band)
    return out.reshape(shape)


dtw_band.launches = 0
