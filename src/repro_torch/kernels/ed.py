"""Launch wrappers of the hand-written squared-ED kernels (``csrc/ed.cu``;
replace ``repro/kernels/ed.py::ed_matrix``, ``::ed_min`` and
``repro/kernels/ops.py::decode_bf16_ed_matrix``).

CUDA tensors only: the plain versions are ``kernels/ref.py`` and
``kernels/ops.py`` chooses between them. Queries are float32; series are
float32 or bfloat16 (upcast in registers), or for
:func:`decode_bf16_ed_matrix` the bf16 codec's uint8 payload, read in place
at its row pitch. The kernels mask their own ragged edges, so nothing is
padded here. ``ed_matrix.launches``, ``ed_min.launches`` and
``decode_bf16_ed_matrix.launches`` count kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_SERIES_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check(queries: torch.Tensor, series: torch.Tensor, what: str) -> str:
    if queries.device.type != "cuda" or series.device != queries.device:
        raise ValueError(f"{what} kernel needs both tensors on one CUDA device; "
                         f"got {queries.device} and {series.device}")
    if queries.dtype != torch.float32 or series.dtype not in _SERIES_DTYPES:
        raise TypeError(f"{what} takes float32 queries and float32/bfloat16 "
                        f"series; got {queries.dtype} and {series.dtype}")
    if queries.ndim != 2 or series.ndim != 2 or queries.shape[1] != series.shape[1]:
        raise ValueError(f"{what} shapes {tuple(queries.shape)} x "
                         f"{tuple(series.shape)}; expected (Q, n) x (N, n)")
    if not (queries.is_contiguous() and series.is_contiguous()):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    if max(queries.shape[0], series.shape[0]) >= 2**31:
        raise ValueError(f"{what} kernel takes fewer than 2**31 rows")
    return _SERIES_DTYPES[series.dtype]


def ed_matrix(queries: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """(Q, n) x (N, n) -> (Q, N) float32 squared ED on the CUDA device."""
    kind = _check(queries, series, "ed_matrix")
    (qn, n), num = queries.shape, series.shape[0]
    out = torch.empty((qn, num), dtype=torch.float32, device=queries.device)
    if qn == 0 or num == 0:
        return out
    fn = getattr(_build.library("ed"), f"ed_matrix_{kind}")
    err = fn(queries.data_ptr(), series.data_ptr(), out.data_ptr(), qn, num, n,
             torch.cuda.current_stream(queries.device).cuda_stream)
    _build.check(err, "ed_matrix")
    ed_matrix.launches += 1
    return out


def ed_min(queries: torch.Tensor, series: torch.Tensor,
           valid_n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused 1-NN scan: ((Q,) float32 min squared ED, (Q,) int32 argmin).
    Rows at or past ``valid_n`` (default: all rows live) never win; ties go
    to the lowest index and an all-inf row reports index 0."""
    kind = _check(queries, series, "ed_min")
    (qn, n), num = queries.shape, series.shape[0]
    valid = num if valid_n is None else int(valid_n)
    if not 0 <= valid <= num:
        raise ValueError(f"valid_n={valid_n} outside [0, {num}]")
    dev = queries.device
    dmin = torch.empty((qn,), dtype=torch.float32, device=dev)
    amin = torch.empty((qn,), dtype=torch.int32, device=dev)
    if qn == 0:
        return dmin, amin
    scratch = torch.empty((qn,), dtype=torch.int64, device=dev)
    fn = getattr(_build.library("ed"), f"ed_min_{kind}")
    err = fn(queries.data_ptr(), series.data_ptr(), scratch.data_ptr(),
             dmin.data_ptr(), amin.data_ptr(), qn, num, n, valid,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ed_min")
    ed_min.launches += 1
    return dmin, amin


def decode_bf16_ed_matrix(queries: torch.Tensor,
                          payload: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, n) float32 x (B, 2n) uint8 bf16 payload -> ((Q, B) float32 squared
    ED against the decoded rows, (B,) squared norms of the decoded rows that
    the distances used), on the CUDA device.

    ``payload`` may be any view with a unit inner stride and an even row
    pitch of at least 2n bytes, such as ``enc[:, :-4]`` of a bf16-encoded
    block (pitch 2n + 4): the kernel reads it in place, and nothing here
    copies or widens it."""
    if queries.device.type != "cuda" or payload.device != queries.device:
        raise ValueError("decode_bf16_ed_matrix kernel needs both tensors on one "
                         f"CUDA device; got {queries.device} and {payload.device}")
    if queries.dtype != torch.float32 or payload.dtype != torch.uint8:
        raise TypeError("decode_bf16_ed_matrix takes float32 queries and a uint8 "
                        f"payload; got {queries.dtype} and {payload.dtype}")
    if (queries.ndim != 2 or payload.ndim != 2
            or payload.shape[1] != 2 * queries.shape[1]):
        raise ValueError(f"decode_bf16_ed_matrix shapes {tuple(queries.shape)} x "
                         f"{tuple(payload.shape)}; expected (Q, n) x (B, 2n)")
    if not queries.is_contiguous():
        raise ValueError("decode_bf16_ed_matrix kernel takes contiguous queries")
    (qn, n), num = queries.shape, payload.shape[0]
    pitch = payload.stride(0) if num > 1 else 2 * n
    if (payload.stride(1) != 1 and n > 0) or pitch % 2 or pitch < 2 * n:
        raise ValueError(f"decode_bf16_ed_matrix needs a unit inner stride and an "
                         f"even row pitch >= {2 * n} bytes; got strides "
                         f"{payload.stride()}")
    if payload.data_ptr() % 2:
        raise ValueError("decode_bf16_ed_matrix needs a 2-byte aligned payload")
    if max(qn, num) >= 2**31:
        raise ValueError("decode_bf16_ed_matrix kernel takes fewer than 2**31 rows")
    out = torch.empty((qn, num), dtype=torch.float32, device=queries.device)
    sn = torch.empty((num,), dtype=torch.float32, device=queries.device)
    if num and (qn == 0 or n == 0):
        raise ValueError("decode_bf16_ed_matrix kernel takes Q >= 1 and n >= 1")
    if num:
        err = _build.library("ed").decode_bf16_ed_matrix(
            queries.data_ptr(), payload.data_ptr(), pitch, out.data_ptr(),
            sn.data_ptr(), qn, num, n,
            torch.cuda.current_stream(queries.device).cuda_stream)
        _build.check(err, "decode_bf16_ed_matrix")
        decode_bf16_ed_matrix.launches += 1
    return out, sn


ed_matrix.launches = 0
ed_min.launches = 0
decode_bf16_ed_matrix.launches = 0
