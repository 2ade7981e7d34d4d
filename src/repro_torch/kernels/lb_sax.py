"""Launch wrapper of the hand-written LB_SAX (MINDIST) kernel
(``csrc/lb_sax.cu``; replaces ``repro/kernels/lb_sax.py::lb_sax_matrix``).

CUDA tensors only: the plain version is ``kernels/ref.py::lb_sax_matrix_ref``
and ``kernels/ops.py`` chooses between them. ``lb_sax_matrix.launches``
counts kernel launches.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import summaries as S
from repro_torch.kernels import _build
from repro_torch.kernels.compat import count_launch

SUPPORTED_SEGMENTS = (8, 16)


@functools.lru_cache(maxsize=8)
def bound_tables(alphabet: int, device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-symbol cell bound tables ``(lo, hi)``, each (alphabet,) float32,
    built as ``repro/kernels/lb_sax.py::_bound_tables`` builds them."""
    big = torch.tensor([3.0e38], dtype=torch.float32)
    bps = S.sax_breakpoints(alphabet)
    lo = torch.cat([-big, bps]).to(device)
    hi = torch.cat([bps, big]).to(device)
    return lo, hi


def lb_sax_matrix(q_paa: torch.Tensor, codes: torch.Tensor, series_len: int,
                  alphabet: int = S.SAX_ALPHABET) -> torch.Tensor:
    """(Q, m) float32 PAA x (N, m) uint8 codes -> (Q, N) float32 squared
    LB_SAX, on the CUDA device."""
    if q_paa.device.type != "cuda" or codes.device != q_paa.device:
        raise ValueError("lb_sax_matrix kernel needs both tensors on one CUDA "
                         f"device; got {q_paa.device} and {codes.device}")
    if q_paa.dtype != torch.float32 or codes.dtype != torch.uint8:
        raise TypeError(f"lb_sax_matrix takes float32 PAA and uint8 codes; got "
                        f"{q_paa.dtype} and {codes.dtype}")
    if q_paa.ndim != 2 or codes.ndim != 2 or q_paa.shape[1] != codes.shape[1]:
        raise ValueError(f"lb_sax_matrix shapes {tuple(q_paa.shape)} x "
                         f"{tuple(codes.shape)}; expected (Q, m) x (N, m)")
    m = codes.shape[1]
    if m not in SUPPORTED_SEGMENTS:
        raise ValueError(f"lb_sax_matrix kernel takes m in {SUPPORTED_SEGMENTS}; "
                         f"got m={m}")
    if not 2 <= alphabet <= 256:
        raise ValueError(f"alphabet={alphabet}; the kernel takes 2..256")
    if not (q_paa.is_contiguous() and codes.is_contiguous()):
        raise ValueError("lb_sax_matrix kernel takes contiguous tensors")
    if codes.data_ptr() % m:
        raise ValueError(f"lb_sax_matrix kernel needs {m}-byte aligned codes")
    qn, num = q_paa.shape[0], codes.shape[0]
    out = torch.empty((qn, num), dtype=torch.float32, device=q_paa.device)
    if qn == 0 or num == 0:
        return out
    lo, hi = bound_tables(alphabet, q_paa.device)
    lib = _build.library("lb_sax")
    err = lib.lb_sax_matrix_f32(
        q_paa.data_ptr(), codes.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        out.data_ptr(), qn, num, m, alphabet, series_len / m,
        torch.cuda.current_stream(q_paa.device).cuda_stream)
    _build.check(err, "lb_sax_matrix")
    count_launch(lb_sax_matrix)
    return out


lb_sax_matrix.launches = 0
