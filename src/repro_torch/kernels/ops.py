"""Engine-facing kernel entry points with mode dispatch.

Each function resolves ``mode`` (``auto | cuda | ref``, see
:mod:`repro_torch.kernels.compat`) against the device of its tensors and
runs either the hand-written CUDA kernel or its plain PyTorch version. The
CUDA kernels mask their own ragged edges, so unlike the reference's
wrappers nothing is padded to block multiples here.
"""
from __future__ import annotations

import torch

from repro_torch.core import summaries as S
from repro_torch.kernels import ed as _ed
from repro_torch.kernels import lb_sax as _lb
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.compat import resolve_kernel_mode


def _device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise ValueError("kernel operands live on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    return dev


def ed_matrix(queries: torch.Tensor, series: torch.Tensor, *,
              mode: str = "auto") -> torch.Tensor:
    """(Q, n) x (N, n) -> (Q, N) float32 squared ED."""
    if resolve_kernel_mode(mode, _device(queries, series)) == "ref":
        return _ref.ed_matrix_ref(queries, series)
    return _ed.ed_matrix(queries.to(torch.float32).contiguous(), series.contiguous())


def ed_min(queries: torch.Tensor, series: torch.Tensor, *,
           valid_n: int | None = None,
           mode: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Fused 1-NN: ((Q,) min squared ED, (Q,) int32 argmin over N)."""
    if resolve_kernel_mode(mode, _device(queries, series)) == "ref":
        return _ref.ed_min_ref(queries, series, valid_n=valid_n)
    return _ed.ed_min(queries.to(torch.float32).contiguous(), series.contiguous(),
                      valid_n=valid_n)


def lb_sax_matrix(q_paa: torch.Tensor, codes: torch.Tensor, series_len: int, *,
                  alphabet: int = S.SAX_ALPHABET,
                  mode: str = "auto") -> torch.Tensor:
    """(Q, m) x (N, m) uint8 -> (Q, N) float32 squared LB_SAX."""
    if resolve_kernel_mode(mode, _device(q_paa, codes)) == "ref":
        return _ref.lb_sax_matrix_ref(q_paa, codes, series_len, alphabet=alphabet)
    return _lb.lb_sax_matrix(q_paa.to(torch.float32).contiguous(),
                             codes.contiguous(), series_len, alphabet=alphabet)


# the engine-facing short name (core/search.py's pruning call site)
lb_sax = lb_sax_matrix
