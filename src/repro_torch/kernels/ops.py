"""Engine-facing kernel entry points with mode dispatch.

Each function resolves ``mode`` (``auto | cuda | ref``, see
:mod:`repro_torch.kernels.compat`) against the device of its tensors and
runs either the hand-written CUDA kernel or its plain PyTorch version. The
CUDA kernels mask their own ragged edges (and ``wkv6`` and ``rg_lru_scan``
loop over any T),
so unlike the reference's wrappers nothing is padded to block multiples
here.
"""
from __future__ import annotations

import torch

from repro_torch.core import summaries as S
from repro_torch.kernels import ed as _ed
from repro_torch.kernels import lb_sax as _lb
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rg_lru as _rg_lru
from repro_torch.kernels import wkv6 as _wkv6
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


def decode_bf16_ed_matrix(queries: torch.Tensor, payload: torch.Tensor, *,
                          mode: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bf16 decode + squared ED: (Q, n) x (B, 2n) uint8 -> ((Q, B)
    squared ED, (B,) squared norms of the decoded rows).

    ``payload`` is the byte image of bfloat16 rows (the prefix of bf16-codec
    rows, a strided view is fine). The kernel reads it in place and widens
    each element as it stages a tile, so decoded float32 rows never reach
    device memory; the plain version decodes, then sums directly."""
    if resolve_kernel_mode(mode, _device(queries, payload)) == "ref":
        rows = _ref.decode_bf16_ref(payload)
        return _ref.ed_matrix_ref(queries, rows), S.fixed_order_sum(rows * rows)
    return _ed.decode_bf16_ed_matrix(queries.to(torch.float32).contiguous(), payload)


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


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor, *,
         mode: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence: r, k, w (B, T, H, K); v (B, T, H, V); u (H, K);
    state (B, H, K, V) -> (out (B, T, H, V) in r's dtype, final state
    float32). Any T >= 0: the reference pads a ragged T with identity steps
    for its chunked kernel, which changes no result."""
    if resolve_kernel_mode(mode, _device(r, k, v, w, u, state)) == "ref":
        return _ref.wkv6_ref(r, k, v, w, u, state)
    return _wkv6.wkv6(r, k, v, w, u, state)


def rg_lru_scan(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor, *,
                mode: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU's scan ``h_t = a_t * h_{t-1} + g_t``: a, g (B, T, R), h0
    (B, R), float32 -> (y (B, T, R), hT (B, R)) float32. Kernel and plain
    version agree bit for bit."""
    if resolve_kernel_mode(mode, _device(a, g, h0)) == "ref":
        return _ref.rg_lru_scan_ref(a, g, h0)
    return _rg_lru.rg_lru_scan(a, g, h0)
