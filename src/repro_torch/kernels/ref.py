"""Plain PyTorch versions of every hand-written kernel.

Each mirrors one kernel's contract (shapes, dtypes, masking) with
straight-line tensor code in the direct-sum form of
``repro/kernels/ref.py`` (``wkv6_ref``: a plain loop over T). They are what
a CPU tensor runs, and what the card checks each kernel against. Work over the series axis is cut into row
blocks so the ``(Q, rows, n)`` difference tensor stays bounded at the main
path's shapes; blocking changes no arithmetic (each output element is one
row's fixed-order sum).
"""
from __future__ import annotations

import torch

from repro_torch.core import lower_bounds as LB
from repro_torch.core import summaries as S

_BLOCK_ELEMS = 1 << 26      # elements of one (Q, rows, n) difference block


def _row_block(q: int, width: int) -> int:
    return max(1, _BLOCK_ELEMS // max(1, q * width))


def ed_matrix_ref(queries: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """(Q, n) x (N, n) -> (Q, N) float32 squared ED, direct-sum form."""
    q = queries.to(torch.float32)
    qn, n = q.shape
    num = series.shape[0]
    out = torch.empty((qn, num), dtype=torch.float32, device=q.device)
    step = _row_block(qn, n)
    for lo in range(0, num, step):
        s = series[lo:lo + step].to(torch.float32)
        out[:, lo:lo + s.shape[0]] = LB.squared_ed(q[:, None, :], s[None, :, :])
    return out


def ed_min_ref(queries: torch.Tensor, series: torch.Tensor,
               valid_n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused 1-NN: ((Q,) min squared ED, (Q,) int32 argmin). Rows at or past
    ``valid_n`` never win; ties and all-inf rows resolve to the lowest index."""
    d = ed_matrix_ref(queries, series)
    if valid_n is not None:
        d[:, valid_n:] = float("inf")
    dmin, amin = torch.min(d, dim=1)
    return dmin, amin.to(torch.int32)


def decode_bf16_ref(payload: torch.Tensor) -> torch.Tensor:
    """(B, 2n) uint8 bfloat16 payload -> (B, n) float32 rows.

    The payload is the byte image of little-endian bfloat16 rows (the bf16
    codec's row prefix, possibly a strided view); the widening is exact."""
    num, twon = payload.shape
    return payload.contiguous().view(torch.bfloat16).reshape(num, twon // 2) \
        .to(torch.float32)


def decode_bf16_ed_matrix_ref(queries: torch.Tensor,
                              payload: torch.Tensor) -> torch.Tensor:
    """Fused decode + ED: (Q, n) x (B, 2n) uint8 -> (Q, B) float32 squared
    ED against the decoded rows, direct-sum form."""
    return ed_matrix_ref(queries, decode_bf16_ref(payload))


def lb_sax_matrix_ref(q_paa: torch.Tensor, codes: torch.Tensor, series_len: int,
                      alphabet: int = S.SAX_ALPHABET) -> torch.Tensor:
    """(Q, m) PAA x (N, m) uint8 codes -> (Q, N) squared LB_SAX (MINDIST)."""
    q = q_paa.to(torch.float32)
    qn, m = q.shape
    num = codes.shape[0]
    out = torch.empty((qn, num), dtype=torch.float32, device=q.device)
    step = _row_block(qn, m)
    for lo in range(0, num, step):
        c = codes[lo:lo + step]
        out[:, lo:lo + c.shape[0]] = LB.lb_sax(q[:, None, :], c[None, :, :],
                                               series_len, alphabet)
    return out


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence, a plain loop over T (``repro/kernels/ref.py::wkv6_ref``).

    r, k, w (B, T, H, K); v (B, T, H, V); u (H, K); state (B, H, K, V).
    Per step ``out_t = r_t . (S + diag(u) k_t v_t^T)`` and
    ``S = diag(w_t) S + k_t v_t^T``, all in float32; ``w == 0`` is an exact
    reset to ``k_t v_t^T`` (never ``0 * S``, which turns an overflowed state
    into NaN). Returns (out (B, T, H, V) in r's dtype, final state float32).
    """
    b, t, h, _ = r.shape
    out = torch.empty((b, t, h, v.shape[-1]), dtype=r.dtype, device=r.device)
    s = state.to(torch.float32, copy=True)
    uu = u.to(torch.float32)[None, :, :, None]
    for i in range(t):
        rt, kt = r[:, i].to(torch.float32), k[:, i].to(torch.float32)
        vt, wt = v[:, i].to(torch.float32), w[:, i].to(torch.float32)
        kv = kt[..., :, None] * vt[..., None, :]                  # (B, H, K, V)
        out[:, i] = torch.einsum("bhk,bhkv->bhv", rt, s + uu * kv).to(r.dtype)
        wd = wt[..., :, None]
        s = torch.where(wd == 0.0, kv, wd * s + kv)
    return out, s
