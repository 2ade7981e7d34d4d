"""Plain PyTorch versions of every hand-written kernel.

Each mirrors one kernel's contract (shapes, dtypes, masking) with
straight-line tensor code in the direct-sum form of
``repro/kernels/ref.py``. They are what a CPU tensor runs, and what the card
checks each kernel against. Work over the series axis is cut into row
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
