"""Lower-bounding distances LB_EAPCA and LB_SAX (paper §2, §3.4).

Port of ``repro/core/lower_bounds.py``. Both bounds are guaranteed lower
bounds on the squared Euclidean distance; see the reference module for the
derivations. Sums over segments and over the series axis use
:func:`~repro_torch.core.summaries.fixed_order_sum`, so a bound or a
distance rounds the same on every device and in every path that computes it.
"""
from __future__ import annotations

import torch

from repro_torch.core import summaries as S


# ---------------------------------------------------------------------------
# LB_EAPCA
# ---------------------------------------------------------------------------

def lb_eapca_node(q_means: torch.Tensor, q_stds: torch.Tensor,
                  synopsis: torch.Tensor, seg_lens: torch.Tensor) -> torch.Tensor:
    """Squared LB_EAPCA between query segment stats (..., M) and node
    synopses (..., M, 4) with segment lengths (..., M). Returns (...,)."""
    mu_lo, mu_hi = synopsis[..., 0], synopsis[..., 1]
    sd_lo, sd_hi = synopsis[..., 2], synopsis[..., 3]
    dmu = torch.maximum(mu_lo - q_means, q_means - mu_hi).clamp_min(0.0)
    dsd = torch.maximum(sd_lo - q_stds, q_stds - sd_hi).clamp_min(0.0)
    per_seg = seg_lens * (dmu * dmu + dsd * dsd)
    return S.fixed_order_sum(per_seg)


def lb_eapca_series(q_means: torch.Tensor, q_stds: torch.Tensor,
                    s_means: torch.Tensor, s_stds: torch.Tensor,
                    seg_lens: torch.Tensor) -> torch.Tensor:
    """Squared LB_EAPCA between query and per-series EAPCA stats (..., M)."""
    dm = s_means - q_means
    ds = s_stds - q_stds
    return S.fixed_order_sum(seg_lens * (dm * dm + ds * ds))


# ---------------------------------------------------------------------------
# LB_SAX (MINDIST)
# ---------------------------------------------------------------------------

def lb_sax(q_paa: torch.Tensor, codes: torch.Tensor, series_len: int,
           alphabet: int = S.SAX_ALPHABET) -> torch.Tensor:
    """Squared LB_SAX between query PAA (..., m) and uint8 iSAX codes
    (..., m), broadcasting; returns the broadcast shape minus the last axis.

    The plain form of the ``lb_sax_matrix`` kernel: the kernel computes the
    same per-segment terms and folds them in the same order, so both give
    the same bits."""
    m = q_paa.shape[-1]
    lo, hi = S.isax_cell_bounds(codes, alphabet)
    d = torch.maximum(lo - q_paa, q_paa - hi).clamp_min(0.0)
    return (series_len / m) * S.fixed_order_sum(d * d)


# ---------------------------------------------------------------------------
# True distances
# ---------------------------------------------------------------------------

def squared_ed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact squared Euclidean distance along the last axis (broadcasting),
    in difference form ``sum((a - b)^2)`` -- the arithmetic of every exact
    answer the port reports."""
    d = a - b
    return S.fixed_order_sum(d * d)


def squared_ed_matrix(queries: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """(Q, n) x (N, n) -> (Q, N) squared ED via the matmul identity
    ``||q||^2 + ||s||^2 - 2 q.s`` (float32, TF32 off), clamped at 0."""
    q = queries.to(torch.float32)
    s = series.to(torch.float32)
    qn = S.fixed_order_sum(q * q)
    sn = S.fixed_order_sum(s * s)
    d = qn[:, None] + sn[None, :] - 2.0 * (q @ s.T)
    return d.clamp_min(0.0)
