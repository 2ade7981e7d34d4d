"""DTW support (paper §2: "Hercules can support any distance measure equipped
with a lower-bounding distance, e.g. DTW") on PyTorch: port of
``repro/core/dtw.py``.

* :func:`dtw_distance`: Sakoe-Chiba-banded DTW with squared local costs,
  through ``kernels/dtw.py::dtw_band`` (the hand-written kernel on a CUDA
  tensor, its plain wavefront version on a CPU one; the two agree bit for
  bit).
* :func:`keogh_envelope` / :func:`lb_keogh`: the standard lower bound, the
  candidate's distance to the query's upper/lower envelope under the band
  (LB_Keogh(q, s) <= DTW(q, s)).
* :func:`dtw_knn`: exact banded-DTW kNN over the index's LRD array: the
  LB_Keogh filter, then chunked exact refinement in ascending-LB order with
  BSF pruning, as the reference runs it per query. Here the queries of a
  call advance together, one kernel launch a round over the next chunk of
  every query still refining; each query's chunks, stopping test and merges
  are its own, so the answers are the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.core import summaries as S
from repro_torch.core.layout import HerculesLayout
from repro_torch.core.search import INF, SearchConfig, _merge_topk
from repro_torch.kernels.dtw import dtw_band

_ROW_CHUNK_ELEMS = 1 << 26      # elements of one LB_Keogh difference block


def keogh_envelope(q: torch.Tensor, band: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(lower, upper) running min/max of q within +-band. q: (..., n)."""
    lo, hi = q, q
    for _ in range(band):
        pos = lo.new_full(lo.shape[:-1] + (1,), INF)
        lo = torch.minimum(lo, torch.minimum(torch.cat([pos, lo[..., :-1]], -1),
                                             torch.cat([lo[..., 1:], pos], -1)))
        neg = hi.new_full(hi.shape[:-1] + (1,), -INF)
        hi = torch.maximum(hi, torch.maximum(torch.cat([neg, hi[..., :-1]], -1),
                                             torch.cat([hi[..., 1:], neg], -1)))
    return lo, hi


def lb_keogh(q: torch.Tensor, series: torch.Tensor, band: int) -> torch.Tensor:
    """Squared LB_Keogh of query q (n,) against series (..., n), in bounded
    row blocks (a 2**22 x 256 LRD needs no full-size temporary); each row a
    fixed-order sum, so the card's bounds equal the CPU's."""
    lo, hi = keogh_envelope(q.to(torch.float32), band)
    n = series.shape[-1]
    flat = series.reshape(-1, n)
    out = torch.empty((flat.shape[0],), dtype=torch.float32, device=series.device)
    step = max(1, _ROW_CHUNK_ELEMS // max(1, n))
    for start in range(0, flat.shape[0], step):
        x = flat[start:start + step].to(torch.float32)
        d = torch.maximum(x - hi, lo - x).clamp_min(0.0)
        out[start:start + x.shape[0]] = S.fixed_order_sum(d * d)
    return out.reshape(series.shape[:-1])


def dtw_distance(a: torch.Tensor, b: torch.Tensor, band: int) -> torch.Tensor:
    """Squared-cost DTW with a Sakoe-Chiba band. a (n,), b (..., n) -> (...)."""
    return dtw_band(a, b, band)


def dtw_knn(layout: HerculesLayout, queries: torch.Tensor, k: int, band: int,
            cfg: SearchConfig | None = None, *, stats: dict | None = None):
    """Exact banded-DTW kNN over the index's LRD array.

    LB_Keogh-ordered chunked refinement with BSF pruning (the Hercules
    phase-3/4 skeleton with DTW's lower bound). Returns (dists, layout
    positions), (Q, k) float32 and int32. Exact for the banded DTW.
    ``stats``, if given, receives ``rounds`` (kernel launches on a card),
    ``chunks`` (chunk refinements over all queries) and ``rows`` (rows
    whose DTW was computed).
    """
    cfg = cfg or SearchConfig(k=k, chunk=256)
    chunk = cfg.chunk
    lrd = layout.lrd
    n_pad = lrd.shape[0]
    if n_pad % chunk:
        raise ValueError("layout padding must divide refinement chunk")
    dev = lrd.device
    q = queries.to(device=dev, dtype=torch.float32)
    qn = q.shape[0]
    pad = torch.arange(n_pad, device=dev) >= layout.num_series
    lbs = torch.empty((qn, n_pad), dtype=torch.float32, device=dev)
    for r in range(qn):
        lbs[r] = lb_keogh(q[r], lrd, band).masked_fill_(pad, INF)
    # jnp.argsort is stable, and tie order decides which chunk a row is in
    order = torch.argsort(lbs, dim=1, stable=True)
    sorted_lb = torch.gather(lbs, 1, order)
    del lbs
    n_chunks = n_pad // chunk
    d_top = torch.full((qn, k), INF, device=dev)
    p_top = torch.full((qn, k), -1, dtype=torch.int32, device=dev)
    c = torch.zeros((qn,), dtype=torch.long, device=dev)
    cols = torch.arange(chunk, device=dev)
    rounds = chunks = 0
    while qn:
        start = c * chunk
        head = sorted_lb.gather(1, start.clamp_max(n_pad - 1)[:, None])[:, 0]
        act = ((c < n_chunks) & (head < d_top[:, k - 1])).nonzero()[:, 0]
        if act.numel() == 0:
            break
        at = start[act, None] + cols                         # (A, chunk)
        idx = order[act[:, None], at]
        d = dtw_band(q[act], lrd[idx], band, mode=cfg.kernel_mode)
        live = sorted_lb[act[:, None], at] < d_top[act, k - 1:k]
        d = torch.where(live, d, INF)
        d_top[act], p_top[act] = _merge_topk(d_top[act], p_top[act], d,
                                             idx.to(torch.int32), k)
        c[act] += 1
        rounds += 1
        chunks += int(act.numel())
    if stats is not None:
        stats.update(rounds=rounds, chunks=chunks, rows=chunks * chunk)
    return d_top, p_top
