"""Exact kNN query answering (paper §3.4, Algorithms 10-14) on PyTorch.

Port of ``repro/core/search.py`` (see it for the phase map). Queries run one
at a time, as the reference's ``lax.map`` runs them; the access-path choice
is a real branch on the host. :func:`wave_knn` answers a batch with its
phases 1-3 fused across the batch, bit for bit the per-query answers.
Every answer is exact.

Where the reference folds a sequence of candidate blocks into a running
top-k one block at a time (``_merge_topk`` inside ``lax.scan``), this module
may form all blocks first and take one stable top-k over the concatenation
in merge order, with each position entering once. The two agree exactly: a
block entry only enters the running top-k if it beats an entry there under
the order (distance, then merge order), the k-th entry only improves, and an
entry evicted once can never re-enter -- so the fold's result is the k
smallest entries by (distance, first merge position), which is what the
stable top-k of the concatenation returns. Ties therefore resolve as in the
reference: ``jax.lax.top_k`` and ``jnp.argsort`` put equal keys in index
order, and every selection here is a stable sort.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core import lower_bounds as LB
from repro_torch.core import summaries as S
from repro_torch.core.layout import HerculesLayout
from repro_torch.core.tree import HerculesTree, route_to_leaf
from repro_torch.kernels import ops as kops
from repro_torch.kernels.compat import KERNEL_MODES, resolve_kernel_mode

INF = float("inf")
_F32 = torch.float32
_I32 = torch.int32
_ROW_CHUNK_ELEMS = 1 << 26      # elements of one difference block
_REFINE_CHECK_EVERY = 4         # refinement chunks per host-side exit test


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Static query-answering settings (paper §4.2 Parameterization)."""
    k: int = 1
    l_max: int = 80              # approximate-phase leaf visits (paper: 80)
    eapca_th: float = 0.25       # paper: 0.25
    sax_th: float = 0.50         # paper: 0.50
    chunk: int = 1024            # phase-4 refinement chunk
    scan_block: int = 4096       # dense-scan block
    use_sax: bool = True         # False -> NoSAX ablation (EAPCA-only LBs)
    adaptive: bool = True        # False -> NoThresh ablation (always prune path)
    force_scan: bool = False     # True -> PSCAN baseline behaviour
    lb_slack: float = 1e-5       # fp32 guard: treat lb*(1-slack) as the bound
    unroll_visits: bool = False  # reference dry-run knob; no effect here
    refine_select: str = "argsort"   # 'argsort' (full sort) | 'topk'
    topk_budget_chunks: int = 32     # candidate budget C = chunks * chunk
    kernel_mode: str = "auto"    # auto | cuda | ref (kernels/compat.py)
    prefetch: str = "sync"       # out-of-core reads: sync | thread
    codec: str = "auto"          # out-of-core leaf codec

    def __post_init__(self):
        # every field is validated here: a bad value raises at construction,
        # not deep inside a kernel launch
        for field, lo in (("k", 1), ("l_max", 1), ("chunk", 1),
                          ("scan_block", 1), ("topk_budget_chunks", 1)):
            val = getattr(self, field)
            if not isinstance(val, int) or isinstance(val, bool) or val < lo:
                raise ValueError(f"{field}={val!r}; expected an int >= {lo}")
        for field in ("eapca_th", "sax_th"):
            # >1 is a legitimate knob: always below threshold -> always scan
            val = getattr(self, field)
            if not (math.isfinite(float(val)) and float(val) >= 0.0):
                raise ValueError(f"{field}={val!r}; expected a finite "
                                 "pruning threshold >= 0")
        if not 0.0 <= float(self.lb_slack) < 1.0:
            raise ValueError(f"lb_slack={self.lb_slack!r}; expected a "
                             "relative guard in [0, 1)")
        for field in ("use_sax", "adaptive", "force_scan", "unroll_visits"):
            if not isinstance(getattr(self, field), bool):
                raise ValueError(f"{field}={getattr(self, field)!r}; "
                                 "expected a bool")
        if self.refine_select not in ("argsort", "topk"):
            raise ValueError(f"refine_select={self.refine_select!r}; "
                             "expected 'argsort' or 'topk'")
        if self.kernel_mode not in KERNEL_MODES:
            raise ValueError(f"kernel_mode={self.kernel_mode!r}; expected "
                             f"one of {KERNEL_MODES}")
        # the pipeline and the codec registry own their value sets (imported
        # here, not at module level: both import this module's package)
        from repro_torch.data.pipeline import PREFETCH_MODES
        if self.prefetch not in PREFETCH_MODES:
            raise ValueError(f"prefetch={self.prefetch!r}; expected one of "
                             f"{PREFETCH_MODES}")
        from repro_torch.storage.codecs import CODEC_CHOICES
        if self.codec not in CODEC_CHOICES:
            raise ValueError(f"codec={self.codec!r}; expected one of "
                             f"{CODEC_CHOICES}")

    def pad_multiple(self) -> int:
        return math.lcm(self.chunk, self.scan_block)


def validate_runtime_config(cfg: SearchConfig, n_pad: int) -> None:
    """Any ``chunk``/``scan_block`` that divides the layout's padded row
    count ``n_pad`` is servable without a rebuild."""
    for field in ("chunk", "scan_block"):
        val = getattr(cfg, field)
        if val <= 0 or n_pad % val:
            raise ValueError(
                f"{field}={val} does not divide the padded collection size "
                f"{n_pad}; pick a divisor of {n_pad} or rebuild the index "
                f"with the target SearchConfig")


class KnnResult(NamedTuple):
    dists: torch.Tensor       # (Q, k) squared ED, ascending
    positions: torch.Tensor   # (Q, k) layout (LRD) positions
    ids: torch.Tensor         # (Q, k) original series ids
    path: torch.Tensor        # (Q,) 0=scan(eapca) 1=scan(sax) 2=pruned 3=forced
    eapca_pr: torch.Tensor    # (Q,) leaf-level pruning ratio
    sax_pr: torch.Tensor      # (Q,) series-level pruning ratio
    accessed: torch.Tensor    # (Q,) exact-distance computations performed
    visited_leaves: torch.Tensor  # (Q,)


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _stable_smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest along the last axis, ascending, ties in index order
    (``jax.lax.top_k(-d, k)``)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _merge_topk(d0, p0, d1, p1, k: int):
    """Merge candidates (d1, p1) into the running top-k (d0, p0); leading
    dims batch. A position already in the running top-k does not enter
    twice (the paper's Results array is a set)."""
    dup = (p1.unsqueeze(-2) == p0.unsqueeze(-1)).any(dim=-2)
    d1 = torch.where(dup, INF, d1)
    vals, idx = _stable_smallest(torch.cat([d0, d1], dim=-1), k)
    return vals, torch.gather(torch.cat([p0, p1], dim=-1), -1, idx)


def _row_dists(q: torch.Tensor, rows: torch.Tensor,
               index: torch.Tensor | None = None) -> torch.Tensor:
    """Difference-form squared ED of ``q`` (n,) to ``rows`` (or
    ``rows[index]``), in bounded row blocks. Returns (R,) float32."""
    total = rows.shape[0] if index is None else index.shape[0]
    step = max(1, _ROW_CHUNK_ELEMS // max(1, q.shape[-1]))
    out = torch.empty((total,), dtype=_F32, device=q.device)
    for lo in range(0, total, step):
        blk = rows[lo:lo + step] if index is None else rows[index[lo:lo + step]]
        out[lo:lo + blk.shape[0]] = LB.squared_ed(blk, q)
    return out


def _query_seg_stats(qp, qp2, endpoints):
    """Query stats under many segmentations. qp/qp2 (..., n+1), endpoints
    (L, M); returns (..., L, M) means and stds."""
    ep = endpoints.long()
    st = torch.cat([ep.new_zeros((ep.shape[0], 1)), ep[:, :-1]], dim=1)
    lens = (ep - st).to(_F32).clamp_min(1.0)
    s1 = qp[..., ep] - qp[..., st]
    s2 = qp2[..., ep] - qp2[..., st]
    mean = s1 / lens
    var = (s2 / lens - mean * mean).clamp_min(0.0)
    empty = (ep - st) <= 0
    zero = torch.zeros((), dtype=_F32, device=qp.device)
    return torch.where(empty, zero, mean), torch.where(empty, zero, S.sqrt_rn(var))


def _leaf_lbs(q: torch.Tensor, layout: HerculesLayout) -> torch.Tensor:
    """(L,) squared LB_EAPCA of the query to every leaf (+inf for empty)."""
    qp, qp2 = S.prefix_sums(q[None])
    qm, qs = _query_seg_stats(qp[0], qp2[0], layout.leaf_endpoints)
    lb = LB.lb_eapca_node(qm, qs, layout.leaf_synopsis, layout.leaf_seg_lens)
    return torch.where(layout.leaf_count <= 0, INF, lb)


def _leaf_block_ed(q: torch.Tensor, layout: HerculesLayout, ranks: torch.Tensor):
    """Exact squared ED of q to every row of the leaves ``ranks`` (V,), as
    (V, max_leaf) masked blocks (+inf past each leaf's count) and their
    layout positions."""
    offs = torch.arange(layout.max_leaf, device=q.device)
    pos = layout.leaf_start[ranks].long()[:, None] + offs[None, :]
    d = _row_dists(q, layout.lrd, pos.reshape(-1)).reshape(pos.shape)
    live = offs[None, :] < layout.leaf_count[ranks].long()[:, None]
    return torch.where(live, d, INF), pos.to(_I32)


def _visit(q: torch.Tensor, layout: HerculesLayout, visit: torch.Tensor, k: int):
    """Phase-1 leaf visits in ``visit`` order from an empty top-k. Returns
    (d_top, p_top, accessed). A leaf visited twice (the home leaf may also
    rank among the best) re-offers rows that already entered once; they
    are dropped, as the reference's duplicate suppression drops them."""
    d, pos = _leaf_block_ed(q, layout, visit)
    v = visit.shape[0]
    earlier = torch.ones((v, v), dtype=torch.bool, device=q.device).tril(-1)
    repeat = ((visit[:, None] == visit[None, :]) & earlier).any(dim=1)
    d = torch.where(repeat[:, None], INF, d)
    d0 = torch.full((k,), INF, device=q.device)
    p0 = torch.full((k,), -1, dtype=_I32, device=q.device)
    d_top, p_top = _merge_topk(d0, p0, d.reshape(-1), pos.reshape(-1), k)
    accessed = layout.leaf_count[visit].long().sum()
    return d_top, p_top, accessed


def _phase1(q, tree, layout, cfg: SearchConfig, max_depth: int):
    """Approximate search (Alg. 11): the home leaf, then the l_max leaves of
    smallest LB_EAPCA. Returns (leaf_lb, d_top, p_top, accessed, l_max)."""
    l_max = min(cfg.l_max, layout.num_leaves)
    leaf_lb = _leaf_lbs(q, layout)
    home = layout.leaf_rank[route_to_leaf(tree, q[None], max_depth).long()]
    _, best = _stable_smallest(leaf_lb, l_max)
    visit = torch.cat([home.long(), best])
    d_top, p_top, accessed = _visit(q, layout, visit, cfg.k)
    return leaf_lb, d_top, p_top, accessed, l_max


# ---------------------------------------------------------------------------
# Dense scan path (the PSCAN / skip-sequential analogue)
# ---------------------------------------------------------------------------

def _scan_path(q, layout: HerculesLayout, d0, p0, cfg: SearchConfig):
    """Exact scan over the leaf-ordered LRD rows, merged into (d0, p0).
    Returns (d_top, p_top, rows accessed)."""
    n_pad = layout.lrd.shape[0]
    d = _row_dists(q, layout.lrd)
    d[layout.num_series:] = INF
    seen = p0[p0 >= 0].long()
    d[seen] = INF                 # positions already in the running top-k
    pos = torch.arange(n_pad, dtype=_I32, device=q.device)
    d_top, p_top = _merge_topk(d0, p0, d, pos, cfg.k)
    return d_top, p_top, layout.num_series


# ---------------------------------------------------------------------------
# Pruned refinement path (phases 3-4)
# ---------------------------------------------------------------------------

def _refine_path(q, layout: HerculesLayout, cand_lb, d0, p0, cfg: SearchConfig):
    """Chunked exact refinement of candidates ordered by lower bound.

    ``cand_lb``: (N_pad,) lower bound per layout position, +inf for pruned.
    Stops when the next chunk's best LB can no longer improve BSF_k.
    ``topk`` keeps only the first C = budget candidates; the caller falls
    back to the dense scan if they run out while the BSF could still
    improve (returned ``exhausted``).

    The exit test needs the BSF on the host, so it runs once every
    ``_REFINE_CHECK_EVERY`` chunks. Answers and counts are those of the
    reference's per-chunk test: in a chunk processed after the test first
    fails, every ``lb * slack >= bsf`` (the bounds are sorted and the BSF
    cannot move while nothing is live), so no row is live and ``d_top``,
    ``p_top`` and ``accessed`` do not change; nor does ``exhausted``, whose
    bound test fails once the chunk test has.
    """
    sorted_lb, order, n_chunks = _refine_order(cand_lb, cfg)
    slack = torch.tensor(1.0 - cfg.lb_slack, dtype=_F32, device=q.device)
    k = cfg.k
    d_top, p_top = d0, p0
    acc = torch.zeros((), dtype=torch.int64, device=q.device)
    c = 0
    while c < n_chunks:
        if c % _REFINE_CHECK_EVERY == 0 and \
                not bool(sorted_lb[c * cfg.chunk] * slack < d_top[k - 1]):
            break
        sl = slice(c * cfg.chunk, (c + 1) * cfg.chunk)
        d_top, p_top, n_live = _refine_chunk(q, layout, order[sl], sorted_lb[sl], slack,
                                             d_top, p_top, k)
        acc = acc + n_live
        c += 1
    exhausted = c >= n_chunks and bool(sorted_lb[-1] * slack < d_top[k - 1])
    return d_top, p_top, acc, exhausted


def _refine_order(cand_lb, cfg: SearchConfig):
    """The candidates by lower bound, ties in position order, cut to the
    budget under ``topk``. Returns (sorted_lb, order, chunks)."""
    n_pad = cand_lb.shape[0]
    sorted_lb, order = torch.sort(cand_lb, stable=True)
    if cfg.refine_select == "topk":
        c_budget = min(n_pad, cfg.topk_budget_chunks * cfg.chunk)
        return sorted_lb[:c_budget], order[:c_budget], c_budget // cfg.chunk
    return sorted_lb, order, n_pad // cfg.chunk


def _refine_chunk(q, layout: HerculesLayout, idx, lbs, slack, d_top, p_top, k: int):
    """One refinement chunk: the rows ``idx`` whose bounds ``lbs`` can still
    beat BSF_k, merged into the top-k. Returns (d_top, p_top, rows live)."""
    live = lbs * slack < d_top[k - 1]            # Alg. 14 line 4 re-check
    d = torch.where(live, _row_dists(q, layout.lrd, idx), INF)
    d_top, p_top = _merge_topk(d_top, p_top, d, idx.to(_I32), k)
    return d_top, p_top, live.sum()


# ---------------------------------------------------------------------------
# Full per-query pipeline
# ---------------------------------------------------------------------------

def _query_one(q, tree: HerculesTree, layout: HerculesLayout,
               cfg: SearchConfig, max_depth: int):
    d_top, p_top, accessed, cand_lb, eapca_pr, sax_pr, l_max = _prune(
        q, tree, layout, cfg, max_depth)

    # ---- Adaptive access-path selection (Alg. 10) ---------------------------
    d_f, p_f, path, acc_f = _finish_one(
        q, layout, cfg, d_top, p_top, accessed, cand_lb, eapca_pr, sax_pr)
    return d_f, p_f, path, eapca_pr, sax_pr, acc_f, l_max + 1


def _prune(q, tree: HerculesTree, layout: HerculesLayout, cfg: SearchConfig,
           max_depth: int):
    """Phases 1-3 for one query: the approximate answer and each row's
    candidate bound (+inf where pruned), with no branch on a value.
    Returns (d_top, p_top, accessed, cand_lb, eapca_pr, sax_pr, l_max)."""
    n = layout.series_len
    dev = q.device
    slack = torch.tensor(1.0 - cfg.lb_slack, dtype=_F32, device=dev)

    # ---- Phase 1: approximate search (Alg. 11) ----------------------------
    leaf_lb, d_top, p_top, accessed, l_max = _phase1(q, tree, layout, cfg,
                                                      max_depth)
    bsf = d_top[cfg.k - 1]

    # ---- Phase 2: candidate leaves (Alg. 12) -------------------------------
    cand_leaf = leaf_lb * slack < bsf
    n_cand_leaves = cand_leaf.sum().to(_F32)
    n_alive = (layout.leaf_count > 0).sum().clamp_min(1).to(_F32)
    eapca_pr = 1.0 - n_cand_leaves / n_alive

    # ---- Phase 3: candidate series (Alg. 13) -------------------------------
    srank = layout.series_leaf_rank.long()
    leaf_mask_pad = torch.cat([cand_leaf, cand_leaf.new_zeros((1,))])
    series_in_cand = leaf_mask_pad[srank]

    q_paa = S.paa(q[None], layout.lsd.shape[1])[0]
    kmode = resolve_kernel_mode(cfg.kernel_mode, dev)
    if kmode == "ref":
        lb_s = LB.lb_sax(q_paa, layout.lsd, n)
    else:
        # the paper's phase-3 LSDFile stream: the LB_SAX (MINDIST) kernel
        # over the whole uint8 sidecar, one query row. LB values gate
        # pruning only (lb_slack guards rounding), so answers stay exact.
        lb_s = kops.lb_sax(q_paa[None, :], layout.lsd, n, mode=kmode)[0]
    leaf_lb_pad = torch.cat([leaf_lb, leaf_lb.new_full((1,), INF)])
    lb_leaf_series = leaf_lb_pad[srank]
    lb = torch.maximum(lb_s, lb_leaf_series) if cfg.use_sax else lb_leaf_series
    cand_lb = torch.where(series_in_cand, lb, INF)
    n_cand = (cand_lb * slack < bsf).sum().to(_F32)
    sax_pr = 1.0 - S.div_rn(n_cand, layout.num_series)
    return d_top, p_top, accessed, cand_lb, eapca_pr, sax_pr, l_max


def _finish_one(q, layout: HerculesLayout, cfg: SearchConfig,
                d_top, p_top, accessed, cand_lb, eapca_pr, sax_pr):
    """Adaptive access-path selection (Alg. 10) + exact refinement for one
    query. Returns (dists, positions, path, accessed)."""

    def do_scan():
        d, p, acc = _scan_path(q, layout, d_top, p_top, cfg)
        return d, p, accessed + acc

    def do_refine():
        d, p, acc, exhausted = _refine_path(q, layout, cand_lb, d_top, p_top, cfg)
        if cfg.refine_select == "topk" and exhausted:
            # exactness fallback: the candidate budget ran out before the
            # bound crossed BSF_k -- finish with a dense scan
            d, p, acc_s = _scan_path(q, layout, d, p, cfg)
            return d, p, acc + accessed + acc_s
        return d, p, accessed + acc

    if cfg.force_scan:
        d_f, p_f, acc_f = do_scan()
        path = 3
    elif not cfg.adaptive:
        d_f, p_f, acc_f = do_refine()
        path = 2
    else:
        below_eapca = bool(eapca_pr < cfg.eapca_th)
        below_sax = bool(sax_pr < cfg.sax_th)
        use_scan = below_eapca or (cfg.use_sax and below_sax)
        d_f, p_f, acc_f = do_scan() if use_scan else do_refine()
        path = 0 if below_eapca else (1 if below_sax else 2)
    return d_f, p_f, path, acc_f


def _ids(layout: HerculesLayout, p: torch.Tensor) -> torch.Tensor:
    safe = p.long().clamp(0, layout.perm.shape[0] - 1)
    return torch.where(p >= 0, layout.perm[safe], -1)


def _collect(layout: HerculesLayout, rows, cfg: SearchConfig,
             dev: torch.device) -> KnnResult:
    """A KnnResult from per-query (dists, positions, path, eapca_pr, sax_pr,
    accessed, visited_leaves) tuples."""
    if rows:
        d, p, path, e_pr, s_pr, acc, vis = zip(*rows)
        dists, pos = torch.stack(d), torch.stack(p)
        eapca_pr, sax_pr = torch.stack(e_pr), torch.stack(s_pr)
        accessed = torch.stack([torch.as_tensor(a, device=dev) for a in acc])
    else:
        k = cfg.k
        dists = torch.empty((0, k), dtype=_F32, device=dev)
        pos = torch.empty((0, k), dtype=_I32, device=dev)
        eapca_pr = sax_pr = torch.empty((0,), dtype=_F32, device=dev)
        accessed = torch.empty((0,), dtype=_I32, device=dev)
        path = vis = ()
    return KnnResult(
        dists=dists, positions=pos, ids=_ids(layout, pos),
        path=torch.tensor(path, dtype=_I32, device=dev),
        eapca_pr=eapca_pr, sax_pr=sax_pr, accessed=accessed.to(_I32),
        visited_leaves=torch.tensor(vis, dtype=_I32, device=dev))


def exact_knn(tree: HerculesTree, layout: HerculesLayout, queries: torch.Tensor,
              cfg: SearchConfig, max_depth: int) -> KnnResult:
    """Exact kNN for a workload of queries (Q, n). See the module docstring."""
    rows = [_query_one(q, tree, layout, cfg, max_depth) for q in queries]
    return _collect(layout, rows, cfg, queries.device)


# ---------------------------------------------------------------------------
# Wave-fused multi-query search
# ---------------------------------------------------------------------------

def _wave_leaf_lbs(queries: torch.Tensor, layout: HerculesLayout) -> torch.Tensor:
    """(W, L) squared LB_EAPCA of every wave member to every leaf (+inf for
    empty leaves): :func:`_leaf_lbs` batched. Every step is elementwise or
    a fixed-order sum along the last axis, so each row equals the
    single-query bounds bit for bit, and so does every pruning decision
    made from them."""
    qp, qp2 = S.prefix_sums(queries)                         # (W, n+1)
    qm, qs = _query_seg_stats(qp, qp2, layout.leaf_endpoints)  # (W, L, M)
    lb = LB.lb_eapca_node(qm, qs, layout.leaf_synopsis, layout.leaf_seg_lens)
    return torch.where(layout.leaf_count[None, :] <= 0, INF, lb)


def _wave_row_dists(queries: torch.Tensor, rows: torch.Tensor,
                    index: torch.Tensor) -> torch.Tensor:
    """Difference-form squared ED of member ``w`` to ``rows[index[w]]``,
    index (W, R): the arithmetic of :func:`_row_dists`, in blocks of whole
    members of at most ``_ROW_CHUNK_ELEMS`` elements. Returns (W, R)."""
    w_all, r = index.shape
    step = max(1, _ROW_CHUNK_ELEMS // max(1, r * queries.shape[-1]))
    out = torch.empty((w_all, r), dtype=_F32, device=queries.device)
    for lo in range(0, w_all, step):
        idx = index[lo:lo + step]
        blk = rows[idx.reshape(-1)].reshape(*idx.shape, rows.shape[1])
        out[lo:lo + idx.shape[0]] = LB.squared_ed(blk, queries[lo:lo + step, None, :])
    return out


def wave_knn(tree: HerculesTree, layout: HerculesLayout, queries: torch.Tensor,
             cfg: SearchConfig, max_depth: int) -> KnnResult:
    """Exact kNN for a *wave* of queries (W, n) with fused scheduling.

    Where :func:`exact_knn` runs :func:`_query_one` query by query (each
    query its own leaf visits and its own LB_SAX launch), this shares the
    work that has the same structure across the wave:

    * one tree descent for all members (``route_to_leaf`` is batched);
    * phase 1 level by level over the wave: one (W, max_leaf) gather of
      LRD rows per visit level, folded into a shared (W, k) BSF matrix
      through :func:`_merge_topk`;
    * one ``lb_sax_matrix`` launch over the (W, m) PAA matrix for phase 3.

    Per member the merge sequence (the home leaf, then the ``l_max`` best
    leaves in rank order) and all distance arithmetic are those of
    :func:`_query_one`: folding the levels one at a time keeps the k
    smallest entries by (distance, first merge position), as the stable
    top-k over all visited rows does (see the module docstring), and a
    leaf visited twice is dropped by the duplicate test or cannot re-enter.
    So answers are bit-identical to the per-query path. Phase 4 is the
    per-member :func:`_finish_one`, a real branch per member.

    Memory: phase 3 holds (W, N_pad) bound matrices where the per-query
    path holds (N_pad,) vectors; that is the wave's footprint, and why
    serving waves are bounded by ``batch_slots``. ``unroll_visits`` has no
    effect here, as in the per-query path.
    """
    if queries.shape[0] == 0:
        return exact_knn(tree, layout, queries, cfg, max_depth)
    dev = queries.device
    W = queries.shape[0]
    k = cfg.k
    n = layout.series_len
    l_max = min(cfg.l_max, layout.num_leaves)
    slack = torch.tensor(1.0 - cfg.lb_slack, dtype=_F32, device=dev)

    # ---- Phase 1: approximate search, wave-fused (Alg. 11) ----------------
    leaf_lb = _wave_leaf_lbs(queries, layout)                # (W, L)
    home = layout.leaf_rank[route_to_leaf(tree, queries, max_depth).long()]
    _, best = _stable_smallest(leaf_lb, l_max)               # (W, l_max)
    visit = torch.cat([home.long()[:, None], best], dim=1)   # (W, l_max + 1)
    d_top = torch.full((W, k), INF, device=dev)              # the shared BSF matrix
    p_top = torch.full((W, k), -1, dtype=_I32, device=dev)
    offs = torch.arange(layout.max_leaf, device=dev)
    for level in range(visit.shape[1]):
        ranks = visit[:, level]
        pos = layout.leaf_start[ranks].long()[:, None] + offs[None, :]
        d = _wave_row_dists(queries, layout.lrd, pos)        # (W, max_leaf)
        live = offs[None, :] < layout.leaf_count[ranks].long()[:, None]
        d_top, p_top = _merge_topk(d_top, p_top, torch.where(live, d, INF),
                                   pos.to(_I32), k)
    accessed = layout.leaf_count[visit].long().sum(dim=1)
    bsf = d_top[:, k - 1]

    # ---- Phase 2: candidate leaves (Alg. 12), the whole wave at once -------
    cand_leaf = leaf_lb * slack < bsf[:, None]               # (W, L)
    n_alive = (layout.leaf_count > 0).sum().clamp_min(1).to(_F32)
    eapca_pr = 1.0 - cand_leaf.sum(dim=1).to(_F32) / n_alive

    # ---- Phase 3: candidate series (Alg. 13), one kernel launch ------------
    srank = layout.series_leaf_rank.long()
    leaf_lb_pad = torch.cat([leaf_lb, leaf_lb.new_full((W, 1), INF)], dim=1)
    cand_lb = leaf_lb_pad[:, srank]                          # (W, N_pad)
    if cfg.use_sax:
        q_paa = S.paa(queries, layout.lsd.shape[1])          # (W, m)
        kmode = resolve_kernel_mode(cfg.kernel_mode, dev)
        if kmode == "ref":
            for i in range(W):
                torch.maximum(LB.lb_sax(q_paa[i], layout.lsd, n), cand_lb[i],
                              out=cand_lb[i])
        else:
            torch.maximum(kops.lb_sax(q_paa, layout.lsd, n, mode=kmode), cand_lb,
                          out=cand_lb)
    leaf_mask_pad = torch.cat([cand_leaf, cand_leaf.new_zeros((W, 1))], dim=1)
    cand_lb.masked_fill_(~leaf_mask_pad[:, srank], INF)
    n_cand = (cand_lb * slack < bsf[:, None]).sum(dim=1).to(_F32)
    sax_pr = 1.0 - S.div_rn(n_cand, layout.num_series)

    # ---- Phase 4: per-member adaptive refinement (Alg. 10/14) --------------
    rows = []
    for i in range(W):
        d_f, p_f, path, acc_f = _finish_one(
            queries[i], layout, cfg, d_top[i], p_top[i], accessed[i],
            cand_lb[i], eapca_pr[i], sax_pr[i])
        rows.append((d_f, p_f, path, eapca_pr[i], sax_pr[i], acc_f, l_max + 1))
    return _collect(layout, rows, cfg, dev)


# ---------------------------------------------------------------------------
# Approximate search (phase 1 of the exact pipeline as a standalone mode)
# ---------------------------------------------------------------------------

def approx_knn(tree: HerculesTree, layout: HerculesLayout, queries: torch.Tensor,
               cfg: SearchConfig, max_depth: int):
    """Phase-1-only kNN: the home leaf plus the l_max best leaves by
    LB_EAPCA (the paper's Approx-kNN, Alg. 11). Returns (dists, ids)."""
    dev = queries.device
    d_all, p_all = [], []
    for q in queries:
        _, d_top, p_top, _, _ = _phase1(q, tree, layout, cfg, max_depth)
        d_all.append(d_top)
        p_all.append(p_top)
    if not d_all:
        empty = torch.empty((0, cfg.k), device=dev)
        return empty, empty.to(torch.int64)
    p = torch.stack(p_all)
    return torch.stack(d_all), _ids(layout, p)


# ---------------------------------------------------------------------------
# Standalone baselines
# ---------------------------------------------------------------------------

def pscan_knn(data: torch.Tensor, queries: torch.Tensor, k: int = 1,
              block: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """PSCAN baseline (paper §4.1): blocked matmul-identity distances
    (``torch.matmul``, float32, TF32 off) for the whole batch, merged into a
    running top-k block by block. Returns (Q, k) dists and positions."""
    qn = queries.shape[0]
    num = data.shape[0]
    dev = queries.device
    q = queries.to(_F32)
    q_norm = S.fixed_order_sum(q * q)
    d_top = torch.full((qn, k), INF, device=dev)
    p_top = torch.full((qn, k), -1, dtype=_I32, device=dev)
    for base in range(0, num, block):
        blk = data[base:base + block].to(_F32)
        s_norm = S.fixed_order_sum(blk * blk)
        d = (q_norm[:, None] + s_norm[None, :] - 2.0 * (q @ blk.T)).clamp_min(0.0)
        if d.shape[1] < block:    # ragged tail: masked like the padded rows
            d = torch.cat([d, d.new_full((qn, block - d.shape[1]), INF)], dim=1)
        pos = torch.arange(base, base + block, dtype=_I32, device=dev)
        vals, idx = _stable_smallest(torch.cat([d_top, d], dim=1), k)
        pp = torch.cat([p_top, pos.expand(qn, block)], dim=1)
        d_top, p_top = vals, torch.gather(pp, 1, idx)
    return d_top, p_top


def brute_force_knn(data: torch.Tensor, queries: torch.Tensor, k: int = 1):
    """Reference oracle: the full matmul-identity distance matrix and a
    stable top-k. Returns (dists, int32 indices)."""
    d = LB.squared_ed_matrix(queries, data)
    vals, idx = _stable_smallest(d, k)
    return vals, idx.to(_I32)
