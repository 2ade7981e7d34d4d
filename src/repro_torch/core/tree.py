"""The Hercules index tree (paper §3.2-3.3), built level-synchronously.

Port of ``repro/core/tree.py`` (see it for the round structure and the
split-policy scoring). Each round every over-capacity leaf picks its best
split policy and all members are re-partitioned in one batched step; the
Python loop runs one round per tree level.

Two JAX idioms have no torch twin and are rewritten here:

* ``x.at[idx].set(v, mode="drop")`` with ``idx == max_nodes`` meaning
  "drop": :func:`_scatter_drop` scatters into a copy with one extra slot
  and slices it off.
* ``jax.ops.segment_min/max`` with a drop slot: :func:`_seg_minmax` uses
  ``scatter_reduce("amin"/"amax", include_self=True)`` on tensors
  initialised to the identities +inf/-inf, which is what a segment with no
  members reports in the reference too.

``build_tree_chunked`` (the out-of-core build) comes with the storage slice.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import summaries as S

_I32 = torch.int32
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Static build-time settings (the paper's Idx.Settings, Alg. 6 line 2)."""
    leaf_capacity: int = 256          # tau: paper uses 100K on disk
    max_segments: int = 16            # M: V-splits may refine up to this many
    init_segments: int = 4            # root segmentation (equal-length)
    max_nodes: int = 0                # 0 -> auto: 8 * ceil(N / tau) + 64
    max_rounds: int = 64              # safety bound on build rounds

    def resolve_max_nodes(self, num_series: int) -> int:
        if self.max_nodes:
            return self.max_nodes
        return 8 * max(1, -(-num_series // self.leaf_capacity)) + 64


class HerculesTree(NamedTuple):
    """Structure-of-arrays binary tree; every tensor has leading dim
    ``max_nodes``. Valid node ids are ``[0, num_nodes)``."""
    parent: torch.Tensor        # (max_nodes,) int32, -1 for root
    left: torch.Tensor          # (max_nodes,) int32, -1 if leaf
    right: torch.Tensor         # (max_nodes,) int32, -1 if leaf
    is_leaf: torch.Tensor       # (max_nodes,) bool
    no_split: torch.Tensor      # (max_nodes,) bool: leaf proven unsplittable
    depth: torch.Tensor         # (max_nodes,) int32
    endpoints: torch.Tensor     # (max_nodes, M) int32 right endpoints (pad = n)
    num_segs: torch.Tensor      # (max_nodes,) int32
    split_lo: torch.Tensor      # (max_nodes,) int32 routing range start
    split_hi: torch.Tensor      # (max_nodes,) int32 routing range end (excl)
    split_use_std: torch.Tensor # (max_nodes,) bool: route on sd instead of mean
    split_value: torch.Tensor   # (max_nodes,) float32 threshold (range midpoint)
    synopsis: torch.Tensor      # (max_nodes, M, 4) [mu_min, mu_max, sd_min, sd_max]
    count: torch.Tensor         # (max_nodes,) int32 series at/below node
    num_nodes: torch.Tensor     # () int32

    @property
    def max_nodes(self) -> int:
        return self.parent.shape[0]

    @property
    def max_segments(self) -> int:
        return self.endpoints.shape[1]


def _empty_tree(max_nodes: int, m: int, n: int, init_segments: int,
                device: torch.device) -> HerculesTree:
    ep0 = np.full((m,), n, dtype=np.int32)
    for j in range(init_segments):
        ep0[j] = round(n * (j + 1) / init_segments)
    endpoints = torch.zeros((max_nodes, m), dtype=_I32, device=device)
    endpoints[0] = torch.from_numpy(ep0).to(device)
    is_leaf = torch.zeros((max_nodes,), dtype=torch.bool, device=device)
    is_leaf[0] = True
    num_segs = torch.zeros((max_nodes,), dtype=_I32, device=device)
    num_segs[0] = init_segments

    def full(value, dtype):
        return torch.full((max_nodes,), value, dtype=dtype, device=device)

    return HerculesTree(
        parent=full(-1, _I32), left=full(-1, _I32), right=full(-1, _I32),
        is_leaf=is_leaf, no_split=full(False, torch.bool), depth=full(0, _I32),
        endpoints=endpoints, num_segs=num_segs,
        split_lo=full(0, _I32), split_hi=full(0, _I32),
        split_use_std=full(False, torch.bool), split_value=full(0.0, _F32),
        synopsis=torch.zeros((max_nodes, m, 4), dtype=_F32, device=device),
        count=full(0, _I32),
        num_nodes=torch.tensor(1, dtype=_I32, device=device),
    )


# ---------------------------------------------------------------------------
# Per-round primitives
# ---------------------------------------------------------------------------

def _range_stat(p: torch.Tensor, p2: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor, use_std: torch.Tensor) -> torch.Tensor:
    """Mean or population std of each series over its own ``[lo, hi)``.
    ``p``/``p2``: (N, n+1); ``lo``/``hi``/``use_std``: (N,). Returns (N,)."""
    lo = lo.long()[:, None]
    hi = hi.long()[:, None]
    ln = (hi - lo).to(_F32).clamp_min(1.0)
    s1 = torch.gather(p, 1, hi) - torch.gather(p, 1, lo)
    s2 = torch.gather(p2, 1, hi) - torch.gather(p2, 1, lo)
    mean = (s1 / ln)[:, 0]
    var = ((s2 / ln)[:, 0] - mean * mean).clamp_min(0.0)
    return torch.where(use_std, S.sqrt_rn(var), mean)


def _seg_minmax(vals: torch.Tensor, seg_ids: torch.Tensor, num_segments: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment min/max of ``vals`` (N, M) over ``seg_ids`` (N,);
    segments with no members hold +inf / -inf."""
    idx = seg_ids.long()[:, None].expand_as(vals)
    shape = (num_segments, vals.shape[1])
    mn = torch.full(shape, float("inf"), dtype=vals.dtype, device=vals.device)
    mx = torch.full(shape, float("-inf"), dtype=vals.dtype, device=vals.device)
    mn = mn.scatter_reduce(0, idx, vals, "amin", include_self=True)
    mx = mx.scatter_reduce(0, idx, vals, "amax", include_self=True)
    return mn, mx


def _scatter_drop(arr: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``arr.at[idx].set(val, mode="drop")`` for ``idx`` in
    ``[0, len(arr)]``: writes to index ``len(arr)`` are dropped."""
    ext = torch.cat([arr, arr[:1]])
    ext[idx.long()] = val if isinstance(val, torch.Tensor) else \
        torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    return ext[:arr.shape[0]]


class RoundStats(NamedTuple):
    """Per-node associative reductions feeding one split round's decision
    (see the reference's ``RoundStats``). ``counts`` is (max_nodes,) int32;
    every other field is (max_nodes, M) float32 with +inf / -inf for nodes
    that saw no members."""
    counts: torch.Tensor
    mu_mn: torch.Tensor
    mu_mx: torch.Tensor
    sd_mn: torch.Tensor
    sd_mx: torch.Tensor
    h1m_mn: torch.Tensor
    h1m_mx: torch.Tensor
    h1s_mn: torch.Tensor
    h1s_mx: torch.Tensor
    h2m_mn: torch.Tensor
    h2m_mx: torch.Tensor
    h2s_mn: torch.Tensor
    h2s_mx: torch.Tensor


def _leaf_member_counts(node_of: torch.Tensor, max_nodes: int) -> torch.Tensor:
    return torch.bincount(node_of.long(), minlength=max_nodes)[:max_nodes].to(_I32)


def _round_stats(tree: HerculesTree, node_of: torch.Tensor,
                 p: torch.Tensor, p2: torch.Tensor) -> RoundStats:
    """Per-leaf reductions over the members (round phase 1+3 stats)."""
    max_nodes = tree.max_nodes
    num = p.shape[0]

    ep = tree.endpoints[node_of.long()]                 # (N, M)
    starts = torch.cat([ep.new_zeros((num, 1)), ep[:, :-1]], dim=1)
    lens = ep - starts
    mids = starts + lens // 2                           # V-split half boundary

    means, stds = S.segment_stats_from_prefix(p, p2, ep)
    h1m, h1s = S.segment_stats_from_prefix(p, p2, mids)
    ln2 = (ep - mids).to(_F32).clamp_min(1.0)
    ep_l, mids_l = ep.long(), mids.long()
    s1b = torch.gather(p, 1, ep_l) - torch.gather(p, 1, mids_l)
    s2b = torch.gather(p2, 1, ep_l) - torch.gather(p2, 1, mids_l)
    h2m = s1b / ln2
    h2s = S.sqrt_rn((s2b / ln2 - h2m * h2m).clamp_min(0.0))

    parts = [_leaf_member_counts(node_of, max_nodes)]
    for vals in (means, stds, h1m, h1s, h2m, h2s):
        mn, mx = _seg_minmax(vals, node_of, max_nodes + 1)
        parts += [mn[:max_nodes], mx[:max_nodes]]
    return RoundStats(*parts)


def _round_decide(tree: HerculesTree, stats: RoundStats, *, tau: int
                  ) -> tuple[HerculesTree, torch.Tensor]:
    """Pick split policies and scatter children from the round stats.
    Returns (tree, number of nodes split this round)."""
    max_nodes = tree.max_nodes
    m = tree.max_segments
    dev = tree.parent.device

    # ---- 2. which leaves split this round ---------------------------------
    want = tree.is_leaf & ~tree.no_split & (stats.counts > tau)
    budget = (max_nodes - tree.num_nodes) // 2
    rank = torch.cumsum(want.to(_I32), 0) - 1
    splitting = want & (rank < budget)

    # ---- 3. per-leaf synopsis ranges + QoS policy scores -------------------
    node_ep = tree.endpoints
    node_st = torch.cat([node_ep.new_zeros((max_nodes, 1)), node_ep[:, :-1]], dim=1)
    node_len = (node_ep - node_st).to(_F32)

    def rng(mx, mn):
        return (mx - mn).clamp_min(0.0)

    def sq(x):
        return x * x

    r_mu, r_sd = rng(stats.mu_mx, stats.mu_mn), rng(stats.sd_mx, stats.sd_mn)
    r1_mu, r1_sd = rng(stats.h1m_mx, stats.h1m_mn), rng(stats.h1s_mx, stats.h1s_mn)
    r2_mu, r2_sd = rng(stats.h2m_mx, stats.h2m_mn), rng(stats.h2s_mx, stats.h2s_mn)

    neg1 = torch.tensor(-1.0, dtype=_F32, device=dev)
    valid_seg = node_len >= 1.0
    l1 = torch.floor(node_len / 2.0)
    l2 = node_len - l1

    score_h_mu = torch.where(valid_seg, node_len * sq(r_mu) / 2.0, neg1)
    score_h_sd = torch.where(valid_seg, node_len * sq(r_sd) / 2.0, neg1)

    qos_full = node_len * (sq(r_mu) + sq(r_sd))
    qos_halves = l1 * (sq(r1_mu) + sq(r1_sd)) + l2 * (sq(r2_mu) + sq(r2_sd))
    h_gain = torch.stack([l1 * sq(r1_mu) / 2.0, l1 * sq(r1_sd) / 2.0,
                          l2 * sq(r2_mu) / 2.0, l2 * sq(r2_sd) / 2.0], dim=-1)
    best_half = torch.argmax(h_gain, dim=-1)             # first max on ties
    best_half_gain = h_gain.amax(dim=-1)
    can_v = (node_len >= 2.0) & (tree.num_segs < m)[:, None]
    score_v = torch.where(can_v, qos_full - qos_halves + best_half_gain, neg1)

    cand = torch.stack([score_h_mu, score_h_sd, score_v], dim=-1)
    flat = cand.reshape(max_nodes, m * 3)
    best_idx = torch.argmax(flat, dim=1)
    best_score = torch.gather(flat, 1, best_idx[:, None])[:, 0]
    seg_idx = best_idx // 3
    kind = best_idx % 3                                  # 0 h_mu, 1 h_sd, 2 v

    degenerate = splitting & (best_score <= 0.0)
    splitting = splitting & (best_score > 0.0)
    # re-rank after dropping degenerates so child ids stay dense
    rank = torch.cumsum(splitting.to(_I32), 0) - 1
    splitting = splitting & (rank < budget)

    # ---- 4. resolve the chosen policy per splitting node -------------------
    ar = torch.arange(max_nodes, device=dev)

    def sel(a):
        return a[ar, seg_idx]

    g_st, g_ep = sel(node_st), sel(node_ep)
    g_mid = g_st + (g_ep - g_st) // 2
    g_half = sel(best_half)
    v_use_h2 = g_half >= 2
    v_use_std = (g_half % 2) == 1

    is_v = kind == 2
    new_lo = torch.where(is_v, torch.where(v_use_h2, g_mid, g_st), g_st)
    new_hi = torch.where(is_v, torch.where(v_use_h2, g_ep, g_mid), g_ep)
    new_std = torch.where(is_v, v_use_std, kind == 1)

    def mid_of(mn, mx):
        return (sel(mn) + sel(mx)) / 2.0

    thr_h = torch.where(kind == 1, mid_of(stats.sd_mn, stats.sd_mx),
                        mid_of(stats.mu_mn, stats.mu_mx))
    thr_v = torch.where(
        v_use_h2,
        torch.where(v_use_std, mid_of(stats.h2s_mn, stats.h2s_mx),
                    mid_of(stats.h2m_mn, stats.h2m_mx)),
        torch.where(v_use_std, mid_of(stats.h1s_mn, stats.h1s_mx),
                    mid_of(stats.h1m_mn, stats.h1m_mx)))
    new_value = torch.where(is_v, thr_v, thr_h)

    # child segmentation: a V-split inserts g_mid (pad slot M-1 is always n)
    last = torch.where(is_v, g_mid, node_ep[:, m - 1])
    ins = torch.cat([node_ep[:, :m - 1], last[:, None]], dim=1)
    child_ep = torch.where(is_v[:, None], torch.sort(ins, dim=1).values, node_ep)
    child_nsegs = tree.num_segs + is_v.to(_I32)

    # ---- 5. allocate children + scatter metadata ---------------------------
    drop = torch.tensor(max_nodes, dtype=torch.int64, device=dev)
    left_id = torch.where(splitting, tree.num_nodes.long() + 2 * rank, drop)
    right_id = torch.where(splitting, left_id + 1, drop)
    self_idx = torch.where(splitting, ar, drop)
    ar32 = ar.to(_I32)
    sc = _scatter_drop
    n_split = splitting.to(_I32).sum()
    tree = tree._replace(
        left=sc(tree.left, self_idx, left_id.to(_I32)),
        right=sc(tree.right, self_idx, right_id.to(_I32)),
        is_leaf=sc(sc(sc(tree.is_leaf, self_idx, False), left_id, True),
                   right_id, True),
        no_split=sc(tree.no_split, torch.where(degenerate, ar, drop), True),
        split_lo=sc(tree.split_lo, self_idx, new_lo.to(_I32)),
        split_hi=sc(tree.split_hi, self_idx, new_hi.to(_I32)),
        split_use_std=sc(tree.split_use_std, self_idx, new_std),
        split_value=sc(tree.split_value, self_idx, new_value),
        parent=sc(sc(tree.parent, left_id, ar32), right_id, ar32),
        depth=sc(sc(tree.depth, left_id, tree.depth + 1), right_id, tree.depth + 1),
        endpoints=sc(sc(tree.endpoints, left_id, child_ep), right_id, child_ep),
        num_segs=sc(sc(tree.num_segs, left_id, child_nsegs), right_id, child_nsegs),
        num_nodes=(tree.num_nodes + 2 * n_split).to(_I32),
    )
    return tree, n_split


def _route_members(tree: HerculesTree, node_of: torch.Tensor,
                   p: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Round phase 6: move members of just-split leaves to the winning child."""
    nid = node_of.long()
    moved = ~tree.is_leaf[nid]
    stat = _range_stat(p, p2, tree.split_lo[nid], tree.split_hi[nid],
                       tree.split_use_std[nid])
    go_right = stat >= tree.split_value[nid]
    new_node = torch.where(go_right, tree.right[nid], tree.left[nid])
    return torch.where(moved, new_node, node_of).to(_I32)


def _build_round(tree: HerculesTree, node_of: torch.Tensor,
                 p: torch.Tensor, p2: torch.Tensor, *, tau: int):
    """One level-synchronous split round. Returns (tree, node_of, num_split)."""
    stats = _round_stats(tree, node_of, p, p2)
    tree, num_split = _round_decide(tree, stats, tau=tau)
    node_of = _route_members(tree, node_of, p, p2)
    counts = _leaf_member_counts(node_of, tree.max_nodes)
    tree = tree._replace(count=torch.where(tree.is_leaf, counts, tree.count))
    return tree, node_of, num_split


_SYN_BIG = 3.0e38


def _synopsis_level(tree: HerculesTree, anc: torch.Tensor,
                    p: torch.Tensor, p2: torch.Tensor):
    """Fold every series' stats (under ancestor ``anc``'s segmentation) into
    that ancestor's synopsis, then step ancestors one level up."""
    max_nodes = tree.max_nodes
    ep = tree.endpoints[anc.clamp_min(0).long()]
    means, stds = S.segment_stats_from_prefix(p, p2, ep)
    ids = torch.where(anc >= 0, anc, max_nodes)
    mu_mn, mu_mx = _seg_minmax(means, ids, max_nodes + 1)
    sd_mn, sd_mx = _seg_minmax(stds, ids, max_nodes + 1)
    old = tree.synopsis
    syn = torch.stack([torch.minimum(old[..., 0], mu_mn[:max_nodes]),
                       torch.maximum(old[..., 1], mu_mx[:max_nodes]),
                       torch.minimum(old[..., 2], sd_mn[:max_nodes]),
                       torch.maximum(old[..., 3], sd_mx[:max_nodes])], dim=-1)
    tree = tree._replace(synopsis=syn)
    anc = torch.where(anc >= 0, tree.parent[anc.clamp_min(0).long()], anc)
    return tree, anc


def compute_synopses(tree: HerculesTree, node_of: torch.Tensor,
                     p: torch.Tensor, p2: torch.Tensor, max_depth: int) -> HerculesTree:
    """Exact synopses for every node (leaf + internal), one tree level per
    step: every series folds its per-segment stats into each ancestor."""
    shape = tree.synopsis.shape[:-1]
    dev = tree.synopsis.device
    big = torch.full(shape, _SYN_BIG, dtype=_F32, device=dev)
    tree = tree._replace(synopsis=torch.stack([big, -big, big, -big], dim=-1))
    anc = node_of
    for _ in range(max_depth + 1):
        tree, anc = _synopsis_level(tree, anc, p, p2)
    # zero out untouched (empty) nodes so downstream arithmetic stays finite
    untouched = tree.synopsis[..., 0] >= _SYN_BIG
    syn = torch.where(untouched[..., None],
                      torch.zeros((), dtype=_F32, device=dev), tree.synopsis)
    return tree._replace(synopsis=syn)


# ---------------------------------------------------------------------------
# Build loop
# ---------------------------------------------------------------------------

def build_tree(data: torch.Tensor, config: BuildConfig
               ) -> tuple[HerculesTree, torch.Tensor]:
    """Build the Hercules tree over ``data`` (N, n) on ``data``'s device.

    Returns (tree, node_of) where node_of (N,) int32 maps each series to its
    leaf. One round per loop iteration; the loop ends when no leaf splits.
    """
    num, n = data.shape
    max_nodes = config.resolve_max_nodes(num)
    if config.init_segments > config.max_segments:
        raise ValueError("init_segments > max_segments")
    dev = data.device
    tree = _empty_tree(max_nodes, config.max_segments, n, config.init_segments, dev)
    node_of = torch.zeros((num,), dtype=_I32, device=dev)
    p, p2 = S.prefix_sums(data)
    count = tree.count.clone()
    count[0] = num
    tree = tree._replace(count=count)

    for _ in range(config.max_rounds):
        tree, node_of, n_split = _build_round(tree, node_of, p, p2,
                                              tau=config.leaf_capacity)
        if int(n_split) == 0:
            break

    live = torch.arange(max_nodes, device=dev) < tree.num_nodes
    max_depth = int(torch.where(live, tree.depth, 0).max())
    tree = compute_synopses(tree, node_of, p, p2, max_depth)
    return tree, node_of


# ---------------------------------------------------------------------------
# Routing (query-time descent, paper Alg. 5 line 1 / RouteToLeaf)
# ---------------------------------------------------------------------------

def route_to_leaf(tree: HerculesTree, series: torch.Tensor, max_depth: int
                  ) -> torch.Tensor:
    """Route each series (Q, n) to its home leaf id. Returns (Q,) int32."""
    p, p2 = S.prefix_sums(series)
    node = torch.zeros((series.shape[0],), dtype=torch.int64, device=series.device)
    for _ in range(max_depth + 1):
        leaf = tree.is_leaf[node]
        stat = _range_stat(p, p2, tree.split_lo[node], tree.split_hi[node],
                           tree.split_use_std[node])
        go_right = stat >= tree.split_value[node]
        nxt = torch.where(go_right, tree.right[node], tree.left[node]).long()
        node = torch.where(leaf, node, nxt)
    return node.to(_I32)


# ---------------------------------------------------------------------------
# Host-side inspection helpers (small-tree operations; numpy)
# ---------------------------------------------------------------------------

def inorder_leaves(tree: HerculesTree) -> np.ndarray:
    """Leaf ids in in-order traversal -- the LRDFile layout order (§3.3.1)."""
    left = tree.left.cpu().numpy()
    right = tree.right.cpu().numpy()
    is_leaf = tree.is_leaf.cpu().numpy()
    order: list[int] = []
    stack: list[int] = [0]
    while stack:
        node = stack.pop()
        if node < 0:
            continue
        if is_leaf[node]:
            order.append(node)
        else:
            stack.append(int(right[node]))
            stack.append(int(left[node]))
    return np.asarray(order, dtype=np.int32)


def tree_stats(tree: HerculesTree) -> dict:
    nn = int(tree.num_nodes)
    leaf = tree.is_leaf[:nn].cpu().numpy()
    cnt = tree.count[:nn].cpu().numpy()
    return {
        "num_nodes": nn,
        "num_leaves": int(leaf.sum()),
        "max_depth": int(tree.depth[:nn].cpu().numpy().max(initial=0)),
        "max_leaf": int(cnt[leaf].max(initial=0)),
        "min_leaf": int(cnt[leaf].min(initial=0)),
        "total_in_leaves": int(cnt[leaf].sum()),
    }
