"""Materialized index layout -- the LRDFile / LSDFile analogue (paper §3.3).

Port of ``repro/core/layout.py``. ``HerculesLayout`` holds, on one device:

* ``lrd`` (N_pad, n) -- raw series in leaf in-order ("LRDFile");
* ``lsd`` (N_pad, m) -- uint8 iSAX codes in the same order ("LSDFile");
* ``perm``/``inv_perm`` -- original <-> layout position maps;
* per-leaf tables packed by in-order rank (extents, synopses, segmentations),
  so phase-2 pruning is one vectorized pass over leaves.

Placement (:func:`compute_layout_geometry`) is host numpy, as in the
reference; the data movement stays on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import summaries as S
from repro_torch.core.tree import HerculesTree, inorder_leaves

LAYOUT_TENSORS = ("lrd", "lsd", "perm", "inv_perm", "leaf_rank", "leaf_node",
                  "leaf_start", "leaf_count", "leaf_synopsis", "leaf_endpoints",
                  "leaf_seg_lens", "series_leaf_rank")
LAYOUT_STATIC = ("series_len", "max_leaf", "num_leaves", "num_series")


@dataclasses.dataclass(frozen=True)
class HerculesLayout:
    """Materialized index: tensor fields plus static int metadata."""
    lrd: torch.Tensor            # (N_pad, n) float32 (rows >= num_series are pad)
    lsd: torch.Tensor            # (N_pad, m_sax) uint8
    perm: torch.Tensor           # (N,) layout pos -> original id
    inv_perm: torch.Tensor       # (N,) original id -> layout pos
    leaf_rank: torch.Tensor      # (max_nodes,) int32
    leaf_node: torch.Tensor      # (L,) int32 node id per rank
    leaf_start: torch.Tensor     # (L,) int32
    leaf_count: torch.Tensor     # (L,) int32
    leaf_synopsis: torch.Tensor  # (L, M, 4) float32
    leaf_endpoints: torch.Tensor # (L, M) int32
    leaf_seg_lens: torch.Tensor  # (L, M) float32
    series_leaf_rank: torch.Tensor  # (N_pad,) int32, L for pad rows
    series_len: int
    max_leaf: int             # upper bound on leaf extent
    num_leaves: int           # true number of leaves (L may be padded)
    num_series: int           # real N (before padding)


@dataclasses.dataclass(frozen=True)
class LayoutGeometry:
    """Host-side placement plan for the LRD/LSD arrays: which layout row each
    series lands in, leaf extents and padding (all numpy), derived purely
    from (tree, node_of)."""
    perm: np.ndarray              # (N,) layout pos -> original id
    inv_perm: np.ndarray          # (N,) original id -> layout pos
    leaf_rank: np.ndarray         # (max_nodes,)
    leaf_node: np.ndarray         # (L,)
    leaf_start: np.ndarray        # (L,)
    leaf_count: np.ndarray        # (L,)
    series_leaf_rank: np.ndarray  # (n_pad,)
    series_len: int
    max_leaf: int
    num_leaves: int
    num_series: int
    n_pad: int


def compute_layout_geometry(tree: HerculesTree, node_of,
                            num_series: int, series_len: int,
                            pad_leaves_to: int | None = None,
                            pad_series_to_multiple: int = 1) -> LayoutGeometry:
    """Leaf in-order placement plan from a built tree (host-side, no data).

    ``pad_series_to_multiple`` rounds the series axis up (pad rows are zeros
    with sentinel leaf rank L) so blocked scans never need clamped slices,
    and every leaf extent ``[start, start + max_leaf)`` stays in bounds.
    """
    node_of_np = (node_of.cpu().numpy() if isinstance(node_of, torch.Tensor)
                  else np.asarray(node_of))
    order = inorder_leaves(tree)
    num_leaves = len(order)
    L = pad_leaves_to or num_leaves

    leaf_rank = np.full((tree.max_nodes,), -1, np.int32)
    leaf_rank[order] = np.arange(num_leaves, dtype=np.int32)

    # stable sort series by (leaf rank, original id) -> layout order
    ranks = leaf_rank[node_of_np]
    perm = np.argsort(ranks, kind="stable").astype(np.int32)
    inv_perm = np.argsort(perm).astype(np.int32)

    counts = np.zeros((L,), np.int32)
    cnt_by_node = np.bincount(node_of_np, minlength=tree.max_nodes)
    counts[:num_leaves] = cnt_by_node[order]
    starts = np.zeros((L,), np.int32)
    starts[:num_leaves] = np.concatenate(
        [[0], np.cumsum(counts[:num_leaves])[:-1]])
    starts[num_leaves:] = num_series      # padded (empty) leaf slots
    max_leaf = int(counts.max(initial=1))

    blk = max(1, pad_series_to_multiple)
    n_pad = -(-(num_series + max_leaf) // blk) * blk
    srank = np.concatenate(
        [ranks[perm], np.full((n_pad - num_series,), L, np.int32)])

    leaf_node = np.zeros((L,), np.int32)
    leaf_node[:num_leaves] = order

    return LayoutGeometry(
        perm=perm, inv_perm=inv_perm, leaf_rank=leaf_rank,
        leaf_node=leaf_node, leaf_start=starts, leaf_count=counts,
        series_leaf_rank=srank.astype(np.int32),
        series_len=series_len, max_leaf=max_leaf, num_leaves=num_leaves,
        num_series=num_series, n_pad=n_pad)


def leaf_tables(tree: HerculesTree, geo: LayoutGeometry):
    """(leaf_synopsis, leaf_endpoints, leaf_seg_lens) packed per in-order
    rank -- the per-leaf pruning tables phase 2 sweeps. Padded slots get a
    zero synopsis (LB 0, count 0: never pruned wrongly, contribute nothing)."""
    dev = tree.synopsis.device
    ln = torch.from_numpy(geo.leaf_node).long().to(dev)
    syn = tree.synopsis[ln]
    ep = tree.endpoints[ln]
    seg_lens = S.segment_lengths(ep)
    L = geo.leaf_node.shape[0]
    pad_mask = torch.arange(L, device=dev) >= geo.num_leaves
    syn = torch.where(pad_mask[:, None, None],
                      torch.zeros((), dtype=syn.dtype, device=dev), syn)
    return syn, ep, seg_lens


def _tensor(x, device: torch.device) -> torch.Tensor:
    """Tensors move to ``device``; numpy arrays (memmaps included) are copied,
    never aliased, so the layout owns its memory."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def assemble_layout(tree: HerculesTree, geo: LayoutGeometry,
                    lrd, lsd) -> HerculesLayout:
    """HerculesLayout (on the tree's device) from a placement plan plus
    already-materialized LRD/LSD arrays (tensors or numpy)."""
    dev = tree.synopsis.device
    syn, ep, seg_lens = leaf_tables(tree, geo)
    return HerculesLayout(
        lrd=_tensor(lrd, dev), lsd=_tensor(lsd, dev),
        perm=_tensor(geo.perm, dev), inv_perm=_tensor(geo.inv_perm, dev),
        leaf_rank=_tensor(geo.leaf_rank, dev),
        leaf_node=_tensor(geo.leaf_node, dev),
        leaf_start=_tensor(geo.leaf_start, dev),
        leaf_count=_tensor(geo.leaf_count, dev),
        leaf_synopsis=syn, leaf_endpoints=ep, leaf_seg_lens=seg_lens,
        series_leaf_rank=_tensor(geo.series_leaf_rank, dev),
        series_len=geo.series_len, max_leaf=geo.max_leaf,
        num_leaves=geo.num_leaves, num_series=geo.num_series)


def build_layout(tree: HerculesTree, node_of: torch.Tensor, data: torch.Tensor,
                 sax_segments: int = S.NUM_SAX_SEGMENTS,
                 pad_leaves_to: int | None = None,
                 pad_series_to_multiple: int = 1) -> HerculesLayout:
    """Materialize the leaf in-order layout from a built tree (placement on
    the host, the row reorder and iSAX codes on ``data``'s device)."""
    num, n = data.shape
    geo = compute_layout_geometry(
        tree, node_of, num, n, pad_leaves_to=pad_leaves_to,
        pad_series_to_multiple=pad_series_to_multiple)
    dev = data.device
    lrd = torch.zeros((geo.n_pad, n), dtype=data.dtype, device=dev)
    lrd[:num] = data[torch.from_numpy(geo.perm).long().to(dev)]
    lsd = torch.zeros((geo.n_pad, sax_segments), dtype=torch.uint8, device=dev)
    lsd[:num] = S.isax(lrd[:num], sax_segments)
    return assemble_layout(tree, geo, lrd, lsd)
