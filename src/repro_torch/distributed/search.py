"""Series-sharded Hercules search on PyTorch: one index a shard, top-k merge.

Port of ``repro/distributed/search.py``. The collection is split into one
contiguous range a shard, each shard builds its own Hercules index over its
range, and a query answers as

    exact top-k on every shard -> stack the (Q, k) answers shard-major
    -> the k smallest of their union

Exactness: every global top-k member is within the top-k of its own shard,
so the k smallest of the union is the global answer, and each distance is
the same difference-form sum whichever shard holds its row.

Devices: PyTorch has no ``shard_map``. A "mesh" is a list of
``torch.device``, one entry a shard, repeats allowed
(:func:`repro_torch.device.shard_devices`): four shards on one card is
``["cuda:0"] * 4``, the counterpart of the reference's forced host devices.
The reference's ``all_gather`` + ``jax.lax.top_k`` merge becomes
:func:`merge_shard_topk`: the per-shard answers move to the merge device
and one stable sort keeps the k smallest, ties toward the lower shard as
``top_k`` breaks them toward the lower index. No candidate is dropped as a
duplicate (``_merge_topk`` would drop an empty slot whose position -1 is
already present).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.index import HerculesIndex, IndexConfig
from repro_torch.core.layout import LAYOUT_TENSORS, HerculesLayout
from repro_torch.core.search import SearchConfig, _stable_smallest, exact_knn
from repro_torch.core.tree import HerculesTree
from repro_torch.device import resolve_device, shard_devices


@dataclasses.dataclass
class StackedIndex:
    """D per-shard indexes stacked leaf-wise (a leading shard dim on every
    tensor), padded to common shapes as the reference pads them."""
    tree: HerculesTree              # tensors (D, ...)
    layout: HerculesLayout          # tensors (D, ...); static fields unified
    shard_offsets: torch.Tensor     # (D,) int32 global id offset a shard
    max_depth: int
    config: IndexConfig
    num_shards: int

    @property
    def device(self) -> torch.device:
        return self.layout.lrd.device


def _pad_to(t: torch.Tensor, rows: int, fill=0) -> torch.Tensor:
    pad = rows - t.shape[0]
    if pad <= 0:
        return t
    return torch.cat([t, t.new_full((pad, *t.shape[1:]), fill)])


def build_distributed_index(data, num_shards: int,
                            config: IndexConfig | None = None, *,
                            device: str | torch.device | None = None
                            ) -> StackedIndex:
    """Split ``data`` (N, n) into ``num_shards`` contiguous shards, build one
    index a shard on ``device`` (default: the CUDA device) and stack them.

    The static shapes (padded leaf count, max leaf extent, padded series
    count, node count) are unified across shards, so every shard runs the
    same search at the same shapes."""
    dev = resolve_device(device)
    config = config or IndexConfig()
    n = data.shape[0]
    if n % num_shards:
        raise ValueError(f"{n} series not divisible into {num_shards} shards")
    per = n // num_shards
    sub = [HerculesIndex.build(data[i * per:(i + 1) * per], config, device=dev)
           for i in range(num_shards)]

    max_nodes = max(s.tree.max_nodes for s in sub)
    L = max(s.layout.leaf_start.shape[0] for s in sub)
    n_pad = max(s.layout.lrd.shape[0] for s in sub)
    max_leaf = max(s.layout.max_leaf for s in sub)
    max_depth = max(s.max_depth for s in sub)

    trees = [HerculesTree(*[_pad_to(t, max_nodes) if t.ndim else t
                            for t in s.tree]) for s in sub]
    fills = {  # padding of the per-shard layout tensors: (rows, fill)
        "lrd": (n_pad, 0), "lsd": (n_pad, 0), "perm": (n_pad, -1),
        "inv_perm": (n_pad, -1), "leaf_rank": (max_nodes, -1),
        "leaf_node": (L, 0), "leaf_start": (L, per), "leaf_count": (L, 0),
        "leaf_synopsis": (L, 0), "leaf_endpoints": (L, 0),
        "leaf_seg_lens": (L, 0), "series_leaf_rank": (n_pad, L)}
    tree = HerculesTree(*[torch.stack(parts) for parts in zip(*trees)])
    layout = HerculesLayout(
        **{f: torch.stack([_pad_to(getattr(s.layout, f), *fills[f]) for s in sub])
           for f in LAYOUT_TENSORS},
        series_len=sub[0].layout.series_len, max_leaf=max_leaf,
        num_leaves=L, num_series=per)
    offsets = torch.arange(num_shards, dtype=torch.int32, device=dev) * per
    return StackedIndex(tree=tree, layout=layout, shard_offsets=offsets,
                        max_depth=max_depth, config=config,
                        num_shards=num_shards)


def shard_view(index: StackedIndex, shard: int,
               device: torch.device | None = None
               ) -> tuple[HerculesTree, HerculesLayout]:
    """One shard's (tree, layout) without the leading shard dim, on
    ``device`` (default: where the stacked index lives; no copy then)."""
    dev = device or index.device
    tree = HerculesTree(*[t[shard].to(dev) for t in index.tree])
    lay = index.layout
    layout = dataclasses.replace(
        lay, **{f: getattr(lay, f)[shard].to(dev) for f in LAYOUT_TENSORS})
    return tree, layout


def merge_shard_topk(parts, k: int, device: torch.device):
    """Merge per-shard answers into the global top-k on ``device``.

    ``parts`` lists, in shard order, one tuple a shard of (Q, k) tensors:
    distances first, then any number of companions (ids, positions). They
    are concatenated shard-major along the k axis and the k smallest kept
    by a stable sort, so ties resolve toward the lower shard and, within a
    shard, in its own order. Returns the merged tuple."""
    cols = [torch.cat([p[j].to(device) for p in parts], dim=1)
            for j in range(len(parts[0]))]
    vals, idx = _stable_smallest(cols[0], k)
    return (vals, *[torch.gather(c, 1, idx) for c in cols[1:]])


def sharded_knn(shards, offsets, queries: torch.Tensor, cfg: SearchConfig,
                max_depth: int):
    """Exact global kNN over per-shard ``(tree, layout)`` views, each on its
    own device, with global id ``offsets``: every shard's exact top-k (ids
    past its offset), merged on the first shard's device. Returns (dists
    (Q, k), global ids (Q, k); -1 for an empty slot)."""
    parts = []
    for (tree, layout), off in zip(shards, offsets):
        res = exact_knn(tree, layout, queries.to(layout.lrd.device), cfg, max_depth)
        parts.append((res.dists, torch.where(res.positions >= 0, res.ids + off, -1)))
    return merge_shard_topk(parts, cfg.k, shards[0][1].lrd.device)


def distributed_knn(index: StackedIndex, queries, cfg: SearchConfig | None = None,
                    *, devices=None):
    """Exact global kNN over a :class:`StackedIndex`, each shard answered on
    its entry of ``devices`` (default: ``num_shards`` shards round-robin over
    the stacked index's kind of device) and merged on the first.

    Returns (dists (Q, k), global ids (Q, k))."""
    devs = shard_devices(index.num_shards, devices, index.device)
    shards = [shard_view(index, s, dev) for s, dev in enumerate(devs)]
    return sharded_knn(shards, index.shard_offsets.tolist(),
                       torch.as_tensor(queries, dtype=torch.float32),
                       cfg or index.config.search, index.max_depth)
