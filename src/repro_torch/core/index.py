"""HerculesIndex -- build / carry-across / query facade on PyTorch.

Port of ``repro/core/index.py``. ``build`` runs index construction and
index writing (tree build, synopses, LRD/LSD layout) on one device;
``knn`` is the §3.4 query pipeline. :meth:`HerculesIndex.from_arrays` and
:meth:`HerculesIndex.load` take over an index the JAX package built (the
``.npz`` its ``HerculesIndex.save`` writes), so the port's query path can be
checked over a reference-built index.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

from repro_torch.core import summaries as S
from repro_torch.core.layout import (LAYOUT_STATIC, LAYOUT_TENSORS,
                                     HerculesLayout, build_layout)
from repro_torch.core.search import (KnnResult, SearchConfig, approx_knn,
                                     exact_knn, validate_runtime_config)
from repro_torch.core.tree import BuildConfig, HerculesTree, build_tree, tree_stats
from repro_torch.device import resolve_device

# kernel modes of the reference that have no port counterpart: its compiled
# and interpreted Pallas kernels both mean "use the kernels where the
# hardware has them", which is the port's "auto"
_REFERENCE_KERNEL_MODES = {"pallas": "auto", "interpret": "auto"}


def reference_search_config(search: dict) -> dict:
    """A saved ``SearchConfig`` dict of either package with the reference's
    kernel modes mapped to the port's."""
    search = dict(search)
    mode = search.get("kernel_mode", "auto")
    search["kernel_mode"] = _REFERENCE_KERNEL_MODES.get(mode, mode)
    return search


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    build: BuildConfig = dataclasses.field(default_factory=BuildConfig)
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    sax_segments: int = S.NUM_SAX_SEGMENTS


def _as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """Copy numpy input to ``device`` (never aliasing host memory); move
    tensors."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, copy=True))
    return t.to(device=device, dtype=dtype)


class HerculesIndex:
    """An in-memory (device-resident) Hercules index over one collection."""

    def __init__(self, tree: HerculesTree, layout: HerculesLayout,
                 config: IndexConfig, max_depth: int):
        self.tree = tree
        self.layout = layout
        self.config = config
        self.max_depth = max_depth

    @property
    def device(self) -> torch.device:
        return self.layout.lrd.device

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, data, config: IndexConfig | None = None,
              device: str | torch.device | None = None) -> "HerculesIndex":
        """One-shot in-memory build of ``data`` (N, n) on ``device``
        (default: the CUDA device; ``"cpu"`` to build on the host)."""
        dev = resolve_device(device)
        config = config or IndexConfig()
        data = _as_tensor(data, dev, torch.float32)
        if data.shape[1] % config.sax_segments:
            raise ValueError(
                f"series length {data.shape[1]} must be divisible by "
                f"{config.sax_segments} iSAX segments")
        tree, node_of = build_tree(data, config.build)
        layout = build_layout(
            tree, node_of, data, sax_segments=config.sax_segments,
            pad_series_to_multiple=config.search.pad_multiple())
        return cls(tree, layout, config, tree_stats(tree)["max_depth"])

    @classmethod
    def from_arrays(cls, arrays: dict[str, np.ndarray], meta: dict,
                    device: str | torch.device | None = None) -> "HerculesIndex":
        """An index from the reference's saved state: the ``tree.<field>`` /
        ``layout.<field>`` arrays and the JSON meta that
        ``repro.core.index.HerculesIndex.save`` writes."""
        dev = resolve_device(device)
        tree = HerculesTree(**{name: _as_tensor(arrays[f"tree.{name}"], dev)
                               for name in HerculesTree._fields})
        lay = {name: _as_tensor(arrays[f"layout.{name}"], dev)
               for name in LAYOUT_TENSORS}
        lay.update({name: int(meta["layout_static"][name]) for name in LAYOUT_STATIC})
        config = IndexConfig(build=BuildConfig(**meta["build"]),
                             search=SearchConfig(**reference_search_config(
                                 meta["search"])),
                             sax_segments=int(meta["sax_segments"]))
        return cls(tree, HerculesLayout(**lay), config, int(meta["max_depth"]))

    @classmethod
    def load(cls, path: str, device: str | torch.device | None = None
             ) -> "HerculesIndex":
        """Read the ``.npz`` that the reference's ``HerculesIndex.save``
        writes."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            arrays = {key: z[key] for key in z.files if key != "__meta__"}
        return cls.from_arrays(arrays, meta, device)

    # -- query answering ------------------------------------------------------

    def knn(self, queries, k: int | None = None, **overrides: Any) -> KnnResult:
        cfg = self.config.search
        if k is not None or overrides:
            cfg = dataclasses.replace(cfg, **({"k": k} if k is not None else {}),
                                      **overrides)
        validate_runtime_config(cfg, self.layout.lrd.shape[0])
        q = _as_tensor(queries, self.device, torch.float32)
        return exact_knn(self.tree, self.layout, q, cfg, self.max_depth)

    def knn_approx(self, queries, k: int | None = None, l_max: int | None = None):
        """Approximate kNN (phase 1 only). Returns (dists, ids)."""
        upd = {}
        if k is not None:
            upd["k"] = k
        if l_max is not None:
            upd["l_max"] = l_max
        cfg = dataclasses.replace(self.config.search, **upd)
        q = _as_tensor(queries, self.device, torch.float32)
        return approx_knn(self.tree, self.layout, q, cfg, self.max_depth)

    def stats(self) -> dict:
        return tree_stats(self.tree)
