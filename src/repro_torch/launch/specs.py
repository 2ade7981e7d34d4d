"""Shape-level stand-ins for every model input (``repro/launch/specs.py``):
``meta`` tensors, which carry a shape and a dtype and no storage.

``input_specs(cfg, shape)`` is the batch each step consumes: train/prefill
take token batches (+ stub frontend embeddings for vlm/audio); decode
takes (B, 1) tokens, and ``cache_specs`` the KV-cache/state sized to the
cell's context length. ``param_specs`` is the model's parameter tree as
``init`` builds it, made with :data:`~repro_torch.models.common.SHAPES_ONLY`
in place of a generator (one code path with the real ``init``, so the
shapes cannot drift apart; nothing is drawn), floating leaves in
``cfg.param_dtype``; ``opt_specs`` runs the port's ``adamw_init`` on it,
so int8 moments keep their blockwise layout. The reference's twin is
``jax.eval_shape``: no spec here allocates.
"""
from __future__ import annotations

import torch

from repro_torch.models import common as C
from repro_torch.models import get_model
from repro_torch.models.arch import ArchConfig, ShapeConfig
from repro_torch.train.optimizer import AdamWConfig, adamw_init

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Batch spec for one (arch x shape) cell."""
    b = shape.global_batch
    s = shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _sds((b, 1), torch.int32)}
    if cfg.family == "vlm":
        return {"tokens": _sds((b, s - cfg.num_patches), torch.int32),
                "patch_embeds": _sds((b, cfg.num_patches, cfg.d_patch), torch.float32)}
    if cfg.family == "audio":
        return {"tokens": _sds((b, s), torch.int32),
                "frames": _sds((b, cfg.num_frames, cfg.d_model), torch.float32)}
    return {"tokens": _sds((b, s), torch.int32)}


def cache_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Decode-cache spec sized to the cell's context (``meta``: no alloc)."""
    return get_model(cfg).init_cache(cfg, shape.global_batch, shape.seq_len, device=META)


def param_specs(cfg: ArchConfig) -> C.ParamTree:
    """The parameter tree of ``cfg`` on ``meta`` (the port's layout, each
    stack of layers a list; :func:`~repro_torch.models.common.stack_tree`
    or ``distributed.sharding.flatten_paths`` give the reference's)."""
    tree = get_model(cfg).init(C.SHAPES_ONLY, cfg)
    pd = getattr(torch, cfg.param_dtype)
    return tree if pd == torch.float32 else tree.to(pd)


def opt_specs(params_spec: C.ParamTree, opt_cfg: AdamWConfig) -> dict:
    return adamw_init(params_spec, opt_cfg)


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a nested dict/list tree or ``ParamTree``."""
    leaves = (list(tree.parameters()) if isinstance(tree, torch.nn.Module)
              else C.tree_leaves(tree))
    return sum(x.numel() * x.element_size() for x in leaves
               if isinstance(x, torch.Tensor))
