"""AdamW with optional 8-bit (blockwise-quantized) moments
(``repro/train/optimizer.py``).

The moments live in the reference's layout: a nested dict of the
reference's parameter paths, each stack of layers (``blocks``; whisper's
``enc`` and ``dec``) stacked on a leading layer axis, or a list of layers
where the reference keeps one (recurrentgemma's mixed layers;
``models/common.py::leaf_groups``). So the int8 blocks are the
reference's blocks (a stacked norm vector's padded fallback spans the
layers, as it does there), and a checkpoint of either package holds the
other's optimizer state. The parameters are the port's
:class:`~repro_torch.models.common.ParamTree` and are updated in place;
the update runs in float32 whatever their dtype. Float32 moments are
updated in place as well.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import common as C

_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"     # 'float32' | 'int8'
    schedule: str = "cosine"          # 'cosine' | 'constant' | 'wsd'
    final_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Warmup + {cosine | constant | warmup-stable-decay} schedule, float32.

    WSD (minicpm-2b's schedule, arXiv:2404.06395): stable at peak for 80% of
    steps then linear decay to final_lr_frac.
    """
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.final_lr_frac + (1 - cfg.final_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        stable_frac = 0.8
        decay = torch.where(
            t < stable_frac, 1.0,
            1.0 - (1 - cfg.final_lr_frac) * (t - stable_frac) / (1 - stable_frac))
    else:
        decay = torch.ones_like(t)
    return cfg.learning_rate * warm * decay


# ---------------------------------------------------------------------------
# blockwise int8 moment quantization
# ---------------------------------------------------------------------------

def _quantize(x: torch.Tensor) -> dict:
    """Blockwise int8 along the LAST dim, shape-preserving.

    (..., D) -> q (..., D/256, 256) + scale (..., D/256, 1). Tensors whose
    last dim does not divide 256 fall back to a padded single-row layout
    (1, ceil(size/256), 256).
    """
    x32 = x.to(torch.float32)
    last = x.shape[-1] if x.ndim else 1
    if x.ndim and last % _BLOCK == 0:
        blocks = x32.reshape(*x.shape[:-1], last // _BLOCK, _BLOCK)
    else:
        flat = x32.reshape(-1)
        pad = (-flat.shape[0]) % _BLOCK
        flat = torch.cat([flat, flat.new_zeros((pad,))])
        blocks = flat.reshape(1, -1, _BLOCK)
    scale = blocks.abs().amax(-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp_min(scale, 1e-12)).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def _dequantize(packed: dict, shape, size: int) -> torch.Tensor:
    vals = packed["q"].to(torch.float32) * packed["scale"]
    if vals.numel() == size and vals.ndim == len(shape) + 1:
        return vals.reshape(shape)          # blockwise-last-dim layout
    return vals.reshape(-1)[:size].reshape(shape)   # padded fallback


# ---------------------------------------------------------------------------
# init / update
# ---------------------------------------------------------------------------

def _tree(params) -> dict:
    return params.tree() if isinstance(params, C.ParamTree) else params


def _groups(tree, params: C.ParamTree) -> list:
    """``tree``'s leaf groups in the layout of ``params``' blocks."""
    return C.leaf_groups(_tree(tree), params.stacked_blocks)


def _stacked_shape(path, tensors, params: C.ParamTree) -> tuple:
    return ((len(tensors), *tensors[0].shape) if C.stacked_path(path, params.stacked_blocks)
            else tuple(tensors[0].shape))


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments in the reference's layout (float32, or int8 blocks),
    and step 0, on the parameters' device."""
    groups = _groups(params, params)
    dev = groups[0][1][0].device

    def moment(path, ts):
        z = torch.zeros(_stacked_shape(path, ts, params), dtype=torch.float32, device=dev)
        return _quantize(z) if cfg.moment_dtype == "int8" else z

    return {"m": C.nest((path, moment(path, ts)) for path, ts in groups),
            "v": C.nest((path, moment(path, ts)) for path, ts in groups),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in C.tree_leaves(_tree(tree))))


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step on ``params`` in place, ``grads`` a tree of the
    parameters' shape (``ParamTree.tree()``'s). Returns (params, new_state,
    metrics: grad_norm, lr)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
             if cfg.grad_clip > 0 else None)
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    int8 = cfg.moment_dtype == "int8"
    new_m, new_v = [], []
    for (path, ps), (_, gs) in zip(_groups(params, params), _groups(grads, params)):
        m, v = C.get_path(state["m"], path), C.get_path(state["v"], path)
        shape = _stacked_shape(path, ps, params)
        if int8:
            size = math.prod(shape)
            m, v = _dequantize(m, shape, size), _dequantize(v, shape, size)
        stacked = C.stacked_path(path, params.stacked_blocks)
        for i, (p, g) in enumerate(zip(ps, gs)):
            mi, vi = (m[i], v[i]) if stacked else (m, v)
            g = (g * scale if scale is not None else g).to(torch.float32)
            m_new = cfg.b1 * mi + (1 - cfg.b1) * g
            v_new = cfg.b2 * vi + (1 - cfg.b2) * torch.square(g)
            delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
            if cfg.weight_decay:
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
            mi.copy_(m_new)
            vi.copy_(v_new)
        new_m.append((path, _quantize(m) if int8 else m))
        new_v.append((path, _quantize(v) if int8 else v))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": C.nest(new_m), "v": C.nest(new_v), "step": step}, metrics
