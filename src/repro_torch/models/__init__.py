"""Model registry: ArchConfig -> ModelDef dispatch (``repro/models/__init__.py``).

The port runs the ``dense``, ``vlm`` and ``moe`` families (``transformer``),
the ``ssm`` family (RWKV-6) and the ``hybrid`` family (recurrentgemma). The
reference's ``audio`` family (whisper) is still to port (``ROADMAP.md``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models.arch import ArchConfig, ShapeConfig, SHAPES, LONG_CONTEXT_ARCHS  # noqa: F401


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """Uniform interface every architecture implements."""
    init: Callable[..., object]          # (generator, cfg) -> params
    forward: Callable[..., tuple]        # (params, batch, cfg) -> (logits, aux)
    init_cache: Callable[..., dict]      # (cfg, batch, max_seq, device) -> cache
    prefill: Callable[..., tuple]        # (params, batch, cfg, cache)
    decode_step: Callable[..., tuple]    # (params, tokens, cfg, cache)
    params_from_numpy: Callable[..., object]   # (reference tree, cfg, device) -> params


def get_model(cfg: ArchConfig) -> ModelDef:
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer as m
    elif cfg.family == "ssm":
        from repro_torch.models import rwkv6 as m
    elif cfg.family == "hybrid":
        from repro_torch.models import recurrentgemma as m
    elif cfg.family == "audio":
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet; see "
            "ROADMAP.md, queue 1 item 5")
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return ModelDef(init=m.init_params, forward=m.forward,
                    init_cache=m.init_cache, prefill=m.prefill,
                    decode_step=m.decode_step, params_from_numpy=m.params_from_numpy)
