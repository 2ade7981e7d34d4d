"""Shared model building blocks (``repro/models/common.py``), the part
RWKV-6 needs: initialisers on an explicit ``torch.Generator``, LayerNorm and
the ragged-prefill last-token slice. Attention, rotary embeddings and the
MLPs wait for the transformer models.
"""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               scale: float | None = None) -> torch.Tensor:
    """(in_dim, out_dim) float32 normal * scale (default 1/sqrt(in_dim)), on
    the generator's device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return torch.randn((in_dim, out_dim), generator=generator, dtype=torch.float32,
                       device=generator.device).mul_(scale)


def embed_init(generator: torch.Generator, vocab: int, dim: int) -> torch.Tensor:
    return torch.randn((vocab, dim), generator=generator, dtype=torch.float32,
                       device=generator.device).mul_(0.02)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with the population variance, in float32,
    cast back to x's dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def last_token_slice(x: torch.Tensor, batch: dict) -> torch.Tensor:
    """(B, 1, D) hidden state at each sequence's last *real* token.

    Ragged serving waves right-pad ``batch["tokens"]`` and pass
    ``batch["lens"]`` (B,) with the true prompt lengths; the logits the
    sampler needs then live at column ``lens - 1`` (plus any frontend prefix
    preceding the tokens), not at the padded final column. Without ``lens``
    this is ``x[:, -1:]``.
    """
    lens = batch.get("lens")
    if lens is None:
        return x[:, -1:]
    off = x.shape[1] - batch["tokens"].shape[1]
    idx = off + torch.as_tensor(lens, device=x.device).long() - 1
    return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[-1]))
