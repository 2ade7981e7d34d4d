"""Decoder-only transformer family, dense / GQA / MQA and the VLM wrapper
(``repro/models/transformer.py``).

Covers codeqwen1.5-7b, granite-34b, llama3-405b, minicpm-2b (dense),
granite-moe-1b-a400m, moonshot-v1-16b-a3b (moe) and the phi-3-vision
backbone (vlm). Per block (llama-style): RMSNorm -> attention (rotary, GQA)
-> residual; RMSNorm -> SwiGLU (or GELU) MLP, or the mixture of experts
(``models/moe.py``, whose load-balancing losses ``forward`` adds up over
the layers) -> residual. Prefill and decode run the same MoE block
(capacity 8 at one token a row).

Parameters are a :class:`repro_torch.models.common.ParamTree` with the
reference's names, ``blocks`` a list of layers where the reference stacks
them. Numerics follow the reference: activations in ``cfg.dtype``, each
projection with its weight rounded to that dtype, norms and rotary in
float32, float32 attention scores, and float32 logits from dtype-rounded
operands. The layers run as a Python loop (the reference's ``lax.scan``);
with ``cfg.remat`` and grad enabled each layer is recomputed in the
backward pass (``torch.utils.checkpoint``), as ``jax.checkpoint`` does.
The KV cache is written in place. ``init_params(..., serving=True)`` and
``params_from_numpy(..., serving=True)`` build a serving tree
(``common.hold``): each matrix held in the compute dtype only, layer by
layer, for a model whose float32 tree does not fit on the card
(moonshot-v1-16b-a3b: 112.2 GB in float32, 56.1 GB in bf16).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import common as C
from repro_torch.models.arch import ArchConfig
from repro_torch.models.common import ParamTree
from repro_torch.models.moe import init_moe, moe_forward


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attn_spec(cfg: ArchConfig, seq_len: int, window: int = 0) -> C.AttnSpec:
    return C.AttnSpec(
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, causal=True, window=window,
        impl=C.resolve_attn_impl(cfg, seq_len), chunk=cfg.attention_chunk)


def init_block(generator: torch.Generator, cfg: ArchConfig) -> dict:
    """One layer's parameters, with the reference's names, shapes and
    scales."""
    d, dev = cfg.d_model, generator.device

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    p = {"ln_attn": zeros(d),
         "attn": C.init_attention(generator, d, _attn_spec(cfg, 1)),
         "ln_mlp": zeros(d)}
    if cfg.num_experts:
        p["moe"] = init_moe(generator, cfg)
    elif cfg.mlp_type == "gelu":
        p["mlp"] = {"w_up": C.dense_init(generator, d, cfg.d_ff), "b_up": zeros(cfg.d_ff),
                    "w_down": C.dense_init(generator, cfg.d_ff, d), "b_down": zeros(d)}
    else:
        p["mlp"] = {"w_gate": C.dense_init(generator, d, cfg.d_ff),
                    "w_up": C.dense_init(generator, d, cfg.d_ff),
                    "w_down": C.dense_init(generator, cfg.d_ff, d)}
    return p


def init_params(generator: torch.Generator, cfg: ArchConfig, *,
                serving: bool = False) -> ParamTree:
    """Random float32 parameters on the generator's device (the reference's
    tree, keys and shapes; other numbers, as the generators differ). With
    ``serving``, a serving tree in ``cfg.dtype`` (``common.hold``), each
    layer held as soon as it is drawn."""
    dtype = _dtype(cfg)
    held = (lambda node: C.hold(node, dtype)) if serving else (lambda node: node)
    tree = {
        "embed": C.embed_init(generator, cfg.vocab_size, cfg.d_model),
        "blocks": [held(init_block(generator, cfg)) for _ in range(cfg.num_layers)],
        "ln_final": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                device=generator.device),
        "lm_head": C.dense_init(generator, cfg.d_model, cfg.vocab_size, scale=0.02),
    }
    if cfg.family == "vlm":
        tree["patch_proj"] = C.dense_init(generator, cfg.d_patch, cfg.d_model)
    return ParamTree(held(tree), stacked=True)


def params_from_numpy(tree: dict, cfg: ArchConfig,
                      device: str | torch.device | None = None, *,
                      serving: bool = False) -> ParamTree:
    """The reference's parameter tree, as numpy arrays or tensors
    (``blocks`` stacked on a leading layer axis), carried into the port's
    :class:`ParamTree` on ``device`` (default: the CUDA device); with
    ``serving``, a serving tree in ``cfg.dtype``."""
    return C.params_from_numpy(tree, cfg.num_layers, device,
                               _dtype(cfg) if serving else None, stacked=True)


# ---------------------------------------------------------------------------
# block forward (shared by train / prefill / decode)
# ---------------------------------------------------------------------------

def _block_fwd(p: ParamTree, x: torch.Tensor, positions: torch.Tensor,
               cfg: ArchConfig, spec: C.AttnSpec):
    h = C.rms_norm(x, p.ln_attn, cfg.norm_eps)
    x = x + C.attention_forward(p.attn, h, positions, spec, cfg.rope_theta)
    h = C.rms_norm(x, p.ln_mlp, cfg.norm_eps)
    if cfg.num_experts:
        y, aux = moe_forward(p.moe, h, cfg)
        return x + y, aux
    return x + _mlp(p.mlp, h, cfg), torch.zeros((), device=x.device)


def _mlp(mp: ParamTree, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dt = h.dtype
    if cfg.mlp_type == "gelu":
        return C.gelu_mlp(h, mp.mat("w_up", dt), mp.mat("b_up", dt),
                          mp.mat("w_down", dt), mp.mat("b_down", dt))
    return C.swiglu(h, mp.mat("w_gate", dt), mp.mat("w_up", dt), mp.mat("w_down", dt))


def embed_inputs(params: ParamTree, batch: dict, cfg: ArchConfig,
                 dtype: torch.dtype) -> torch.Tensor:
    """Token embeddings; VLM prepends projected patch embeddings (stub
    frontend supplies ``patch_embeds`` (B, P, d_patch))."""
    x = C.embed_tokens(params, batch["tokens"], cfg.d_model, dtype)
    if cfg.family == "vlm":
        proj = batch["patch_embeds"].to(dtype) @ params.mat("patch_proj", dtype)
        x = torch.cat([proj, x], dim=1)
    return x


def forward(params: ParamTree, batch: dict, cfg: ArchConfig):
    """Full-sequence forward -> (logits (B, S_total, V) float32, aux loss)."""
    dtype = _dtype(cfg)
    x = embed_inputs(params, batch, cfg, dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    spec = _attn_spec(cfg, x.shape[1], window=cfg.window)
    x = C.maybe_shard(x, "act_btd")

    def layer(x, p):
        y, aux = _block_fwd(p, C.grad_cast(x, dtype), positions, cfg, spec)
        return C.maybe_shard(y, "act_btd"), aux

    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), device=x.device)
    for p in params.blocks:
        x, a = checkpoint(layer, x, p, use_reentrant=False) if remat else layer(x, p)
        aux = aux + a
    return C.lm_logits(params, x, cfg.norm_eps), aux


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int,
               device: str | torch.device | None = None, dtype=None) -> dict:
    """Per-layer K/V caches (L, B, Smax, G, hd) in the compute dtype (Smax
    capped at the window when there is one), on ``device`` (default: the
    CUDA device; ``meta`` for shapes only)."""
    dev = resolve_device(device, shapes=True)
    dtype = dtype or _dtype(cfg)
    smax = min(max_seq, cfg.window) if cfg.window else max_seq
    shape = (cfg.num_layers, batch_size, smax, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev)}


def prefill(params: ParamTree, batch: dict, cfg: ArchConfig, cache: dict):
    """Run the full prompt (right-padded, with ``batch["lens"]`` when
    ragged), fill the cache, return (logits (B, 1, V) at each last real
    token, cache). ``pos`` becomes the padded length for every row, as in
    the reference, so a ragged wave's decode also attends to the pads."""
    dtype = _dtype(cfg)
    x = embed_inputs(params, batch, cfg, dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    spec = _attn_spec(cfg, s, window=cfg.window)
    x = C.maybe_shard(x, "act_btd")
    ks, vs = [], []
    for p in params.blocks:
        h = C.rms_norm(x, p.ln_attn, cfg.norm_eps)
        k, v = C.project_kv(p.attn, h, positions, spec, cfg.rope_theta)
        ks.append(k)
        vs.append(v)
        x, _ = _block_fwd(p, x, positions, cfg, spec)
        x = C.maybe_shard(x, "act_btd")
    x = C.rms_norm(x, params.ln_final, cfg.norm_eps)
    last = C.last_token_slice(x, batch)
    logits = last.to(torch.float32) @ params.mat("lm_head", dtype).to(torch.float32)
    # the last min(S, Smax) positions go to slots 0.. (the reference's
    # dynamic_update_slice at the origin; a window keeps its last Smax)
    write = min(s, cache["k"].shape[2])
    for i, (k, v) in enumerate(zip(ks, vs)):
        cache["k"][i, :, :write] = k[:, s - write:].to(cache["k"].dtype)
        cache["v"][i, :, :write] = v[:, s - write:].to(cache["v"].dtype)
    cache = {"k": cache["k"], "v": cache["v"],
             "pos": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    return logits, cache


def decode_step(params: ParamTree, tokens: torch.Tensor, cfg: ArchConfig, cache: dict):
    """One token step. tokens (B, 1). Returns (logits (B, 1, V), cache)."""
    dtype = _dtype(cfg)
    x = C.embed_tokens(params, tokens, cfg.d_model, dtype)
    pos = cache["pos"]
    spec = _attn_spec(cfg, 1, window=cfg.window)
    for i, p in enumerate(params.blocks):
        h = C.rms_norm(x, p.ln_attn, cfg.norm_eps)
        att, _, _ = C.attention_decode_step(p.attn, h, cache["k"][i], cache["v"][i], pos,
                                            spec, cfg.rope_theta)
        x = x + att
        h = C.rms_norm(x, p.ln_mlp, cfg.norm_eps)
        x = x + (moe_forward(p.moe, h, cfg)[0] if cfg.num_experts else _mlp(p.mlp, h, cfg))
    return (C.lm_logits(params, x, cfg.norm_eps),
            {"k": cache["k"], "v": cache["v"], "pos": pos + 1})
