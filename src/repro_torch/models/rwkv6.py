"""RWKV-6 "Finch" (rwkv6-7b): attention-free LM with data-dependent decay
(``repro/models/rwkv6.py``).

Per layer: a **time-mix** block (token-shift lerps, r/k/v/g projections, the
data-dependent per-channel decay ``w = exp(-exp(w0 + tanh(x A) B))``, the WKV
recurrence with bonus ``u``, grouped-head output norm, silu(g) gating) and a
**channel-mix** block (squared-relu FFN gated by sigmoid(r)), as the
reference has them (static lerp coefficients in place of the ddlerp LoRA).

Parameters are a :class:`ParamTree` (``models/common.py``): ``nn.Module``s
whose float32 parameters carry the reference's names and shapes, with
``blocks`` a list of layers where the reference stacks them on a leading
axis. The functions
below take it as ``params`` and mirror the reference's numerics: the
compute dtype is ``cfg.dtype``; each projection uses its weight rounded to
that dtype (the reference's ``w.astype(x.dtype)`` at the call; here the
rounded copy is made once and kept, the same values in half the bytes a
decode step reads); the decay runs in float32; the WKV recurrence takes r,
k, v in the compute dtype and runs in float32 (the reference widens them
first: the same values), its output rounded to the compute dtype; the LM
head multiplies dtype-rounded operands with float32 accumulation and
output. The WKV recurrence goes through
:func:`repro_torch.kernels.ops.wkv6`: the hand-written CUDA kernel for CUDA
tensors, the plain version for CPU tensors. The reference's model takes its
plain version (``wkv6_ref``) on every device; the two compute one function.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import common as C
from repro_torch.models.arch import ArchConfig
from repro_torch.models.common import ParamTree

_DECAY_LORA = 64


def _heads(cfg: ArchConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_size


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_layer(generator: torch.Generator, cfg: ArchConfig) -> dict:
    """One layer's parameters, with the reference's shapes and scales."""
    d, ff, hs = cfg.d_model, cfg.d_ff, cfg.rwkv_head_size
    h = _heads(cfg)
    dev = generator.device

    def full(value):
        return torch.full((d,), value, dtype=torch.float32, device=dev)

    return {
        "ln1_w": full(1.0), "ln1_b": full(0.0), "ln2_w": full(1.0), "ln2_b": full(0.0),
        "tm": {
            "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5), "mu_w": full(0.5),
            "mu_g": full(0.5),
            "w_r": C.dense_init(generator, d, d),
            "w_k": C.dense_init(generator, d, d),
            "w_v": C.dense_init(generator, d, d),
            "w_g": C.dense_init(generator, d, d),
            "w_o": C.dense_init(generator, d, d),
            "w0": full(-0.6),                                   # decay bias
            "w_lora_a": C.dense_init(generator, d, _DECAY_LORA, scale=0.01),
            "w_lora_b": C.dense_init(generator, _DECAY_LORA, d, scale=0.01),
            "u": C.normal(generator, (h, hs), 0.1),
            "gn_w": full(1.0), "gn_b": full(0.0),
        },
        "cm": {
            "mu_k": full(0.5), "mu_r": full(0.5),
            "w_k": C.dense_init(generator, d, ff),
            "w_v": C.dense_init(generator, ff, d),
            "w_r": C.dense_init(generator, d, d),
        },
    }


def init_params(generator: torch.Generator, cfg: ArchConfig) -> ParamTree:
    """Random parameters on the generator's device (the reference's
    ``init_params`` tree, keys, shapes and float32 dtypes; other numbers,
    as the generators differ)."""
    d, dev = cfg.d_model, generator.device

    def full(value):
        return torch.full((d,), value, dtype=torch.float32, device=dev)

    return ParamTree({
        "embed": C.embed_init(generator, cfg.vocab_size, d),
        "ln0_w": full(1.0), "ln0_b": full(0.0),
        "blocks": [init_layer(generator, cfg) for _ in range(cfg.num_layers)],
        "lnf_w": full(1.0), "lnf_b": full(0.0),
        "lm_head": C.dense_init(generator, d, cfg.vocab_size, scale=0.02),
    }, stacked=True)


def params_from_numpy(tree: dict, cfg: ArchConfig,
                      device: str | torch.device | None = None) -> ParamTree:
    """The reference's parameter tree, as numpy arrays or tensors
    (``blocks`` stacked on a leading layer axis, as ``jax.vmap`` leaves
    it), carried into the port's :class:`ParamTree` on ``device`` (default:
    the CUDA device)."""
    return C.params_from_numpy(tree, cfg.num_layers, device, stacked=True)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _lerp(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (xs - x) * mu.to(x.dtype)


def _decay(tm: ParamTree, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay in (0, 1): exp(-exp(w0 + tanh(x A) B)), float32."""
    lora = torch.tanh(xw.to(torch.float32) @ tm.w_lora_a) @ tm.w_lora_b
    return torch.exp(-torch.exp(tm.w0 + lora))


def _group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, heads: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head LayerNorm over the head channel (RWKV's GroupNorm), float32
    with the population variance."""
    b_, t, d = x.shape
    xh = x.reshape(b_, t, heads, d // heads).to(torch.float32)
    mu = xh.mean(-1, keepdim=True)
    var = (xh - mu).square().mean(-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(b_, t, d) * w + b).to(x.dtype)


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """The token before each position: ``x_prev`` then ``x[:, :-1]``."""
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def time_mix(tm: ParamTree, x: torch.Tensor, x_prev: torch.Tensor,
             state: torch.Tensor, cfg: ArchConfig):
    """x (B, T, d); x_prev (B, d) the token before the window; state
    (B, H, K, V) float32. Returns (out (B, T, d), last x (B, d), new state).
    ``ops.wkv6`` widens r, k, v to float32 itself, so they go in as they are."""
    bsz, t, d = x.shape
    h, hs = _heads(cfg), cfg.rwkv_head_size
    dt = x.dtype
    xs = _shift(x, x_prev)
    r = _lerp(x, xs, tm.mu_r) @ tm.mat("w_r", dt)
    k = _lerp(x, xs, tm.mu_k) @ tm.mat("w_k", dt)
    v = _lerp(x, xs, tm.mu_v) @ tm.mat("w_v", dt)
    g = _lerp(x, xs, tm.mu_g) @ tm.mat("w_g", dt)
    w = _decay(tm, _lerp(x, xs, tm.mu_w))

    def heads(a):
        return a.reshape(bsz, t, h, hs)

    out, state = ops.wkv6(heads(r), heads(k), heads(v), heads(w), tm.u, state)
    out = _group_norm(out.reshape(bsz, t, d), tm.gn_w, tm.gn_b, h)
    out = out * F.silu(g)
    return out @ tm.mat("w_o", dt), x[:, -1], state


def channel_mix(cm: ParamTree, x: torch.Tensor, x_prev: torch.Tensor):
    """Squared-relu FFN gated by sigmoid(r). Returns (out, last x (B, d))."""
    dt = x.dtype
    xs = _shift(x, x_prev)
    k = torch.square(torch.relu(_lerp(x, xs, cm.mu_k) @ cm.mat("w_k", dt)))
    k = C.maybe_shard(k, "act_ff")
    kv = k @ cm.mat("w_v", dt)
    return torch.sigmoid(_lerp(x, xs, cm.mu_r) @ cm.mat("w_r", dt)) * kv, x[:, -1]


def _layer(p: ParamTree, x, tm_x, cm_x, wkv_state, cfg: ArchConfig):
    h = C.layer_norm(x, p.ln1_w, p.ln1_b, cfg.norm_eps)
    out, tm_x, wkv_state = time_mix(p.tm, h, tm_x, wkv_state, cfg)
    x = x + out
    h = C.layer_norm(x, p.ln2_w, p.ln2_b, cfg.norm_eps)
    out, cm_x = channel_mix(p.cm, h, cm_x)
    return x + out, tm_x, cm_x, wkv_state


# ---------------------------------------------------------------------------
# public API (the reference's ModelDef functions)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int,
               device: str | torch.device | None = None) -> dict:
    """The O(1) recurrent state of every layer (``max_seq`` is unused: the
    state does not grow), on ``device`` (default: the CUDA device;
    ``meta`` for shapes only)."""
    dev = resolve_device(device, shapes=True)
    h, hs = _heads(cfg), cfg.rwkv_head_size
    sh = (cfg.num_layers, batch_size)
    return {
        "tm_x": torch.zeros((*sh, cfg.d_model), dtype=torch.float32, device=dev),
        "cm_x": torch.zeros((*sh, cfg.d_model), dtype=torch.float32, device=dev),
        "wkv": torch.zeros((*sh, h, hs, hs), dtype=torch.float32, device=dev),
        "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
    }


def _embed(params: ParamTree, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = params.embed[tokens.long()].to(getattr(torch, cfg.dtype))
    return C.layer_norm(x, params.ln0_w, params.ln0_b, cfg.norm_eps)


def _logits(params: ParamTree, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """LM head: compute-dtype operands, float32 accumulation and output (a
    bf16 matmul would round the logits to bf16 and could flip an argmax)."""
    x = C.layer_norm(x, params.lnf_w, params.lnf_b, cfg.norm_eps)
    return x.to(torch.float32) @ params.mat("lm_head", x.dtype).to(torch.float32)


def _run(params: ParamTree, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """The layer loop shared by forward, prefill and decode (the reference's
    ``lax.scan`` over stacked layers). With ``cfg.remat`` and grad on, each
    layer is checkpointed (its forward runs again in the backward pass), as
    the reference's ``jax.checkpoint`` of the layer. Returns (x, a new
    cache)."""
    remat = cfg.remat and torch.is_grad_enabled()
    states = []
    for i, p in enumerate(params.blocks):
        args = (p, x, cache["tm_x"][i], cache["cm_x"][i], cache["wkv"][i], cfg)
        x, *st = checkpoint(_layer, *args, use_reentrant=False) if remat else _layer(*args)
        x = C.maybe_shard(x, "act_btd")
        states.append(st)
    new = {name: torch.stack([s[j] for s in states]).to(cache[name].dtype)
           for j, name in enumerate(("tm_x", "cm_x", "wkv"))}
    new["pos"] = cache["pos"]
    return x, new


def forward(params: ParamTree, batch: dict, cfg: ArchConfig):
    """(logits (B, T, vocab) float32, aux loss 0.0) over whole sequences."""
    tokens = batch["tokens"]
    cache = init_cache(cfg, tokens.shape[0], 0, tokens.device)
    x, _ = _run(params, _embed(params, tokens, cfg), cache, cfg)
    return _logits(params, x, cfg), torch.zeros((), device=tokens.device)


def prefill(params: ParamTree, batch: dict, cfg: ArchConfig, cache: dict):
    """Run the prompts (right-padded, with ``batch["lens"]`` when ragged)
    from ``cache``. Returns (logits (B, 1, vocab) at each last real token,
    the cache after the whole padded window)."""
    tokens = batch["tokens"]
    x, cache = _run(params, _embed(params, tokens, cfg), cache, cfg)
    logits = _logits(params, C.last_token_slice(x, batch), cfg)
    cache["pos"] = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                              device=tokens.device)
    return logits, cache


def decode_step(params: ParamTree, tokens: torch.Tensor, cfg: ArchConfig, cache: dict):
    """One token per row: tokens (B, 1). Returns (logits (B, 1, vocab), cache)."""
    pos = cache["pos"]
    x, cache = _run(params, _embed(params, tokens, cfg), cache, cfg)
    cache["pos"] = pos + 1
    return _logits(params, x, cfg), cache
