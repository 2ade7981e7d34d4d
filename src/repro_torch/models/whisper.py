"""Whisper-large-v3 backbone (arXiv:2212.04356): encoder-decoder transformer
(``repro/models/whisper.py``).

The conv1d audio frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings ``frames`` (B, num_frames, d_model), the
output the two conv layers would produce from the mel spectrogram. After
that: the encoder (pre-LayerNorm layers, bidirectional attention, GELU
MLPs), the decoder (causal self-attention, cross-attention over the
encoder's memory, GELU MLPs) and the tied embedding head.

Parameters are a :class:`ParamTree` with the reference's names; its two
stacks of layers, ``enc`` and ``dec``, are lists of layers here and are
stacked on a leading layer axis in the reference's layout
(``stacked=("enc", "dec")``: the optimizer's moments and checkpoints).
Numerics follow the reference: activations in ``cfg.dtype``, each
projection with its weight rounded to that dtype, LayerNorm in float32,
float32 attention scores (materialised: the encoder's 1,500 frames are
not a multiple of the KV chunk, so ``attention_forward`` takes full
attention), and float32 logits of dtype-rounded operands from the tied
embedding. Positions are sinusoids for the encoder and the decoder alike,
length-generic as in the reference (no cap at Whisper's 448 text
positions). No kernel of the port is on this path: every product is a
torch op, as in the reference every product is ``jnp.dot``/``einsum``.

Decode keeps a self-attention KV cache and the cross-attention K/V that
``prefill`` projects once from the memory (``cross_k``/``cross_v``, (L, B,
F, G, hd)); prefill sets ``pos`` to the padded length, as the reference
does. With ``cfg.remat`` and grad enabled each encoder and decoder layer
is recomputed in the backward pass (``torch.utils.checkpoint``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import common as C
from repro_torch.models.arch import ArchConfig
from repro_torch.models.common import ParamTree

STACKS = ("enc", "dec")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _sinusoid(positions: torch.Tensor, d: int, dtype: torch.dtype) -> torch.Tensor:
    """Length-generic sinusoidal positions (Whisper's encoder embedding,
    used for the decoder too, as in the reference), computed in float32
    and then cast: (..., d) for positions (...)."""
    half = d // 2
    log_base = torch.tensor(10000.0, dtype=torch.float32).log()
    freqs = torch.exp(-log_base * torch.arange(half, dtype=torch.float32)
                      / max(half - 1, 1)).to(positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _spec(cfg: ArchConfig, seq_len: int, causal: bool) -> C.AttnSpec:
    return C.AttnSpec(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                      head_dim=cfg.resolved_head_dim, causal=causal,
                      impl=C.resolve_attn_impl(cfg, seq_len), chunk=cfg.attention_chunk)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _init_mlp(generator: torch.Generator, d: int, ff: int) -> dict:
    dev = generator.device
    return {"w_up": C.dense_init(generator, d, ff),
            "b_up": torch.zeros((ff,), dtype=torch.float32, device=dev),
            "w_down": C.dense_init(generator, ff, d),
            "b_down": torch.zeros((d,), dtype=torch.float32, device=dev)}


def _norm(d: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """A LayerNorm's gain (ones) and bias (zeros)."""
    return (torch.ones((d,), dtype=torch.float32, device=dev),
            torch.zeros((d,), dtype=torch.float32, device=dev))


def init_layer(generator: torch.Generator, cfg: ArchConfig, decoder: bool) -> dict:
    """One encoder or decoder layer's parameters, with the reference's
    names, shapes and scales."""
    d, dev = cfg.d_model, generator.device
    p: dict = {}
    p["ln1_w"], p["ln1_b"] = _norm(d, dev)
    p["self_attn" if decoder else "attn"] = C.init_attention(generator, d,
                                                             _spec(cfg, 1, decoder))
    p["ln2_w"], p["ln2_b"] = _norm(d, dev)
    if decoder:
        p["cross_attn"] = C.init_attention(generator, d, _spec(cfg, 1, False))
        p["ln3_w"], p["ln3_b"] = _norm(d, dev)
    p["mlp"] = _init_mlp(generator, d, cfg.d_ff)
    return p


def init_params(generator: torch.Generator, cfg: ArchConfig, *,
                serving: bool = False) -> ParamTree:
    """Random float32 parameters on the generator's device (the reference's
    tree, keys and shapes; other numbers, as the generators differ). With
    ``serving``, a serving tree in ``cfg.dtype`` (``common.hold``), each
    layer held as soon as it is drawn."""
    dtype = _dtype(cfg)
    held = (lambda node: C.hold(node, dtype)) if serving else (lambda node: node)
    d, dev = cfg.d_model, generator.device
    tree = {
        "embed": C.embed_init(generator, cfg.vocab_size, d),     # tied head
        "enc": [held(init_layer(generator, cfg, False)) for _ in range(cfg.encoder_layers)],
        "dec": [held(init_layer(generator, cfg, True)) for _ in range(cfg.num_layers)],
    }
    tree["ln_enc_w"], tree["ln_enc_b"] = _norm(d, dev)
    tree["ln_dec_w"], tree["ln_dec_b"] = _norm(d, dev)
    return ParamTree(held(tree), stacked=STACKS)


def params_from_numpy(tree: dict, cfg: ArchConfig,
                      device: str | torch.device | None = None, *,
                      serving: bool = False) -> ParamTree:
    """The reference's parameter tree, as numpy arrays or tensors (``enc``
    and ``dec`` stacked on a leading layer axis, as ``jax.vmap`` leaves
    them, or lists of layers), carried into the port's :class:`ParamTree`
    on ``device`` (default: the CUDA device); with ``serving``, a serving
    tree in ``cfg.dtype``."""
    return C.params_from_numpy(tree, {"enc": cfg.encoder_layers, "dec": cfg.num_layers},
                               device, _dtype(cfg) if serving else None, stacked=STACKS)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _mlp(mp: ParamTree, h: torch.Tensor) -> torch.Tensor:
    dt = h.dtype
    return C.gelu_mlp(h, mp.mat("w_up", dt), mp.mat("b_up", dt), mp.mat("w_down", dt),
                      mp.mat("b_down", dt))


def _enc_layer(x: torch.Tensor, p: ParamTree, positions: torch.Tensor, cfg: ArchConfig,
               spec: C.AttnSpec) -> torch.Tensor:
    h = C.layer_norm(x, p.ln1_w, p.ln1_b, cfg.norm_eps)
    x = x + C.attention_forward(p.attn, h, positions, spec, rope_theta=0.0)
    h = C.layer_norm(x, p.ln2_w, p.ln2_b, cfg.norm_eps)
    return C.maybe_shard(x + _mlp(p.mlp, h), "act_btd")


def _dec_layer(x: torch.Tensor, p: ParamTree, mk: torch.Tensor, mv: torch.Tensor,
               positions: torch.Tensor, mem_pos: torch.Tensor, cfg: ArchConfig,
               spec_self: C.AttnSpec, spec_cross: C.AttnSpec) -> torch.Tensor:
    """A decoder layer over a full sequence, its cross-attention on the
    memory's K/V (``mk``, ``mv``)."""
    h = C.layer_norm(x, p.ln1_w, p.ln1_b, cfg.norm_eps)
    x = x + C.attention_forward(p.self_attn, h, positions, spec_self, rope_theta=0.0)
    h = C.layer_norm(x, p.ln2_w, p.ln2_b, cfg.norm_eps)
    x = x + C.attention_forward(p.cross_attn, h, positions, spec_cross, rope_theta=0.0,
                                kv_override=(mk, mv, mem_pos))
    h = C.layer_norm(x, p.ln3_w, p.ln3_b, cfg.norm_eps)
    return C.maybe_shard(x + _mlp(p.mlp, h), "act_btd")


def _dec_layer_train(x, p, memory, positions, mem_pos, cfg, spec_self, spec_cross):
    """A decoder layer that projects the memory's K/V itself, as the
    reference's layer does (so remat recomputes them)."""
    mk, mv = C.project_kv(p.cross_attn, memory, mem_pos, spec_cross, 0.0)
    return _dec_layer(x, p, mk, mv, positions, mem_pos, cfg, spec_self, spec_cross)


def _run(layer, x: torch.Tensor, layers, cfg: ArchConfig, *args) -> torch.Tensor:
    """``layer(x, p, *args)`` over ``layers`` in order; under ``cfg.remat``
    with grad enabled each layer is recomputed in the backward pass."""
    remat = cfg.remat and torch.is_grad_enabled()
    for p in layers:
        x = (checkpoint(layer, x, p, *args, use_reentrant=False) if remat
             else layer(x, p, *args))
    return x


def encode(params: ParamTree, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """frames: (B, F, d) stub frontend output -> encoder memory (B, F, d)."""
    dtype = _dtype(cfg)
    f = frames.shape[1]
    positions = torch.arange(f, device=frames.device)
    x = frames.to(dtype) + _sinusoid(positions, cfg.d_model, dtype)[None]
    x = _run(_enc_layer, x, params.enc, cfg, positions, cfg, _spec(cfg, f, causal=False))
    return C.layer_norm(x, params.ln_enc_w, params.ln_enc_b, cfg.norm_eps)


def _embed(params: ParamTree, tokens: torch.Tensor, positions: torch.Tensor,
           cfg: ArchConfig, dtype: torch.dtype) -> torch.Tensor:
    """Token embeddings (not scaled) plus sinusoids at ``positions``."""
    return (params.mat("embed", dtype)[tokens.long()]
            + _sinusoid(positions, cfg.d_model, dtype))


def _logits(params: ParamTree, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Final LayerNorm and the tied head: compute-dtype operands, float32
    accumulation and output."""
    x = C.layer_norm(x, params.ln_dec_w, params.ln_dec_b, cfg.norm_eps)
    return x.to(torch.float32) @ params.mat("embed", x.dtype).to(torch.float32).T


def _decoder_inputs(params: ParamTree, batch: dict, cfg: ArchConfig):
    dtype = _dtype(cfg)
    memory = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)
    x = _embed(params, tokens, positions, cfg, dtype)
    mem_pos = torch.arange(memory.shape[1], device=memory.device)
    return (x, memory, positions, mem_pos, _spec(cfg, s, causal=True),
            _spec(cfg, memory.shape[1], causal=False))


def forward(params: ParamTree, batch: dict, cfg: ArchConfig):
    """Teacher-forced training forward. batch: ``frames`` (B, F, d) stub
    embeddings, ``tokens`` (B, S) decoder input. Returns (logits (B, S, V)
    float32, aux 0.0)."""
    x, memory, positions, mem_pos, spec_self, spec_cross = _decoder_inputs(params, batch, cfg)
    x = _run(_dec_layer_train, x, params.dec, cfg, memory, positions, mem_pos, cfg,
             spec_self, spec_cross)
    return _logits(params, x, cfg), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int,
               device: str | torch.device | None = None, dtype=None) -> dict:
    """Self-attention caches (L, B, Smax, G, hd) and cross-attention K/V
    (L, B, num_frames, G, hd) in the compute dtype, on ``device``
    (default: the CUDA device; ``meta`` for shapes only)."""
    dev = resolve_device(device, shapes=True)
    dtype = dtype or _dtype(cfg)
    g, hd, layers = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers

    def zeros(s):
        return torch.zeros((layers, batch_size, s, g, hd), dtype=dtype, device=dev)

    return {"k": zeros(max_seq), "v": zeros(max_seq), "cross_k": zeros(cfg.num_frames),
            "cross_v": zeros(cfg.num_frames),
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev)}


def prefill(params: ParamTree, batch: dict, cfg: ArchConfig, cache: dict):
    """Encode the audio, project each layer's cross-attention K/V once, run
    the decoder prompt (right-padded, with ``batch["lens"]`` when ragged)
    and fill the caches. Returns (logits (B, 1, V) at each last real
    token, cache). ``pos`` becomes the padded length for every row, as in
    the reference."""
    x, memory, positions, mem_pos, spec_self, spec_cross = _decoder_inputs(params, batch, cfg)
    b, s, _ = x.shape
    write = min(s, cache["k"].shape[2])
    mks, mvs = [], []
    for i, p in enumerate(params.dec):
        h = C.layer_norm(x, p.ln1_w, p.ln1_b, cfg.norm_eps)
        sk, sv = C.project_kv(p.self_attn, h, positions, spec_self, 0.0)
        cache["k"][i, :, :write] = sk[:, :write].to(cache["k"].dtype)
        cache["v"][i, :, :write] = sv[:, :write].to(cache["v"].dtype)
        mk, mv = C.project_kv(p.cross_attn, memory, mem_pos, spec_cross, 0.0)
        mks.append(mk)
        mvs.append(mv)
        x = _dec_layer(x, p, mk, mv, positions, mem_pos, cfg, spec_self, spec_cross)
    logits = _logits(params, C.last_token_slice(x, batch), cfg)
    cache = {"k": cache["k"], "v": cache["v"],
             "cross_k": torch.stack(mks).to(cache["cross_k"].dtype),
             "cross_v": torch.stack(mvs).to(cache["cross_v"].dtype),
             "pos": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    return logits, cache


def decode_step(params: ParamTree, tokens: torch.Tensor, cfg: ArchConfig, cache: dict):
    """One token step. tokens (B, 1). Cross-attention reads every memory
    slot (``pos = num_frames - 1``) and writes no cache. Returns (logits
    (B, 1, V), cache)."""
    dtype = _dtype(cfg)
    pos = cache["pos"]
    x = _embed(params, tokens, pos[:, None], cfg, dtype)
    spec_self = _spec(cfg, 1, causal=True)
    spec_cross = _spec(cfg, 1, causal=False)
    mem_last = torch.full_like(pos, cfg.num_frames - 1)
    for i, p in enumerate(params.dec):
        h = C.layer_norm(x, p.ln1_w, p.ln1_b, cfg.norm_eps)
        att, _, _ = C.attention_decode_step(p.self_attn, h, cache["k"][i], cache["v"][i], pos,
                                            spec_self, rope_theta=0.0)
        x = x + att
        h = C.layer_norm(x, p.ln2_w, p.ln2_b, cfg.norm_eps)
        att, _, _ = C.attention_decode_step(p.cross_attn, h, cache["cross_k"][i],
                                            cache["cross_v"][i], mem_last, spec_cross,
                                            rope_theta=0.0, update_cache=False)
        x = x + att
        h = C.layer_norm(x, p.ln3_w, p.ln3_b, cfg.norm_eps)
        x = x + _mlp(p.mlp, h)
    return _logits(params, x, cfg), {**cache, "pos": pos + 1}
