"""RecurrentGemma-2B (Griffin, arXiv:2402.19427): RG-LRU and local attention
(``repro/models/recurrentgemma.py``).

Layers follow a repeating (recurrent, recurrent, attention) pattern:

* **recurrent**: RMSNorm -> [x branch: linear -> causal depthwise conv
  (width 4) -> RG-LRU] gated by [gate branch: linear -> GELU (tanh
  approximation)] -> output linear -> residual. RG-LRU:
  ``a_t = sigmoid(Lambda)^(8 sigmoid(r_t))`` per channel and
  ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)``;
* **attention**: local sliding-window MQA with rotary embeddings
  (``models/common.py``);
* every layer then: RMSNorm -> SwiGLU MLP -> residual (the reference's
  docstring says GeGLU; its code, and so the port, runs ``swiglu``).

``blocks`` is a list of layers of two kinds, as in the reference (not
stacked). Numerics follow the reference: activations in ``cfg.dtype``,
each projection and the conv with weights rounded to that dtype; the RG-LRU
gates, decay and scan in float32 (``x32 @ w_rec_gate`` is a float32
product: TF32 stays off, ``device.py``). The scan ``h_t = a_t h_{t-1} + g_t``
goes through :func:`repro_torch.kernels.ops.rg_lru_scan`: the hand-written
CUDA kernel for CUDA tensors (one launch a recurrent layer a call), its
plain version for CPU tensors; the two agree bit for bit. Decode state: a
ring KV cache for attention layers (prefill writes the last ``keep``
positions at slots ``[0, keep)``, as the reference does), (conv tail, h)
for recurrent ones. The state also runs over a ragged wave's pad tokens,
as in the reference (``ROADMAP.md`` section 3). With ``serving=True`` the
parameters form a serving tree (``common.hold``): the gates, ``lambda`` and
the norms stay float32.
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

_LRU_C = 8.0


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pattern(cfg: ArchConfig) -> tuple[str, ...]:
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    reps = -(-cfg.num_layers // len(pat))
    return (pat * reps)[: cfg.num_layers]


def _d_rnn(cfg: ArchConfig) -> int:
    return cfg.d_rnn or cfg.d_model


def _attn_spec(cfg: ArchConfig, seq_len: int) -> C.AttnSpec:
    return C.AttnSpec(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                      head_dim=cfg.resolved_head_dim, causal=True,
                      window=cfg.window,
                      impl=C.resolve_attn_impl(cfg, seq_len),
                      chunk=cfg.attention_chunk)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_layer(generator: torch.Generator, kind: str, cfg: ArchConfig) -> dict:
    """One layer's parameters (``kind`` "rec" or "attn"), with the
    reference's names, shapes and scales."""
    d, ff = cfg.d_model, cfg.d_ff
    rnn = _d_rnn(cfg)
    dev = generator.device

    def full(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=dev)

    p: dict = {
        "ln_mix": full(d, 0.0),
        "ln_mlp": full(d, 0.0),
        "mlp": {
            "w_gate": C.dense_init(generator, d, ff),
            "w_up": C.dense_init(generator, d, ff),
            "w_down": C.dense_init(generator, ff, d),
        },
    }
    if kind == "attn":
        p["attn"] = C.init_attention(generator, d, _attn_spec(cfg, 1))
    else:
        p["rec"] = {
            "w_x": C.dense_init(generator, d, rnn),
            "w_gate": C.dense_init(generator, d, rnn),
            "conv_w": C.normal(generator, (cfg.conv_width, rnn), 0.1),
            "conv_b": full(rnn, 0.0),
            "lambda": full(rnn, 2.0),                 # sigmoid -> a ~ .88
            "w_input_gate": C.dense_init(generator, rnn, rnn, scale=0.01),
            "b_input_gate": full(rnn, 0.0),
            "w_rec_gate": C.dense_init(generator, rnn, rnn, scale=0.01),
            "b_rec_gate": full(rnn, 0.0),
            "w_out": C.dense_init(generator, rnn, d),
        }
    return p


def init_params(generator: torch.Generator, cfg: ArchConfig, *,
                serving: bool = False) -> ParamTree:
    """Random float32 parameters on the generator's device (the reference's
    tree, keys and shapes; other numbers, as the generators differ). With
    ``serving``, a serving tree in ``cfg.dtype``, each layer held as soon
    as it is drawn."""
    dtype = _dtype(cfg)
    held = (lambda node: C.hold(node, dtype)) if serving else (lambda node: node)
    tree = {
        "embed": C.embed_init(generator, cfg.vocab_size, cfg.d_model),
        "blocks": [held(init_layer(generator, kind, cfg)) for kind in _pattern(cfg)],
        "ln_final": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                device=generator.device),
        "lm_head": C.dense_init(generator, cfg.d_model, cfg.vocab_size, scale=0.02),
    }
    return ParamTree(held(tree), stacked=False)


def params_from_numpy(tree: dict, cfg: ArchConfig,
                      device: str | torch.device | None = None, *,
                      serving: bool = False) -> ParamTree:
    """The reference's parameter tree (``blocks`` a list of layer dicts),
    as numpy arrays or tensors, carried into the port's :class:`ParamTree`
    on ``device`` (default: the CUDA device); with ``serving``, a serving
    tree in ``cfg.dtype``."""
    return C.params_from_numpy(tree, cfg.num_layers, device,
                               _dtype(cfg) if serving else None, stacked=False)


# ---------------------------------------------------------------------------
# RG-LRU + conv
# ---------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None = None):
    """Depthwise causal conv. x (B, T, rnn); w (W, rnn) and b (rnn,) in x's
    dtype; tail (B, W-1, rnn) the carried inputs. Returns (y, new tail):
    shifted adds in the reference's order."""
    width = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xfull = torch.cat([tail, x], dim=1)               # (B, T+W-1, rnn)
    t = x.shape[1]
    y = torch.zeros_like(x)
    for j in range(width):
        y = y + xfull[:, j:j + t] * w[width - 1 - j]
    y = y + b
    return y, xfull[:, -(width - 1):] if width > 1 else tail


def _rg_lru(rec: ParamTree, x: torch.Tensor, h0: torch.Tensor):
    """x (B, T, rnn) post-conv; h0 (B, rnn) float32. Returns (y in x's
    dtype, hT float32)."""
    x32 = x.to(torch.float32)
    r = torch.sigmoid(x32 @ rec.w_rec_gate + rec.b_rec_gate)
    i = torch.sigmoid(x32 @ rec.w_input_gate + rec.b_input_gate)
    log_a = _LRU_C * r * F.logsigmoid(getattr(rec, "lambda"))[None, None, :]
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-12)) * (i * x32)
    y, h_t = ops.rg_lru_scan(a, gated, h0.to(torch.float32))
    return y.to(x.dtype), h_t


def _rec_block(rec: ParamTree, x: torch.Tensor, conv_tail, h0):
    """The recurrent temporal-mix branch. Returns (out, new conv tail, hT)."""
    dt = x.dtype
    xb = x @ rec.mat("w_x", dt)
    gate = F.gelu(x @ rec.mat("w_gate", dt), approximate="tanh")
    xb, conv_tail = _causal_conv(xb, rec.mat("conv_w", dt), rec.mat("conv_b", dt), conv_tail)
    y, h_t = _rg_lru(rec, xb, h0)
    return (y * gate) @ rec.mat("w_out", dt), conv_tail, h_t


def _mlp_residual(p: ParamTree, x: torch.Tensor, eps: float) -> torch.Tensor:
    h = C.rms_norm(x, p.ln_mlp, eps)
    dt, m = h.dtype, p.mlp
    return x + C.swiglu(h, m.mat("w_gate", dt), m.mat("w_up", dt), m.mat("w_down", dt))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def forward(params: ParamTree, batch: dict, cfg: ArchConfig):
    """Full-sequence forward -> (logits (B, S, V) float32, aux 0.0)."""
    dtype = _dtype(cfg)
    x = C.embed_tokens(params, batch["tokens"], cfg.d_model, dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    spec = _attn_spec(cfg, s)
    rnn = _d_rnn(cfg)

    def blk(x, p, kind):
        h = C.rms_norm(x, p.ln_mix, cfg.norm_eps)
        if kind == "attn":
            mix = C.attention_forward(p.attn, h, positions, spec, cfg.rope_theta)
        else:
            h0 = torch.zeros((b, rnn), dtype=torch.float32, device=x.device)
            mix, _, _ = _rec_block(p.rec, h, None, h0)
        return _mlp_residual(p, x + mix, cfg.norm_eps)

    remat = cfg.remat and torch.is_grad_enabled()
    for p, kind in zip(params.blocks, _pattern(cfg)):
        x = checkpoint(blk, x, p, kind, use_reentrant=False) if remat else blk(x, p, kind)
        x = C.maybe_shard(x, "act_btd")
    return C.lm_logits(params, x, cfg.norm_eps), torch.zeros((), device=x.device)


def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int,
               device: str | torch.device | None = None, dtype=None) -> dict:
    """Per-layer decode state on ``device`` (default: the CUDA device;
    ``meta`` for shapes only): a ring K/V cache (B, min(window, max_seq),
    G, hd) in the compute dtype for an attention layer, the conv tail (B,
    W-1, rnn) in the compute dtype and h (B, rnn) float32 for a recurrent
    one."""
    dev = resolve_device(device, shapes=True)
    dtype = dtype or _dtype(cfg)
    rnn = _d_rnn(cfg)
    window = min(cfg.window or max_seq, max_seq)
    layers = []
    for kind in _pattern(cfg):
        if kind == "attn":
            shape = (batch_size, window, cfg.num_kv_heads, cfg.resolved_head_dim)
            layers.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                           "v": torch.zeros(shape, dtype=dtype, device=dev)})
        else:
            layers.append({
                "conv": torch.zeros((batch_size, cfg.conv_width - 1, rnn), dtype=dtype,
                                    device=dev),
                "h": torch.zeros((batch_size, rnn), dtype=torch.float32, device=dev)})
    return {"pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            "layers": layers}


def prefill(params: ParamTree, batch: dict, cfg: ArchConfig, cache: dict):
    """Run the prompt (right-padded, with ``batch["lens"]`` when ragged),
    fill the state, return (logits (B, 1, V) at each last real token,
    cache). ``pos`` becomes the padded length for every row. An attention
    layer's last ``keep = min(window, S)`` positions go to slots [0, keep)
    (the reference's simplification: that is slot ``pos % window`` only
    when ``S <= window`` or ``S % window == 0``)."""
    dtype = _dtype(cfg)
    x = C.embed_tokens(params, batch["tokens"], cfg.d_model, dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    spec = _attn_spec(cfg, s)
    rnn = _d_rnn(cfg)
    layers = []
    for p, kind, lc in zip(params.blocks, _pattern(cfg), cache["layers"]):
        h = C.rms_norm(x, p.ln_mix, cfg.norm_eps)
        if kind == "attn":
            k, v = C.project_kv(p.attn, h, positions, spec, cfg.rope_theta)
            mix = C.attention_forward(p.attn, h, positions, spec, cfg.rope_theta)
            keep = min(lc["k"].shape[1], s)
            lc["k"][:, :keep] = k[:, s - keep:].to(lc["k"].dtype)
            lc["v"][:, :keep] = v[:, s - keep:].to(lc["v"].dtype)
            layers.append(lc)
        else:
            h0 = torch.zeros((b, rnn), dtype=torch.float32, device=x.device)
            mix, tail, h_t = _rec_block(p.rec, h, None, h0)
            layers.append({"conv": tail.to(lc["conv"].dtype), "h": h_t})
        x = _mlp_residual(p, x + mix, cfg.norm_eps)
    logits = C.lm_logits(params, C.last_token_slice(x, batch), cfg.norm_eps)
    return logits, {"pos": torch.full((b,), s, dtype=torch.int32, device=x.device),
                    "layers": layers}


def decode_step(params: ParamTree, tokens: torch.Tensor, cfg: ArchConfig, cache: dict):
    """One token step. tokens (B, 1). Returns (logits (B, 1, V), cache);
    the attention caches are written in place."""
    dtype = _dtype(cfg)
    x = C.embed_tokens(params, tokens, cfg.d_model, dtype)
    pos = cache["pos"]
    spec = _attn_spec(cfg, 1)
    layers = []
    for p, kind, lc in zip(params.blocks, _pattern(cfg), cache["layers"]):
        h = C.rms_norm(x, p.ln_mix, cfg.norm_eps)
        if kind == "attn":
            mix, _, _ = C.attention_decode_step(p.attn, h, lc["k"], lc["v"], pos, spec,
                                                cfg.rope_theta)
            layers.append(lc)
        else:
            mix, tail, h_t = _rec_block(p.rec, h, lc["conv"].to(h.dtype), lc["h"])
            layers.append({"conv": tail.to(lc["conv"].dtype), "h": h_t})
        x = _mlp_residual(p, x + mix, cfg.norm_eps)
    return C.lm_logits(params, x, cfg.norm_eps), {"pos": pos + 1, "layers": layers}
