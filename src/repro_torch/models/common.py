"""Shared model building blocks (``repro/models/common.py``).

* :class:`ParamTree`: parameters as a module tree with the reference's
  names, ``blocks`` a list of layers where the reference stacks them on a
  leading axis, and the tree helpers that carry it to and from the
  reference's stacked layout (checkpoints, the optimizer's moments).
* initialisers on an explicit ``torch.Generator``;
* RMSNorm, LayerNorm, SwiGLU and GELU MLPs, rotary embeddings;
* attention with GQA/MQA: full (materialised float32 scores), chunked (a
  streaming softmax over KV blocks), and one decode position against a
  cache (global, or a sliding window kept as a ring buffer).

Scores are float32 products of compute-dtype operands, as the reference's
``preferred_element_type=jnp.float32`` einsums give: the operands are
widened first, which is exact, and the sum runs in float32 (a bf16 einsum
would round the scores to bf16). The reference's ``maybe_shard`` and
``set_shard_hook`` annotate arrays for GSPMD across a device mesh; one card
has no mesh, so they have no twin here.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A nested dict of tensors as a module tree: a tensor becomes a
    parameter (frozen: training turns ``requires_grad`` on), a dict a
    child ``ParamTree``, a list an ``nn.ModuleList``.

    :meth:`mat` hands out a matrix rounded to the compute dtype. For a
    frozen parameter the copy is made at first use and kept until the
    parameter changes in place (its version counter moves) or the tree is
    moved (``.to``); a parameter being trained gets a fresh, differentiable
    cast at every call, as the reference casts at every call."""

    def __init__(self, tree: dict):
        super().__init__()
        self._casts: dict = {}
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))
            elif isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.add_module(name, nn.ModuleList(ParamTree(v) for v in value))

    def mat(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        """Parameter ``name`` rounded to ``dtype``: the parameter itself
        when it has that dtype."""
        p = getattr(self, name)
        if p.dtype == dtype:
            return p
        if p.requires_grad and torch.is_grad_enabled():
            return p.to(dtype)
        key = (name, dtype)
        version, cast = self._casts.get(key, (None, None))
        if version != p._version:
            cast = p.detach().to(dtype)
            self._casts[key] = (p._version, cast)
        return cast

    def tree(self) -> dict:
        """The parameters as a nested dict (``blocks`` a list of layer
        dicts), the parameter objects themselves."""
        out: dict = {name: p for name, p in self.named_parameters(recurse=False)}
        for name, child in self.named_children():
            out[name] = (child.tree() if isinstance(child, ParamTree)
                         else [c.tree() for c in child])
        return out

    def _apply(self, fn, *args, **kwargs):
        self._casts.clear()
        return super()._apply(fn, *args, **kwargs)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list tree, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(tree, leaves) -> dict:
    """``leaves`` (in :func:`tree_leaves` order) in the shape of ``tree``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def leaf_groups(tree: dict) -> list[tuple[tuple[str, ...], list]]:
    """The reference's leaves of a port tree: ``(path, tensors)`` with one
    tensor for a leaf outside ``blocks``, and one a layer, in layer order,
    for a leaf of ``blocks`` (the reference stacks them on a leading axis
    under the same path)."""
    out = []

    def walk(node, path):
        for key, val in node.items():
            if key == "blocks" and not path:
                for sub, _ in leaf_groups(val[0]):
                    out.append((("blocks", *sub), [get_path(layer, sub) for layer in val]))
            elif isinstance(val, dict):
                walk(val, (*path, key))
            else:
                out.append(((*path, key), [val]))

    walk(tree, ())
    return out


def get_path(tree, path):
    """The node at ``path`` (a tuple of keys) of a nested dict."""
    for key in path:
        tree = tree[key]
    return tree


def nest(items) -> dict:
    """A nested dict from ``(path, value)`` pairs."""
    root: dict = {}
    for path, val in items:
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return root


def stack_tree(tree: dict) -> dict:
    """A port tree (``blocks`` a list of layers) in the reference's layout,
    ``blocks`` stacked on a leading layer axis (detached copies)."""
    return nest((path, ts[0].detach() if path[0] != "blocks"
                 else torch.stack([t.detach() for t in ts]))
                for path, ts in leaf_groups(tree))


# Leaves the forward pass reads in float32 whatever the compute dtype (besides
# the norm gains, ``ln*``): the MoE router and the RG-LRU's gates and decay.
FLOAT32_LEAVES = ("router", "lambda", "w_input_gate", "b_input_gate", "w_rec_gate",
                  "b_rec_gate")


def hold(node: dict, dtype: torch.dtype) -> dict:
    """A serving tree: in the nested dict ``node``, every tensor that the
    forward pass reads through :meth:`ParamTree.mat` in the compute dtype
    is replaced, in place and one tensor at a time, by its value rounded to
    ``dtype`` (the same bits as rounding at each use, in half the bytes of
    float32); the norm gains and :data:`FLOAT32_LEAVES` stay float32.
    Serving only: such a tree is not trained. Returns ``node``."""
    for key, val in node.items():
        if isinstance(val, dict):
            hold(val, dtype)
        elif isinstance(val, list):
            for v in val:
                hold(v, dtype)
        elif not (key.startswith("ln") or key in FLOAT32_LEAVES):
            node[key] = val.to(dtype)
    return node


def params_from_numpy(tree: dict, num_layers: int,
                      device: str | torch.device | None = None,
                      held: torch.dtype | None = None) -> ParamTree:
    """A parameter tree in the reference's layout, of numpy arrays or
    tensors, carried into a float32 :class:`ParamTree` on ``device``
    (default: the CUDA device). ``blocks`` is stacked on a leading layer
    axis (as ``jax.vmap`` leaves it), or a list of layers (a model of mixed
    layers, recurrentgemma's). With ``held``, a serving tree in that dtype
    (:func:`hold`), each layer held as it is carried, so the float32
    layers never exist on ``device`` together."""
    dev = resolve_device(device)

    def convert(node, layer=None):
        if isinstance(node, dict):
            return {key: convert(val, layer) for key, val in node.items()}
        if isinstance(node, torch.Tensor):
            t = node.detach() if layer is None else node.detach()[layer]
            return t.to(dev, torch.float32, copy=True)
        arr = np.asarray(node, dtype=np.float32)
        return torch.tensor(arr if layer is None else arr[layer], device=dev)

    def done(node):
        return node if held is None else hold(node, held)

    out = {key: convert(val) for key, val in tree.items() if key != "blocks"}
    blocks = tree["blocks"]
    out["blocks"] = [done(convert(b)) for b in blocks] if isinstance(blocks, (list, tuple)) \
        else [done(convert(blocks, i)) for i in range(num_layers)]
    return ParamTree(done(out))


# ---------------------------------------------------------------------------
# mixed precision
# ---------------------------------------------------------------------------

class _GradCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct.to(ctx.dtype), None


def grad_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Identity forward; casts the cotangent to ``dtype`` on the way back
    (the reference's ``jax.custom_vjp`` barrier that keeps the backward
    residual stream in the compute dtype)."""
    return _GradCast.apply(x, dtype)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in float32 with a zero-centred gain (``1 + weight``), cast
    back to x's dtype."""
    x32 = x.to(torch.float32)
    scale = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return ((x32 * scale) * (1.0 + weight.to(torch.float32))).to(x.dtype)


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


def embed_tokens(params: ParamTree, tokens: torch.Tensor, d_model: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Token embeddings in ``dtype`` scaled by sqrt(d_model) (that factor
    rounded to ``dtype`` first, as the reference rounds it)."""
    scale = float(torch.tensor(float(d_model), dtype=torch.float32).sqrt().to(dtype))
    return params.mat("embed", dtype)[tokens.long()] * scale


def lm_logits(params: ParamTree, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Final norm and LM head: compute-dtype operands, float32 accumulation
    and output (a bf16 product would round the logits to bf16)."""
    x = rms_norm(x, params.ln_final, eps)
    return x.to(torch.float32) @ params.mat("lm_head", x.dtype).to(torch.float32)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = F.silu(x @ w_gate.to(dt)) * (x @ w_up.to(dt))
    return h @ w_down.to(dt)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """Two-matrix MLP with the tanh-approximated GELU (``jax.nn.gelu``'s
    default)."""
    dt = x.dtype
    h = F.gelu(x @ w_up.to(dt) + b_up.to(dt), approximate="tanh")
    return h @ w_down.to(dt) + b_down.to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S). Rotates the two halves
    of the head dim in float32, cast back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    ang = ang[None, :, None, :] if positions.ndim == 1 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    causal: bool = True
    window: int = 0               # 0 = global; >0 = local (sliding) window
    impl: str = "full"            # 'full' | 'chunked'
    chunk: int = 1024


def init_attention(generator: torch.Generator, d_model: int, spec: AttnSpec) -> dict:
    hd = spec.head_dim
    return {
        "wq": dense_init(generator, d_model, spec.num_heads * hd),
        "wk": dense_init(generator, d_model, spec.num_kv_heads * hd),
        "wv": dense_init(generator, d_model, spec.num_kv_heads * hd),
        "wo": dense_init(generator, spec.num_heads * hd, d_model),
    }


def _expand_kv(k: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """(B, S, G, hd) -> (B, S, G*q_per_kv, hd) by repeat (GQA)."""
    if q_per_kv == 1:
        return k
    return k.repeat_interleave(q_per_kv, dim=2)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """additive bias (Sq, Sk) in float32: 0 allowed / -inf masked."""
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    return torch.zeros(ok.shape, dtype=torch.float32, device=ok.device).masked_fill_(
        ~ok, -math.inf)


def _scale(spec: AttnSpec) -> float:
    """1/sqrt(head_dim) as the reference rounds it (float32 sqrt, float32
    reciprocal)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(spec.head_dim)))


def _scores(q: torch.Tensor, k: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """(B, H, Sq, Sk) float32 scores of compute-dtype q (B, Sq, H, hd) and
    k (B, Sk, H, hd)."""
    return torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                        k.to(torch.float32)) * _scale(spec)


def attention_full(q, k, v, q_pos, k_pos, spec: AttnSpec) -> torch.Tensor:
    """Materialized-scores attention. q (B,Sq,H,hd); k,v (B,Sk,G,hd)."""
    k = _expand_kv(k, spec.num_heads // spec.num_kv_heads)
    v = _expand_kv(v, spec.num_heads // spec.num_kv_heads)
    logits = _scores(q, k, spec) + _mask_bias(q_pos, k_pos, spec.causal,
                                              spec.window)[None, None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_chunked(q, k, v, q_pos, k_pos, spec: AttnSpec) -> torch.Tensor:
    """Flash-style streaming softmax over KV chunks (no Sq x Sk buffer),
    the reference's ``lax.scan`` as a loop over the chunks."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    c = min(spec.chunk, sk)
    if sk % c:
        raise ValueError(f"kv length {sk} not divisible by chunk {c}")
    k = _expand_kv(k, spec.num_heads // spec.num_kv_heads)
    v = _expand_kv(v, spec.num_heads // spec.num_kv_heads)
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for j in range(0, sk, c):
        logits = _scores(q, k[:, j:j + c], spec) + _mask_bias(
            q_pos, k_pos[j:j + c], spec.causal, spec.window)[None, None]
        m_new = torch.maximum(m, logits.amax(-1))
        # guard fully-masked rows (all -inf): keep m finite
        m_new = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), v[:, j:j + c]).to(torch.float32)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)            # (B,Sq,H,hd)


def _ring_decode(q, k_cache, v_cache, ok, spec: AttnSpec) -> torch.Tensor:
    """One query position against the cache slots where ``ok`` (B, Smax):
    the ring buffer's decode, and the global cache's."""
    k = _expand_kv(k_cache, spec.num_heads // spec.num_kv_heads)
    v = _expand_kv(v_cache, spec.num_heads // spec.num_kv_heads)
    logits = _scores(q, k, spec).masked_fill(~ok[:, None, None, :], -math.inf)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_decode(q, k_cache, v_cache, pos, spec: AttnSpec) -> torch.Tensor:
    """Single-position decode. q (B,1,H,hd); caches (B,Smax,G,hd); pos (B,).
    Masks cache slots >= pos+1 (and outside the local window when set)."""
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    ok = kpos[None, :] <= pos[:, None]
    if spec.window > 0:
        ok &= (pos[:, None] - kpos[None, :]) < spec.window
    return _ring_decode(q, k_cache, v_cache, ok, spec)


def _project(params: ParamTree, name: str, x: torch.Tensor, heads: int,
             hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return (x @ params.mat(name, x.dtype)).reshape(b, s, heads, hd)


def attention_forward(params: ParamTree, x: torch.Tensor, positions: torch.Tensor,
                      spec: AttnSpec, rope_theta: float = 10000.0,
                      kv_override: tuple | None = None) -> torch.Tensor:
    """Self-attention over a full sequence (train/prefill).

    ``kv_override`` supplies external (k, v, k_pos) for cross-attention.
    """
    b, s, _ = x.shape
    hd = spec.head_dim
    q = _project(params, "wq", x, spec.num_heads, hd)
    if kv_override is None:
        k = _project(params, "wk", x, spec.num_kv_heads, hd)
        v = _project(params, "wv", x, spec.num_kv_heads, hd)
        if rope_theta > 0:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
        k_pos = positions
    else:
        k, v, k_pos = kv_override
    impl = spec.impl
    if impl != "full" and k.shape[1] % min(spec.chunk, k.shape[1]):
        impl = "full"                 # ragged KV (e.g. 1500-frame memory)
    attend = attention_full if impl == "full" else attention_chunked
    out = attend(q, k, v, positions, k_pos, spec).reshape(b, s, spec.num_heads * hd)
    return out @ params.mat("wo", x.dtype)


def project_kv(params: ParamTree, x: torch.Tensor, positions: torch.Tensor,
               spec: AttnSpec, rope_theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K/V projections only (used to fill caches / cross-attention memory)."""
    k = _project(params, "wk", x, spec.num_kv_heads, spec.head_dim)
    v = _project(params, "wv", x, spec.num_kv_heads, spec.head_dim)
    if rope_theta > 0:
        k = apply_rope(k, positions, rope_theta)
    return k, v


def attention_decode_step(params: ParamTree, x: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, pos: torch.Tensor, spec: AttnSpec,
                          rope_theta: float = 10000.0, update_cache: bool = True):
    """One decode step. x (B,1,d); caches (B,Smax,G,hd); pos (B,) current index.

    Decode is lockstep (the serving engine prefills per wave, so positions
    are batch-uniform): the new K/V go to the single slot ``pos[0]`` of
    every row (``pos[0] % Smax`` for a window's ring buffer; clamped to the
    last slot, as ``dynamic_update_slice`` clamps), written into the
    caches in place. Returns (out (B,1,d), cache_k, cache_v).
    """
    b = x.shape[0]
    hd = spec.head_dim
    q = _project(params, "wq", x, spec.num_heads, hd)
    if rope_theta > 0:
        q = apply_rope(q, pos[:, None], rope_theta)
    smax = cache_k.shape[1]
    if update_cache:
        k_new = _project(params, "wk", x, spec.num_kv_heads, hd)
        v_new = _project(params, "wv", x, spec.num_kv_heads, hd)
        if rope_theta > 0:
            k_new = apply_rope(k_new, pos[:, None], rope_theta)
        slot = pos[:1].long()
        slot = slot % smax if spec.window > 0 else slot.clamp(0, smax - 1)
        cache_k.index_copy_(1, slot, k_new.to(cache_k.dtype))
        cache_v.index_copy_(1, slot, v_new.to(cache_v.dtype))
    if spec.window > 0:
        # ring buffer: slot s holds absolute position p - ((p % smax - s) mod smax)
        slots = torch.arange(smax, device=x.device)
        abs_pos = pos[:, None] - ((pos[:, None] % smax - slots[None, :]) % smax)
        ok = (abs_pos >= 0) & (abs_pos <= pos[:, None])
        out = _ring_decode(q, cache_k, cache_v, ok, spec)
    else:
        out = attention_decode(q, cache_k, cache_v, pos, spec)
    out = out.reshape(b, 1, spec.num_heads * hd)
    return out @ params.mat("wo", x.dtype), cache_k, cache_v


def resolve_attn_impl(cfg, seq_len: int) -> str:
    if cfg.attention_impl != "auto":
        return cfg.attention_impl
    return "chunked" if seq_len > 2048 else "full"
