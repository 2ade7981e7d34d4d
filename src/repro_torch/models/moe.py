"""Mixture-of-Experts FFN, GShard/Switch style with sort-based dispatch
(``repro/models/moe.py``).

Used by granite-moe-1b-a400m (32 experts, top-8) and moonshot-v1-16b-a3b
(64 experts, top-6). Routing runs in float32; each batch row is one token
group with its own capacity ``C`` per expert (sequence-level capacity, so a
right-padded prompt spends capacity on its pad tokens, as in the
reference). The (token, expert) assignments of a group are sorted by
expert (a stable sort), cut to ``C`` per expert (the rest go to a drop
slot), the experts run as stacked SwiGLU products over a (B, E, C, d)
buffer, and each token's ``k`` weighted outputs are added back.

Where the reference's operations give no order, the port fixes one:

* the top ``k`` come from a stable descending sort, so equal
  probabilities give the lower expert first, as ``jax.lax.top_k`` does
  (``torch.topk`` promises no order);
* dispatch slots are unique apart from the drop slot, so dispatch is an
  indexed write (the reference's scatter-add into zeros);
* the combine gathers each token's ``k`` contributions and adds them in
  expert-ascending order in the compute dtype, the order of the
  reference's scatter-add over the sorted assignments; no atomics, so the
  sum is the same from run to run on the card.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from repro_torch.models import common as C
from repro_torch.models.arch import ArchConfig
from repro_torch.models.common import ParamTree


def init_moe(generator: torch.Generator, cfg: ArchConfig) -> dict:
    """The router (d, E) and the stacked expert matrices (E, d, ff) and
    (E, ff, d), float32, with the reference's scales."""
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff

    def stack(shape, scale):
        return C.normal(generator, (e, *shape), scale)

    return {
        "router": C.dense_init(generator, d, e, scale=0.02),
        "w_gate": stack((d, ff), 1.0 / math.sqrt(d)),
        "w_up": stack((d, ff), 1.0 / math.sqrt(d)),
        "w_down": stack((ff, d), 1.0 / math.sqrt(ff)),
    }


def moe_capacity(cfg: ArchConfig, num_tokens: int) -> int:
    """Slots per expert for a group of ``num_tokens`` tokens: at least 8,
    rounded up to a multiple of 8."""
    c = int(num_tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts) + 1
    return max(8, -(-c // 8) * 8)


def _route(probs: torch.Tensor, cfg: ArchConfig, cap: int):
    """Sort-based dispatch of every group at once (the reference's
    ``_dispatch_one_group`` under ``vmap``). probs (B, T, E) float32.

    Returns (top_e (B, T, k), stok, slot, sw, keep), the last four
    (B, T*k) in expert-sorted order: the token of each
    assignment, its slot in the (E*C + 1)-row buffer (E*C, the drop slot,
    when its expert is full), its weight, and whether it was kept."""
    b, t, _ = probs.shape
    k = cfg.experts_per_token
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = vals[..., :k], idx[..., :k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    flat_e = top_e.reshape(b, t * k)
    flat_t = torch.arange(t, device=probs.device).repeat_interleave(k).expand(b, -1)
    flat_w = top_w.reshape(b, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = torch.gather(flat_t, 1, order)
    sw = torch.gather(flat_w, 1, order)
    first = torch.searchsorted(se, se, side="left")
    pos_in_e = torch.arange(t * k, device=probs.device) - first
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e, cfg.num_experts * cap)
    return top_e, stok, slot, sw, keep


def _dispatch(x: torch.Tensor, stok: torch.Tensor, slot: torch.Tensor,
              keep: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """The (B, E, C, d) expert buffer: each kept assignment's token row at
    its slot, unique but for the drop slot, which every dropped assignment
    writes zeros to and which is cut off."""
    b, _, d = x.shape
    rows = torch.arange(b, device=x.device)[:, None]
    vals = torch.gather(x, 1, stok[..., None].expand(-1, -1, d)) * keep[..., None].to(x.dtype)
    disp = x.new_zeros((b, e * cap + 1, d)).index_put((rows, slot), vals)
    return disp[:, :-1].reshape(b, e, cap, d)


def moe_forward(params: ParamTree, x: torch.Tensor,
                cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) in the compute dtype -> (out (B, S, d), aux: the Switch
    load-balancing loss over the batch, float32 ())."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = moe_capacity(cfg, s)
    dt = x.dtype

    # routing (float32)
    probs = torch.softmax(x.to(torch.float32) @ params.mat("router", torch.float32), dim=-1)
    me = probs.mean(dim=(0, 1))
    top1 = torch.argmax(probs, dim=-1)
    ce = F.one_hot(top1, e).to(torch.float32).mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)

    _, stok, slot, sw, keep = _route(probs, cfg, cap)

    disp = C.maybe_shard(_dispatch(x, stok, slot, keep, e, cap), "moe_dispatch")

    # the stacked expert FFN (SwiGLU)
    g = torch.einsum("becd,edf->becf", disp, params.mat("w_gate", dt))
    u = torch.einsum("becd,edf->becf", disp, params.mat("w_up", dt))
    h = C.maybe_shard(F.silu(g) * u, "moe_hidden")
    out_buf = torch.einsum("becf,efd->becd", h, params.mat("w_down", dt)).reshape(b, e * cap, d)

    # combine: a stable sort by token keeps each token's k assignments in
    # their expert-sorted (ascending) order
    by_tok = torch.argsort(stok, dim=-1, stable=True)
    j_slot = torch.gather(slot, 1, by_tok).clamp_max(e * cap - 1)
    j_w = torch.gather(sw * keep, 1, by_tok).to(dt)
    contrib = torch.gather(out_buf, 1, j_slot[..., None].expand(-1, -1, d)) * j_w[..., None]
    contrib = contrib.reshape(b, s, k, d)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    return y, aux
