"""int8 error-feedback gradient compression for the data-parallel
all-reduce (``repro/train/compression.py``).

Each worker quantizes its local gradient to int8 with a per-tensor float32
absmax scale, the int8 payload is summed across workers (4x fewer bytes
than float32), dequantized, and the quantization residual is kept in an
**error-feedback buffer** added back before the next step's compression:
the contraction property that keeps SGD/Adam convergent under biased
compression (Karimireddy et al., 2019).

The reference runs inside ``shard_map`` over a named axis (``pmax`` and
``psum``). Here the workers are explicit: :func:`compressed_psum` takes
one gradient tree and one error buffer per worker, each on its worker's
device (repeats allowed: four workers on one card), and
follows the reference step for step: the shared scale is the max of the
workers' scales, the int8 codes are summed in int32 on the first worker's
device in worker order (exact in any order), and the mean is ``summed *
scale / n``. Every division is a correctly rounded one (``div_rn``, or a
tensor divisor on the tensor's device: CUDA multiplies by the reciprocal
of a host scalar divisor), so the card's codes, means and buffers equal
the CPU's bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.summaries import div_rn
from repro_torch.models import common as C


def _amax_scale(x32: torch.Tensor) -> torch.Tensor:
    """max |x| / 127, a float32 0-dim tensor on x's device."""
    return div_rn(torch.linalg.vector_norm(x32, float("inf")), 127.0)


def _codes(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.div(x32, torch.clamp_min(scale, 1e-20)).round_().to(torch.int8)


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8. Returns (q int8, scale float32 0-dim)."""
    x32 = x.to(torch.float32)
    scale = _amax_scale(x32)
    return _codes(x32, scale), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _one(gs: list, es: list):
    """One tensor's mean over the workers and each worker's new residual."""
    g32 = [g.to(torch.float32) + e for g, e in zip(gs, es)]     # error feedback
    home = g32[0].device
    # shared scale: max over workers keeps dequant consistent
    scale = torch.stack([_amax_scale(x).to(home) for x in g32]).amax()
    summed = torch.zeros(g32[0].shape, dtype=torch.int32, device=home)
    for x in g32:
        s = scale.to(x.device)
        q = _codes(x, s)
        x.sub_(q.to(torch.float32).mul_(s))        # the residual, in place
        summed.add_(q.to(home))                     # the int8 payload, summed in int32
    mean = div_rn(summed.to(torch.float32).mul_(scale), float(len(gs)))
    return [mean.to(x.device) for x in g32], g32


def compressed_psum(grads: list, error_bufs: list):
    """``(means, new_error_bufs)`` for one gradient tree and one error
    buffer (a tree of the same structure) per worker, each worker's tensors
    on its device. ``means[w]`` is the mean over workers on worker w's
    device (the same tensor for workers that share a device);
    ``new_error_bufs[w]`` is worker w's residual."""
    if len(grads) != len(error_bufs) or not grads:
        raise ValueError(f"{len(grads)} gradient trees for {len(error_bufs)} error buffers")
    flat_g = [C.tree_leaves(g) for g in grads]
    flat_e = [C.tree_leaves(e) for e in error_bufs]
    out = [_one([fg[i] for fg in flat_g], [fe[i] for fe in flat_e])
           for i in range(len(flat_g[0]))]
    means = [C.tree_unflatten(grads[w], [o[0][w] for o in out]) for w in range(len(grads))]
    errs = [C.tree_unflatten(grads[w], [o[1][w] for o in out]) for w in range(len(grads))]
    return means, errs


def make_compressed_psum():
    """:func:`compressed_psum`, under the reference's factory name (which
    there binds the axis name; the workers here are arguments)."""
    return compressed_psum


def init_error_buffer(params) -> dict:
    """Zero float32 buffers of a tree's shapes, on its tensors' devices."""
    return C.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params)
