"""Pipeline parallelism, the GPipe schedule over a "stage" axis
(``repro/distributed/pipeline.py``).

Layers are split into P stages, each stage's params on its own device of
the stage axis, and M microbatches stream through them: at clock step t
(of M + P - 1), stage s runs microbatch t - s, and the last stage emits
microbatch t - (P - 1). An activation moves from stage s to s + 1 as a
copy onto the next stage's device (``.to(device, copy=True)``, the twin of
``lax.ppermute``, which is a copy even when both stages share a card). The
bubble is the standard P - 1 idle slots of M + P - 1; efficiency M / (M +
P - 1).

The reference's SPMD body also computes on zeros during the bubble, every
stage at every step; nothing it emits depends on those results, so here
only the live (stage, microbatch) pairs run. Work is queued from one host
thread on each device's current stream: stages on different cards overlap
as their queues allow, and a cross-device copy is ordered by PyTorch
after the work that made its source, so no event or extra stream is
needed.

Differentiable end to end: autograd through the schedule (the copies'
backward is the copy back) gives the backward, as ``jax.grad`` through
``ppermute`` does; activations for all microbatches are kept. No float
atomics: each parameter's gradient is summed over the microbatches by
autograd's accumulation, as the plain run's would be.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models import common as C


def _stage_devices(mesh_or_devices, axis: str) -> list[torch.device]:
    """The device of each stage: the mesh's devices along ``axis`` (at
    index 0 of any other axis), or the given list."""
    if isinstance(mesh_or_devices, Mesh):
        grid = np.moveaxis(mesh_or_devices.devices, mesh_or_devices.axis_names.index(axis), 0)
        return [torch.device(d) for d in grid.reshape(grid.shape[0], -1)[:, 0]]
    return [torch.device(d) for d in mesh_or_devices]


def _stage(stage_params, s: int, p_stages: int):
    """Stage ``s``'s params: ``stage_params[s]`` of a sequence of P, or the
    index ``s`` of every leaf of a tree with leading dim P."""
    if isinstance(stage_params, (list, tuple)):
        if len(stage_params) != p_stages:
            raise ValueError(f"{len(stage_params)} stage params for {p_stages} stages")
        return stage_params[s]
    return C.tree_map(lambda a: a[s], stage_params)


def pipeline_forward(stage_fn: Callable, stage_params, microbatches,
                     mesh_or_devices, axis: str = "stage"):
    """Run M microbatches through P pipeline stages.

    ``stage_fn(params_one_stage, x) -> y``: one stage's compute (shapes of
    x and y must match across stages).
    ``stage_params``: a sequence of P per-stage params, or a tree of
    tensors with leading dim P (one slice per stage, :func:`split_stages`);
    each stage's are moved to its device (a no-op where they are already).
    ``microbatches``: (M, mb, ...) inputs for stage 0.
    ``mesh_or_devices``: a :class:`Mesh` with axis ``axis``, or the list of
    stage devices (repeats allowed).
    Returns (M, mb, ...) outputs of the last stage, on its device.
    """
    devices = _stage_devices(mesh_or_devices, axis)
    p_stages, m = len(devices), microbatches.shape[0]
    params = [C.tree_map(lambda a, d=devices[s]: a.to(d), _stage(stage_params, s, p_stages))
              for s in range(p_stages)]
    cur: list = [None] * p_stages            # the activation waiting at each stage
    outs: list = [None] * m
    for t in range(m + p_stages - 1):
        nxt: list = [None] * p_stages
        for s in range(max(0, t - m + 1), min(t, p_stages - 1) + 1):
            x = microbatches[t].to(devices[0]) if s == 0 else cur[s]
            y = stage_fn(params[s], x)
            if s == p_stages - 1:
                outs[t - (p_stages - 1)] = y
            else:
                nxt[s + 1] = y.to(devices[s + 1], copy=True)
        cur = nxt
    return torch.stack(outs)


def split_stages(params_stacked, num_stages: int):
    """(L, ...)-stacked layer params -> (P, L/P, ...) per-stage groups; a
    list of L layers -> a list of P lists of L/P layers."""
    if isinstance(params_stacked, (list, tuple)):
        n = len(params_stacked)
        if n % num_stages:
            raise ValueError(f"{n} layers not divisible into {num_stages} stages")
        per = n // num_stages
        return [list(params_stacked[i * per:(i + 1) * per]) for i in range(num_stages)]

    def regroup(a):
        n = a.shape[0]
        if n % num_stages:
            raise ValueError(f"{n} layers not divisible into {num_stages} stages")
        return a.reshape(num_stages, n // num_stages, *a.shape[1:])

    return C.tree_map(regroup, params_stacked)
