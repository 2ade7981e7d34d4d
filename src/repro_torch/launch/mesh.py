"""Device meshes (``repro/launch/mesh.py``).

PyTorch has no GSPMD, so a mesh here is a named grid of ``torch.device``s:
a numpy object array of devices with one axis name a dimension. An entry
may repeat: a 2 x 2 mesh on one card is four entries of ``cuda:0`` (the
port's shard lists allow repeats the same way, ``device.shard_devices``).

Axis roles, as in the reference:
  * ``pod``   - inter-pod data parallelism (2 pods = 512 chips)
  * ``data``  - intra-pod DP + FSDP (ZeRO-3 param sharding)
  * ``model`` - TP (heads/FFN), EP (experts), SP (long-context KV/sequence)

``make_production_mesh`` builds the 16 x 16 (or 2 x 16 x 16) mesh of
``meta`` devices: it is shape-level only, as the reference's forced host
devices are, and feeds the sharding rules and the specs.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch.device import resolve_device


class Mesh:
    """A named grid of devices: ``devices`` an object array of
    ``torch.device`` (repeats allowed), ``axis_names`` one name a dim."""

    def __init__(self, devices, axis_names):
        arr = np.empty(np.shape(devices), dtype=object)
        arr[...] = devices
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"a mesh of shape {arr.shape} needs {arr.ndim} distinct "
                             f"axis names, got {axis_names}")
        self.devices = arr
        self.axis_names = axis_names

    @property
    def shape(self) -> OrderedDict:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        kinds = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({axes}; {', '.join(kinds)})"


def _grid(devices, shape, axes) -> Mesh:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh at shape level: (data 16, model 16), or (pod 2,
    data 16, model 16), of ``meta`` devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid([torch.device("meta")] * int(np.prod(shape)), shape, axes)


def make_host_mesh(model_axis: int = 1, devices=None) -> Mesh:
    """A (data, model) mesh with the requested model-axis width over the
    visible CUDA cards, or over ``devices`` (one entry a mesh position,
    repeats allowed: ``["cuda:0"] * 4``, or ``["cpu"] * 4`` for tests).
    Raises without a card unless ``devices`` names the CPU."""
    if devices is None:
        resolve_device("cuda")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    n = len(devs)
    if not n or n % model_axis:
        raise ValueError(f"{n} devices not divisible by model={model_axis}")
    return _grid(devs, (n // model_axis, model_axis), ("data", "model"))


def data_axes(mesh) -> tuple[str, ...]:
    """The batch/FSDP axes present in this mesh ('pod' included when there)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def all_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)
