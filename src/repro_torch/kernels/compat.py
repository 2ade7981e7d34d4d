"""Kernel execution-mode policy (``SearchConfig.kernel_mode`` values).

* ``auto`` decides by the device of the tensors: a CPU tensor takes the
  plain PyTorch version (``kernels/ref.py``), a CUDA tensor launches the
  hand-written kernel -- or raises if the kernel cannot be built or launched.
* ``ref`` forces the plain version on any device (differential checks).
* ``cuda`` forces the kernel and raises on a CPU tensor.

No mode depends on whether a compiler happens to be installed: a CUDA
tensor never silently takes the plain version.

:func:`count_launch` is the one place a kernel wrapper adds to its
``launches`` counter.
"""
from __future__ import annotations

import threading

import torch

KERNEL_MODES = ("auto", "cuda", "ref")


def resolve_kernel_mode(mode: str, device: torch.device) -> str:
    """Resolve ``mode`` for tensors on ``device`` to ``"cuda"`` or ``"ref"``."""
    if mode not in KERNEL_MODES:
        raise ValueError(f"kernel_mode={mode!r}; expected one of {KERNEL_MODES}")
    if mode == "ref":
        return "ref"
    if mode == "cuda" and device.type != "cuda":
        raise ValueError(
            f"kernel_mode='cuda' needs CUDA tensors; got tensors on {device}")
    return "cuda" if device.type == "cuda" else "ref"


_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper, key=None) -> None:
    """Add one to ``wrapper.launches`` (and, with a ``key``, to
    ``wrapper.launches_by[key]``), under one lock shared by every kernel
    wrapper: shard threads launch the same kernels at once, and a bare
    ``+=`` (read, add, store) can lose a count between threads."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
        if key is not None:
            wrapper.launches_by[key] += 1
