"""Device resolution for the port's entry points.

Every public entry point takes ``device=None`` and resolves it here:
``None`` means the CUDA device, and a missing CUDA device is an error, never
a silent fall back to the CPU. Tests and CPU users pass ``device="cpu"``.
"""
from __future__ import annotations

import torch


def _full_precision_matmuls() -> None:
    """Keep float32 matmuls and convolutions in full float32: TF32 keeps
    about three decimal digits and would break the 1e-4 distance tolerance
    of the matmul-identity scan (``scan-mxu``) and the brute-force oracle.
    And keep bf16 matmuls' reductions in float32, as the reference's bf16
    dots accumulate: cuBLAS may otherwise add split-K partial sums in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: str | torch.device | None = None, *,
                   shapes: bool = False) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent.
    ``meta`` (shapes and dtypes, no storage) only where the caller builds
    shapes (``shapes=True``: the ``init_cache`` functions, whose ``meta``
    caches are ``launch/specs.py``'s ``cache_specs``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        _full_precision_matmuls()
    elif dev.type != "cpu" and not (shapes and dev.type == "meta"):
        raise ValueError(f"device={device!r}; expected 'cuda' or 'cpu'")
    return dev


def shard_devices(num_shards: int | None = None, devices=None,
                  device: str | torch.device | None = None) -> list[torch.device]:
    """The device of every shard of a sharded backend: the port's mesh.

    ``devices`` lists one device per shard, repeats allowed (four shards on
    one card: ``["cuda:0"] * 4``); with ``num_shards`` too it must have that
    many entries. Without it, ``num_shards`` shards (default: one a visible
    card) go round-robin over the visible CUDA devices, or all on the CPU
    when ``device`` is the CPU (default: one shard)."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if not devs or (num_shards is not None and int(num_shards) != len(devs)):
            raise ValueError(f"{num_shards} shards but {len(devs)} devices: the "
                             f"device list needs one entry per shard")
        return devs
    base = resolve_device(device)
    count = torch.cuda.device_count() if base.type == "cuda" else 1
    n = count if num_shards is None else int(num_shards)
    if n < 1:
        raise ValueError(f"num_shards={num_shards}; expected >= 1")
    if base.type == "cpu":
        return [base] * n
    return [torch.device("cuda", i % count) for i in range(n)]


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
