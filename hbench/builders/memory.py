"""Backends that the program's ``make_backend`` builds in device memory
from the collection (``local``, ``scan``, ``scan-mxu``, ``sharded``).

A configuration names the backend (``backend``) and gives, under the
program's own field names, its ``BuildConfig`` (``build``), its
``SearchConfig`` (``search``), further ``IndexConfig`` fields (``index``)
and further keyword arguments of ``make_backend`` (``backend_args``). A
field left out takes the program's default. A backend built another way
(a saved store served by ``make_disk_backend``) is a builder of its own in
this folder, named by the configuration's ``builder``.
"""
from __future__ import annotations

import time

import torch


def build(cfg: dict, data: torch.Tensor, device: torch.device):
    """The backend over ``data``, and the seconds its build took (host
    clock, from the card-resident collection to the built backend, ending
    in a ``synchronize``)."""
    from repro_torch.core.engine import make_backend
    from repro_torch.core.index import IndexConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.tree import BuildConfig

    icfg = IndexConfig(build=BuildConfig(**cfg.get("build", {})),
                       search=SearchConfig(**cfg.get("search", {})), **cfg.get("index", {}))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    backend = make_backend(cfg["backend"], data, index_config=icfg, device=device,
                           **cfg.get("backend_args", {}))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return backend, time.perf_counter() - t0
