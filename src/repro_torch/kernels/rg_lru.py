"""Launch wrappers of the hand-written RG-LRU scan kernel and its gradient
(``csrc/rg_lru.cu``; the ``lax.scan`` of
``repro/models/recurrentgemma.py::_rg_lru``, which the reference runs
outside Pallas and differentiates with ``jax.grad``).

CUDA tensors only: the plain versions are ``kernels/ref.py::rg_lru_scan_ref``
and ``rg_lru_scan_bwd_ref``, and ``kernels/ops.py`` chooses between them by
tensor device. Each kernel agrees with its plain version bit for bit (a
rounded multiply, then a rounded add, a step). ``rg_lru_scan.launches`` and
``rg_lru_scan_bwd.launches`` count kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.compat import count_launch


def rg_lru_scan(a: torch.Tensor, g: torch.Tensor,
                h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a, g (B, T, R) and h0 (B, R), float32, on one CUDA device -> (y
    (B, T, R), hT (B, R)) float32, ``h_t = a_t * h_{t-1} + g_t``."""
    dev = a.device
    if dev.type != "cuda" or g.device != dev or h0.device != dev:
        raise ValueError("rg_lru_scan kernel needs every tensor on one CUDA device; got "
                         f"{[str(x.device) for x in (a, g, h0)]}")
    if any(x.dtype != torch.float32 for x in (a, g, h0)):
        raise TypeError("rg_lru_scan takes float32 a, g and h0; got "
                        f"{[x.dtype for x in (a, g, h0)]}")
    if a.ndim != 3 or g.shape != a.shape or tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"rg_lru_scan shapes a {tuple(a.shape)}, g {tuple(g.shape)}, h0 "
                         f"{tuple(h0.shape)}; expected a, g (B, T, R) and h0 (B, R)")
    b, t, r = a.shape
    if b * r >= 2**31:
        raise ValueError("rg_lru_scan kernel takes fewer than 2**31 (batch x channel) rows")
    a, g, h0 = a.contiguous(), g.contiguous(), h0.contiguous()
    y = torch.empty_like(a)
    h_out = h0.clone() if t == 0 else torch.empty_like(h0)
    if t and b * r:
        err = _build.library("rg_lru").rg_lru_scan_f32(
            a.data_ptr(), g.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
            b, t, r, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "rg_lru_scan")
        count_launch(rg_lru_scan)
    return y, h_out


rg_lru_scan.launches = 0


def rg_lru_scan_bwd(a: torch.Tensor, y: torch.Tensor, h0: torch.Tensor, dy: torch.Tensor,
                    dhT: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan's gradient: a, y (the forward's output), dy (B, T, R) and
    h0, dhT (B, R), float32, on one CUDA device -> (da, dg (B, T, R), dh0
    (B, R)) float32."""
    xs = (a, y, h0, dy, dhT)
    dev = a.device
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError("rg_lru_scan_bwd kernel needs every tensor on one CUDA device; "
                         f"got {[str(x.device) for x in xs]}")
    if any(x.dtype != torch.float32 for x in xs):
        raise TypeError(f"rg_lru_scan_bwd takes float32 tensors; got {[x.dtype for x in xs]}")
    if a.ndim != 3 or y.shape != a.shape or dy.shape != a.shape or \
            any(tuple(x.shape) != (a.shape[0], a.shape[2]) for x in (h0, dhT)):
        raise ValueError(f"rg_lru_scan_bwd shapes a {tuple(a.shape)}, y {tuple(y.shape)}, h0 "
                         f"{tuple(h0.shape)}, dy {tuple(dy.shape)}, dhT {tuple(dhT.shape)}; "
                         "expected a, y, dy (B, T, R) and h0, dhT (B, R)")
    b, t, r = a.shape
    if b * r >= 2**31:
        raise ValueError("rg_lru_scan_bwd kernel takes fewer than 2**31 (batch x channel) rows")
    a, y, h0, dy, dhT = (x.contiguous() for x in xs)
    da, dg = torch.empty_like(a), torch.empty_like(a)
    dh0 = dhT.clone() if t == 0 else torch.empty_like(dhT)
    if t and b * r:
        err = _build.library("rg_lru").rg_lru_scan_bwd_f32(
            a.data_ptr(), y.data_ptr(), h0.data_ptr(), dy.data_ptr(), dhT.data_ptr(),
            da.data_ptr(), dg.data_ptr(), dh0.data_ptr(), b, t, r,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "rg_lru_scan_bwd")
        count_launch(rg_lru_scan_bwd)
    return da, dg, dh0


rg_lru_scan_bwd.launches = 0
