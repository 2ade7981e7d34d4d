"""Launch wrappers of the hand-written RG-LRU scan kernel and its gradient
(``csrc/rg_lru.cu``; the ``lax.scan`` of
``repro/models/recurrentgemma.py::_rg_lru``, which the reference runs
outside Pallas and differentiates with ``jax.grad``).

CUDA tensors only: the plain versions are ``kernels/ref.py::rg_lru_scan_ref``
and ``rg_lru_scan_bwd_ref``, and ``kernels/ops.py`` chooses between them by
tensor device. Each kernel agrees with its plain version bit for bit (a
rounded multiply, then a rounded add, a step).

Which kernel a call launches is :func:`_plan`'s choice from the call's
shape and its operands' alignment, made before the launch: v2 (a ring of
``cp.async`` stages in shared memory, one warp a block of 32 channels)
where its preconditions hold and T is long enough for the ring to pay, v1
(one thread a channel, loads 8 steps ahead) otherwise: decode (T = 1), R
not a multiple of 4, operands not 16-byte aligned. ``rg_lru_scan.launches``
and ``rg_lru_scan_bwd.launches`` count kernel launches of either variant;
``launches_by`` counts them by ``(variant, (B, T, R))``, where they are
launched.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.compat import count_launch

# Where v2 starts to pay (tools/kernel_ab.py --kernel rg_lru on an H100 80GB
# HBM3 at 700 W, B=4, R=2560, device ms v1 / v2): with operands streamed
# from HBM v2 wins from T = 32 (forward 0.0043 / 0.0038; T = 64 0.0069 /
# 0.0054), with operands in L2 v1's forward stays ahead up to T = 256
# (T = 64: 0.0035 / 0.0038, gradient 0.0051 / 0.0052), and at T = 1 they
# tie (0.0017 / 0.0019).
V2_MIN_STEPS = 64


def _plan(t: int, r: int, aligned: bool) -> str:
    """"v2" for T >= ``V2_MIN_STEPS`` steps of R channels, R a multiple of
    4 and every (B, T, R) operand 16-byte ``aligned`` (v2's 16-byte copies
    of 4 channels); else "v1"."""
    return "v2" if aligned and r % 4 == 0 and t >= V2_MIN_STEPS else "v1"


def _aligned(*xs: torch.Tensor) -> bool:
    """Whether every tensor's first element sits on a 16-byte boundary (a
    contiguous view can have a storage offset)."""
    return all(x.data_ptr() % 16 == 0 for x in xs)


def _launch_scan(kind: str, a: torch.Tensor, g: torch.Tensor,
                 h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``kind`` ("v1" or "v2") of the scan on checked, contiguous
    operands, into fresh outputs (new allocations: 16-byte aligned). v2's
    entry point checks R and every pointer and refuses (-1) what it cannot
    take; that raises."""
    b, t, r = a.shape
    y = torch.empty_like(a)
    h_out = h0.clone() if t == 0 else torch.empty_like(h0)
    if t and b * r:
        lib = _build.library("rg_lru")
        fn = lib.rg_lru_scan_v2_f32 if kind == "v2" else lib.rg_lru_scan_f32
        err = fn(a.data_ptr(), g.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
                 b, t, r, torch.cuda.current_stream(a.device).cuda_stream)
        if err == -1:
            raise ValueError(f"rg_lru_scan kernel v2 refused R={r} or a misaligned operand")
        _build.check(err, "rg_lru_scan")
        count_launch(rg_lru_scan, (kind, (b, t, r)))
    return y, h_out


def _launch_scan_bwd(kind: str, a: torch.Tensor, y: torch.Tensor, h0: torch.Tensor,
                     dy: torch.Tensor, dhT: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel ``kind`` ("v1" or "v2") of the gradient, as
    :func:`_launch_scan` launches the scan."""
    b, t, r = a.shape
    da, dg = torch.empty_like(a), torch.empty_like(a)
    dh0 = dhT.clone() if t == 0 else torch.empty_like(dhT)
    if t and b * r:
        lib = _build.library("rg_lru")
        fn = lib.rg_lru_scan_bwd_v2_f32 if kind == "v2" else lib.rg_lru_scan_bwd_f32
        err = fn(a.data_ptr(), y.data_ptr(), h0.data_ptr(), dy.data_ptr(), dhT.data_ptr(),
                 da.data_ptr(), dg.data_ptr(), dh0.data_ptr(), b, t, r,
                 torch.cuda.current_stream(a.device).cuda_stream)
        if err == -1:
            raise ValueError(f"rg_lru_scan_bwd kernel v2 refused R={r} or a misaligned operand")
        _build.check(err, "rg_lru_scan_bwd")
        count_launch(rg_lru_scan_bwd, (kind, (b, t, r)))
    return da, dg, dh0


def rg_lru_scan(a: torch.Tensor, g: torch.Tensor,
                h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a, g (B, T, R) and h0 (B, R), float32, on one CUDA device -> (y
    (B, T, R), hT (B, R)) float32, ``h_t = a_t * h_{t-1} + g_t``, by the
    kernel :func:`_plan` picks."""
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
    return _launch_scan(_plan(t, r, _aligned(a, g)), a, g, h0)


rg_lru_scan.launches = 0
rg_lru_scan.launches_by = collections.Counter()


def rg_lru_scan_bwd(a: torch.Tensor, y: torch.Tensor, h0: torch.Tensor, dy: torch.Tensor,
                    dhT: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan's gradient: a, y (the forward's output), dy (B, T, R) and
    h0, dhT (B, R), float32, on one CUDA device -> (da, dg (B, T, R), dh0
    (B, R)) float32, by the kernel :func:`_plan` picks."""
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
    return _launch_scan_bwd(_plan(t, r, _aligned(a, y, dy)), a, y, h0, dy, dhT)


rg_lru_scan_bwd.launches = 0
rg_lru_scan_bwd.launches_by = collections.Counter()
