"""Launch wrapper of the hand-written RWKV-6 WKV kernel (``csrc/wkv6.cu``;
replaces ``repro/kernels/wkv6.py::wkv6``).

CUDA tensors only: the plain version is ``kernels/ref.py::wkv6_ref`` and
``kernels/ops.py`` chooses between them; ``kernels/ref.py::wkv6_fma_ref``
repeats the kernel's arithmetic bit for bit. r, k, v are float32 or
bfloat16 (one dtype): the kernel widens them as it stages them and writes
``out`` in that dtype; w, u and the state are float32. It loops over any T,
so nothing is padded. The kernel's launcher picks its cp.async path or its
element path by shape and pointer alignment (``csrc/wkv6.cu``).
``wkv6.launches`` counts kernel launches, and ``wkv6.launches_by`` counts
them by (B, T, H, K, V).

:func:`wkv6_bwd` launches the gradient's kernel (``csrc/wkv6_bwd.cu``;
its plain version is ``kernels/ref.py::wkv6_bwd_ref``) and counts its
launches in ``wkv6_bwd.launches`` and ``wkv6_bwd.launches_by``.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.compat import count_launch

MAX_HEAD = 64                   # K and V bound (registers per state column)
_ENTRY = {torch.float32: "wkv6_f32", torch.bfloat16: "wkv6_bf16"}
_BWD_ENTRY = {torch.float32: "wkv6_bwd_f32", torch.bfloat16: "wkv6_bwd_bf16"}


def _checked(what: str, r, k, v, w, u, state, dout=None, dsT=None) -> tuple[int, ...]:
    """Raise unless the operands are what the kernels take; (B, T, H, K, V)."""
    xs = [x for x in (r, k, v, w, u, state, dout, dsT) if x is not None]
    dev = r.device
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError(f"{what} kernel needs every tensor on one CUDA device; got "
                         f"{[str(x.device) for x in xs]}")
    if r.dtype not in _ENTRY or k.dtype != r.dtype or v.dtype != r.dtype or \
            (dout is not None and dout.dtype != r.dtype) or \
            any(x.dtype != torch.float32 for x in (w, u, state, dsT) if x is not None):
        raise TypeError(f"{what} takes r, k, v (and dout) of one dtype (float32 or "
                        "bfloat16) and float32 w, u and states; got "
                        f"{[x.dtype for x in xs]}")
    if r.ndim != 4:
        raise ValueError(f"{what}: r has shape {tuple(r.shape)}; expected (B, T, H, K)")
    b, t, h, dk = r.shape
    dv = v.shape[-1] if v.ndim == 4 else -1
    if (k.shape != r.shape or w.shape != r.shape or tuple(v.shape) != (b, t, h, dv)
            or tuple(u.shape) != (h, dk) or tuple(state.shape) != (b, h, dk, dv)
            or (dout is not None and dout.shape != v.shape)
            or (dsT is not None and dsT.shape != state.shape)):
        raise ValueError(
            f"{what} shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"w {tuple(w.shape)}, u {tuple(u.shape)}, state {tuple(state.shape)}; "
            "expected r/k/w (B, T, H, K), v (B, T, H, V), u (H, K), state (B, H, K, V)"
            + (", dout as v and dsT as the state" if dout is not None else ""))
    if not (1 <= dk <= MAX_HEAD and 1 <= dv <= MAX_HEAD):
        raise ValueError(f"{what} kernel takes 1 <= K, V <= {MAX_HEAD}; got K={dk}, V={dv}")
    if b * h >= 2**31:
        raise ValueError(f"{what} kernel takes fewer than 2**31 (batch x head) blocks")
    return b, t, h, dk, dv


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k (B, T, H, K) and v (B, T, H, V), float32 or bfloat16; w
    (B, T, H, K), u (H, K), state (B, H, K, V) float32 -> (out (B, T, H, V)
    in r's dtype, final state (B, H, K, V) float32), on the CUDA device."""
    b, t, h, dk, dv = _checked("wkv6", r, k, v, w, u, state)
    dev = r.device
    ins = [x.contiguous() for x in (r, k, v, w, u, state)]
    out = torch.empty((b, t, h, dv), dtype=r.dtype, device=dev)
    s_out = torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev)
    if b * h:
        entry = getattr(_build.library("wkv6"), _ENTRY[r.dtype])
        err = entry(*(x.data_ptr() for x in ins), out.data_ptr(), s_out.data_ptr(),
                    b, t, h, dk, dv, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "wkv6")
        count_launch(wkv6, (b, t, h, dk, dv))
    return out, s_out


wkv6.launches = 0
wkv6.launches_by = collections.Counter()


BWD_CHUNK = 8           # steps a checkpoint of csrc/wkv6_bwd.cu covers (its CK)


def bwd_checkpoint_floats(b: int, t: int, h: int) -> int:
    """Floats of :func:`wkv6_bwd`'s checkpoint scratch: a 64 x 64 float32
    state per (batch, head) at the start of every chunk of ``BWD_CHUNK``
    steps but the first (the initial state) and the last (the end of the
    kernel's forward sweep, kept in registers)."""
    return b * h * max(-(-t // BWD_CHUNK) - 2, 0) * MAX_HEAD * MAX_HEAD


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: torch.Tensor, dout: torch.Tensor,
             dsT: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The gradient of :func:`wkv6` at (r, k, v, w, u, state) given those
    of its outputs, dout (B, T, H, V) in r's dtype and dsT (B, H, K, V)
    float32, on the CUDA device -> (dr, dk, dv in r's dtype; dw (B, T, H,
    K), du (H, K), dstate (B, H, K, V) float32). The kernel recomputes the
    states from ``state`` (nothing is kept from the forward); this wrapper
    allocates its scratch: the per-batch sums of du and the checkpoints
    (:func:`bwd_checkpoint_floats`)."""
    b, t, h, dk, dv = _checked("wkv6_bwd", r, k, v, w, u, state, dout, dsT)
    dev = r.device
    ins = [x.contiguous() for x in (r, k, v, w, u, state, dout, dsT)]
    lib = _build.library("wkv6_bwd")
    f32 = dict(dtype=torch.float32, device=dev)
    outs = [torch.empty_like(ins[0]), torch.empty_like(ins[1]), torch.empty_like(ins[2]),
            torch.empty((b, t, h, dk), **f32), torch.empty((h, dk), **f32),
            torch.empty((b, h, dk, dv), **f32)]
    scratch = [torch.empty((b * h * dk,), **f32),
               torch.empty((bwd_checkpoint_floats(b, t, h),), **f32)]
    if h:                                   # else every output is empty
        err = getattr(lib, _BWD_ENTRY[r.dtype])(
            *(x.data_ptr() for x in ins + outs + scratch), b, t, h, dk, dv,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "wkv6_bwd")
        count_launch(wkv6_bwd, (b, t, h, dk, dv))
    return tuple(outs)


wkv6_bwd.launches = 0
wkv6_bwd.launches_by = collections.Counter()
