"""Launch wrapper of the hand-written RWKV-6 WKV kernel (``csrc/wkv6.cu``;
replaces ``repro/kernels/wkv6.py::wkv6``).

CUDA tensors only: the plain version is ``kernels/ref.py::wkv6_ref`` and
``kernels/ops.py`` chooses between them; ``kernels/ref.py::wkv6_fma_ref``
repeats the kernel's arithmetic bit for bit. r, k, v are float32 or
bfloat16 (one dtype): the kernel widens them as it stages them and writes
``out`` in that dtype; w, u and the state are float32. It loops over any T,
so nothing is padded. The kernel's launcher picks its cp.async path or its
element path by shape and pointer alignment (``csrc/wkv6.cu``).
``wkv6.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.compat import count_launch

MAX_HEAD = 64                   # K and V bound (registers per state column)
_ENTRY = {torch.float32: "wkv6_f32", torch.bfloat16: "wkv6_bf16"}


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k (B, T, H, K) and v (B, T, H, V), float32 or bfloat16; w
    (B, T, H, K), u (H, K), state (B, H, K, V) float32 -> (out (B, T, H, V)
    in r's dtype, final state (B, H, K, V) float32), on the CUDA device."""
    dev = r.device
    if dev.type != "cuda" or any(x.device != dev for x in (k, v, w, u, state)):
        raise ValueError("wkv6 kernel needs every tensor on one CUDA device; got "
                         f"{[str(x.device) for x in (r, k, v, w, u, state)]}")
    if r.dtype not in _ENTRY or k.dtype != r.dtype or v.dtype != r.dtype or \
            any(x.dtype != torch.float32 for x in (w, u, state)):
        raise TypeError("wkv6 takes r, k, v of one dtype (float32 or bfloat16) and "
                        "float32 w, u and state; got "
                        f"{[x.dtype for x in (r, k, v, w, u, state)]}")
    if r.ndim != 4:
        raise ValueError(f"wkv6: r has shape {tuple(r.shape)}; expected (B, T, H, K)")
    b, t, h, dk = r.shape
    dv = v.shape[-1] if v.ndim == 4 else -1
    if (k.shape != r.shape or w.shape != r.shape or tuple(v.shape) != (b, t, h, dv)
            or tuple(u.shape) != (h, dk) or tuple(state.shape) != (b, h, dk, dv)):
        raise ValueError(
            f"wkv6 shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"w {tuple(w.shape)}, u {tuple(u.shape)}, state {tuple(state.shape)}; "
            "expected r/k/w (B, T, H, K), v (B, T, H, V), u (H, K), state (B, H, K, V)")
    if not (1 <= dk <= MAX_HEAD and 1 <= dv <= MAX_HEAD):
        raise ValueError(f"wkv6 kernel takes 1 <= K, V <= {MAX_HEAD}; got K={dk}, V={dv}")
    if b * h >= 2**31:
        raise ValueError("wkv6 kernel takes fewer than 2**31 (batch x head) blocks")
    ins = [x.contiguous() for x in (r, k, v, w, u, state)]
    out = torch.empty((b, t, h, dv), dtype=r.dtype, device=dev)
    s_out = torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev)
    if b * h:
        entry = getattr(_build.library("wkv6"), _ENTRY[r.dtype])
        err = entry(*(x.data_ptr() for x in ins), out.data_ptr(), s_out.data_ptr(),
                    b, t, h, dk, dv, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "wkv6")
        count_launch(wkv6)
    return out, s_out


wkv6.launches = 0
