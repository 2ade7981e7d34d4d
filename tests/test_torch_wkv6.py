"""Port vs reference: the RWKV-6 recurrence ``wkv6``.

The port's ``kernels.ops.wkv6`` on CPU tensors (its plain version,
``kernels/ref.py::wkv6_ref``) is held against the JAX package's
``ref.wkv6_ref`` and against its Pallas kernel on the interpreter
(``kernels/ops.py::wkv6`` in ``interpret`` mode, which pads a ragged T with
identity steps). The hand-written CUDA kernel is checked on the card by
``tests/test_torch_gpu.py``, bit for bit against ``wkv6_fma_ref`` (the
kernel's fmaf chains through a correctly rounded fmaf), which is held here
against both plain references. Inputs are made with numpy from a seed and
handed to both packages.

Tolerance policy (``tests/test_kernel_conformance.py:15-31``): float32
``rtol = atol = 1e-4``; bfloat16 r/k/v ``rtol = 5e-2, atol = 2.5e-1``
(the port widens them before the recurrence, the JAX ``wkv6_ref`` rounds
``k v`` to bf16, and the outputs are stored in bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv6 as kwkv
from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=5e-2, atol=2.5e-1)}


def assert_close(got, want, dtype="float32"):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **_TOL[dtype])


def as_f32(x):
    """A torch tensor (any float dtype) or JAX array as float32 numpy."""
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def inputs(seed, b, t, h, dk, dv):
    """float32 numpy (r, k, v, w, u, s0); w = sigmoid(normal) in (0, 1)."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    r, k, v = n(b, t, h, dk), n(b, t, h, dk), n(b, t, h, dv)
    w = (1.0 / (1.0 + np.exp(-n(b, t, h, dk)))).astype(np.float32)
    return r, k, v, w, n(h, dk), n(b, h, dk, dv)


def both(arrays, dtype="float32"):
    """The same values for each package: r, k, v in ``dtype``; w, u, s0 f32."""
    jx = [jnp.asarray(a) for a in arrays]
    tx = [torch.from_numpy(a.copy()) for a in arrays]
    if dtype == "bfloat16":
        jx[:3] = [a.astype(jnp.bfloat16) for a in jx[:3]]
        tx[:3] = [a.to(torch.bfloat16) for a in tx[:3]]
    return jx, tx


def check(arrays, dtype="float32", chunk=8, from_t=0):
    """Port (CPU, plain) vs the JAX oracle and vs the Pallas kernel on the
    interpreter; outputs from token ``from_t`` on, and the final state."""
    jx, tx = both(arrays, dtype)
    out, sf = tops.wkv6(*tx)
    assert out.dtype == tx[0].dtype and sf.dtype == torch.float32
    assert out.shape == (*tx[0].shape[:3], tx[2].shape[-1])
    for want_o, want_s in (jref.wkv6_ref(*jx),
                           jops.wkv6(*jx, chunk=min(chunk, max(tx[0].shape[1], 1)),
                                     mode="interpret")):
        assert_close(out[:, from_t:], np.asarray(want_o, np.float32)[:, from_t:], dtype)
        assert_close(sf, want_s, dtype)
    return out, sf


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,dk,dv,chunk", [
    (2, 32, 3, 8, 8, 8),          # tests/test_kernels.py:129-132
    (1, 64, 2, 16, 16, 16),
    (2, 16, 1, 4, 8, 16),         # single chunk, K != V
    (1, 1, 1, 1, 1, 4),           # fully degenerate (test_kernel_conformance.py:337-341)
    (2, 37, 2, 4, 4, 16),         # ragged T
    (1, 64, 2, 8, 8, 16),
    (4, 1, 4, 16, 16, 16),        # a decode step: T = 1
])
def test_plain_version_matches_reference(b, t, h, dk, dv, chunk, dtype):
    check(inputs(b * 1000 + t, b, t, h, dk, dv), dtype, chunk)


def test_extreme_decay_sweep():
    """w exactly 0 (reset) and 1 (keep), subnormal 1e-38, 1e-6, 1 - 1e-6,
    and one extreme per channel, with a nonzero initial state: finite and
    equal to the reference (``tests/test_kernels.py:148-170``)."""
    b, t, h, dk, dv = 1, 64, 1, 4, 4
    r, k, v, _, u, s0 = inputs(10, b, t, h, dk, dv)
    mixed = np.stack([np.zeros((b, t, h)), np.ones((b, t, h)), np.full((b, t, h), 1e-38),
                      np.full((b, t, h), 1.0 - 1e-6)], axis=-1).astype(np.float32)
    sweeps = [np.full((b, t, h, dk), wv, np.float32)
              for wv in (0.0, 1e-38, 1e-6, 1.0 - 1e-6, 1.0)] + [mixed]
    for w in sweeps:
        out, _ = check((r, k, v, w, u, s0))
        assert bool(torch.isfinite(out).all())


def test_instant_forget_resets_an_overflowed_state():
    """k, v = 2e19 for 8 tokens with w = 1 overflow the state to inf; w = 0
    at token 8 resets it exactly, so every later output and the final state
    are finite and equal the reference (``tests/test_kernels.py:172-190``)."""
    b, t, h, dk, dv = 1, 24, 1, 4, 4
    r, k, v, _, u, _ = inputs(11, b, t, h, dk, dv)
    k[:, :8] = 2e19
    v[:, :8] = 2e19
    w = np.ones((b, t, h, dk), np.float32)
    w[:, 8] = 0.0
    s0 = np.zeros((b, h, dk, dv), np.float32)
    out, sf = check((r, k, v, w, u, s0), from_t=9)
    assert bool(torch.isfinite(out[:, 9:]).all()) and bool(torch.isfinite(sf).all())
    assert not bool(torch.isfinite(out[:, :8]).all())          # it did overflow


def test_steps_compose():
    """Running T tokens at once equals running them one step at a time from
    the carried state (the prefill / decode split of the serving path)."""
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in inputs(12, 2, 9, 3, 8, 8))
    out, sf = tops.wkv6(r, k, v, w, u, s0)
    s = s0
    for i in range(9):
        o, s = tops.wkv6(r[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1], w[:, i:i + 1], u, s)
        torch.testing.assert_close(o[:, 0], out[:, i], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s, sf, rtol=1e-6, atol=1e-6)


def test_dispatch_never_falls_back():
    """CPU tensors take the plain version; ``mode='cuda'`` on them raises,
    as does the kernel wrapper itself; the plain version never aliases the
    caller's state, even for T = 0."""
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in inputs(13, 1, 0, 2, 4, 4))
    before = kwkv.wkv6.launches
    out, sf = tops.wkv6(r, k, v, w, u, s0, mode="ref")
    assert out.shape == (1, 0, 2, 4) and torch.equal(sf, s0)
    assert sf.data_ptr() != s0.data_ptr()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.wkv6(r, k, v, w, u, s0, mode="cuda")
    with pytest.raises(ValueError, match="one CUDA device"):
        kwkv.wkv6(r, k, v, w, u, s0)
    assert kwkv.wkv6.launches == before


def test_plain_version_is_the_oracle_loop():
    """One step by hand: out = r . (S + u k v^T), S' = w S + k v^T."""
    r, k, v, w, u, s0 = (torch.from_numpy(a).double() for a in inputs(14, 1, 1, 1, 3, 2))
    out, sf = tref.wkv6_ref(r.float(), k.float(), v.float(), w.float(), u.float(), s0.float())
    kv = k[0, 0, 0][:, None] * v[0, 0, 0][None, :]
    want_o = r[0, 0, 0] @ (s0[0, 0] + u[0][:, None] * kv)
    want_s = w[0, 0, 0][:, None] * s0[0, 0] + kv
    torch.testing.assert_close(out[0, 0, 0].double(), want_o, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sf[0, 0].double(), want_s, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,dk,dv", [
    (2, 32, 3, 8, 8),
    (1, 37, 2, 33, 17),           # K not a multiple of the 4 partials
    (4, 1, 4, 16, 16),            # a decode step
    (1, 5, 1, 1, 1),              # three partials with no rows
    (1, 70, 1, 64, 64),           # rwkv6-7b's head, more than two chunks
])
def test_fma_reference_matches_the_references(b, t, h, dk, dv, dtype):
    """``wkv6_fma_ref`` against the port's ``wkv6_ref`` and the JAX
    ``ref.wkv6_ref`` within the stated tolerances."""
    jx, tx = both(inputs(b * 1000 + t + 7, b, t, h, dk, dv), dtype)
    out, sf = tref.wkv6_fma_ref(*tx)
    assert out.dtype == tx[0].dtype and sf.dtype == torch.float32
    assert out.shape == (b, t, h, dv) and sf.shape == (b, h, dk, dv)
    for want_o, want_s in (tref.wkv6_ref(*tx), jref.wkv6_ref(*jx)):
        assert_close(out, as_f32(want_o), dtype)
        assert_close(sf, as_f32(want_s), dtype)


def dyadic_inputs(seed, b, t, h, dk, dv):
    """Inputs on which every operation of every reference is exact: r, k, v,
    u in {+-0.5, +-1, +-2}, w in {0, 0.5, 1}, a small integer state; over 8
    steps every sum stays within float32's 24 bits."""
    rng = np.random.default_rng(seed)

    def pick(vals, *shape):
        return rng.choice(np.asarray(vals, np.float32), shape)

    vals = (-2.0, -1.0, -0.5, 0.5, 1.0, 2.0)
    return (pick(vals, b, t, h, dk), pick(vals, b, t, h, dk), pick(vals, b, t, h, dv),
            pick((0.0, 0.5, 1.0), b, t, h, dk), pick(vals, h, dk),
            pick((-2.0, -1.0, 0.0, 1.0, 2.0), b, h, dk, dv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dk,dv", [(8, 8), (5, 3), (1, 4)])
def test_fma_reference_is_exact_on_dyadic_inputs(dk, dv, dtype):
    """Where every operation is exact the order of the sums cannot matter:
    ``wkv6_fma_ref`` equals ``wkv6_ref`` and the JAX ``ref.wkv6_ref`` (its
    float32 out rounded to the port's bf16 out) exactly."""
    jx, tx = both(dyadic_inputs(dk * 10 + dv, 2, 8, 2, dk, dv), dtype)
    out, sf = tref.wkv6_fma_ref(*tx)
    port_o, port_s = tref.wkv6_ref(*tx)
    jax_o, jax_s = (torch.from_numpy(np.array(x, np.float32)) for x in jref.wkv6_ref(*jx))
    assert torch.equal(out, port_o) and torch.equal(sf, port_s)
    assert torch.equal(out, jax_o.to(out.dtype)) and torch.equal(sf, jax_s)
    assert bool((out != 0).any())


def test_fma_reference_resets_an_overflowed_state():
    """The overflow of ``test_instant_forget_resets_an_overflowed_state``:
    ``wkv6_fma_ref`` overflows too, and ``w == 0`` resets it, so every later
    output and the final state are finite and match both references."""
    b, t, h, dk, dv = 1, 24, 1, 4, 4
    r, k, v, _, u, _ = inputs(11, b, t, h, dk, dv)
    k[:, :8] = 2e19
    v[:, :8] = 2e19
    w = np.ones((b, t, h, dk), np.float32)
    w[:, 8] = 0.0
    jx, tx = both((r, k, v, w, u, np.zeros((b, h, dk, dv), np.float32)))
    out, sf = tref.wkv6_fma_ref(*tx)
    assert not bool(torch.isfinite(out[:, :8]).all())
    assert bool(torch.isfinite(out[:, 9:]).all()) and bool(torch.isfinite(sf).all())
    for want_o, want_s in (tref.wkv6_ref(*tx), jref.wkv6_ref(*jx)):
        assert_close(out[:, 9:], as_f32(want_o)[:, 9:])
        assert_close(sf, as_f32(want_s))


def test_fma_reference_takes_no_steps_for_an_empty_sequence():
    """T = 0: no output, the state returned as a copy."""
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in inputs(15, 2, 0, 3, 4, 5))
    out, sf = tref.wkv6_fma_ref(r, k, v, w, u, s0)
    assert out.shape == (2, 0, 3, 5) and torch.equal(sf, s0)
    assert sf.data_ptr() != s0.data_ptr()
