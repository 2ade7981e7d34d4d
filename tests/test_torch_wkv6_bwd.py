"""Port vs reference: the RWKV-6 gradient's bit-exact twin ``wkv6_bwd_fma_ref``.

``kernels/ref.py::wkv6_bwd_fma_ref`` repeats the arithmetic of the
gradient's CUDA kernel (``csrc/wkv6_bwd.cu``): K and V padded to 64, each
sum over columns a chain per group of 4 and a butterfly over the 16
groups, each sum over rows a chain per row pair, the pairs added, then the
16 warps' sums in order, every fmaf correctly rounded (``fmaf_ref``). The
card holds the kernel to it bit for bit (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase 22); here it is held to the plain version
``wkv6_bwd_ref`` and to ``jax.vjp`` of the reference's ``ref.wkv6_ref``
within 1e-5 of each gradient's largest magnitude (float32 sums in another
order), and exactly where every operation is exact (dyadic inputs). Inputs
are made with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv6 as kwkv
from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

CHUNK = kwkv.BWD_CHUNK      # csrc/wkv6_bwd.cu's steps a checkpoint covers


def inputs(seed, b, t, h, dk, dv, resets=()):
    """float32 numpy (r, k, v, w, u, s0, dout, dsT); w = sigmoid(normal),
    0 at the (step, head, row) triples of ``resets`` (every batch row)."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    r, k, v = n(b, t, h, dk), n(b, t, h, dk), n(b, t, h, dv)
    w = (1.0 / (1.0 + np.exp(-n(b, t, h, dk)))).astype(np.float32)
    for step, head, row in resets:
        w[:, step, head, row] = 0.0
    return r, k, v, w, n(h, dk), n(b, h, dk, dv), n(b, t, h, dv), n(b, h, dk, dv)


def jax_grads(arrays):
    """jax.vjp of the reference's ``wkv6_ref`` at (r, k, v, w, u, s0),
    pulled back from (dout, dsT); du summed over the batch as the port's."""
    _, vjp = jax.vjp(jref.wkv6_ref, *map(jnp.asarray, arrays[:6]))
    return [np.asarray(g) for g in vjp((jnp.asarray(arrays[6]), jnp.asarray(arrays[7])))]


def rel_close(got, want, rel):
    """Every element within ``rel`` of ``want``'s largest magnitude."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max(initial=0.0)), 1e-30))


SHAPES = [(2, 0, 2, 4, 4), (1, 1, 1, 1, 1), (2, CHUNK - 1, 2, 5, 3), (2, CHUNK, 1, 64, 64),
          (1, CHUNK + 1, 2, 17, 33), (2, 2 * CHUNK + 3, 2, 8, 8), (1, 67, 3, 16, 16),
          (1, 3 * CHUNK, 1, 64, 1), (1, 12, 1, 1, 64)]


@pytest.mark.parametrize("b,t,h,dk,dv", SHAPES)
def test_fma_reference_matches_plain_and_jax_vjp(b, t, h, dk, dv):
    """Every gradient within 1e-5 of its tensor's largest magnitude from
    ``wkv6_bwd_ref`` and from ``jax.vjp``, at ragged K and V, T = 0 and 1
    and across chunk edges, with rows reset (w == 0) at a few steps."""
    resets = [(s, s % h, s % dk) for s in range(0, t, 5)]
    arrays = inputs(1, b, t, h, dk, dv, resets)
    tx = [torch.from_numpy(a) for a in arrays]
    got = tref.wkv6_bwd_fma_ref(*tx)
    for g, w, j in zip(got, tref.wkv6_bwd_ref(*tx), jax_grads(arrays)):
        assert g.dtype == w.dtype and g.shape == w.shape
        rel_close(g, w, 1e-5)
        rel_close(g, j, 1e-5)


def test_fma_reference_gives_dw_exactly_zero_at_reset_rows():
    """A reset row (w == 0) of a finite state passes no gradient to w, in
    one chunk only and in the last step."""
    b, t, h, dk, dv = 2, 2 * CHUNK + 3, 2, 8, 6
    arrays = list(inputs(2, b, t, h, dk, dv))
    zero = np.zeros_like(arrays[3], dtype=bool)
    zero[:, CHUNK:2 * CHUNK:3, 1, ::3] = True
    zero[:, -1, 0, :] = True
    arrays[3][zero] = 0.0
    got = tref.wkv6_bwd_fma_ref(*map(torch.from_numpy, arrays))
    assert float(got[3][torch.from_numpy(zero)].abs().max()) == 0.0
    assert float(got[3][torch.from_numpy(~zero)].abs().min()) > 0.0
    for g, j in zip(got, jax_grads(arrays)):
        rel_close(g, j, 1e-5)


def test_fma_reference_resets_an_overflowed_state():
    """k = v = 2e19 for 8 steps overflow the state; w == 0 at step 8
    selects k v^T (never 0 * inf): every gradient of the steps after it, and
    the initial state's, is finite and matches the plain version."""
    b, t, h, dk, dv = 1, 24, 1, 4, 4
    r, k, v, _, u, _, dout, dst = inputs(3, b, t, h, dk, dv)
    k[:, :8] = 2e19
    v[:, :8] = 2e19
    w = np.ones((b, t, h, dk), np.float32)
    w[:, 8] = 0.0
    tx = [torch.from_numpy(a) for a in (r, k, v, w, u, np.zeros((b, h, dk, dv), np.float32),
                                        dout, dst)]
    got = tref.wkv6_bwd_fma_ref(*tx)
    want = tref.wkv6_bwd_ref(*tx)
    for i in range(4):                                   # dr, dk, dv, dw
        assert bool(torch.isfinite(got[i][:, 9:]).all())
        rel_close(got[i][:, 9:], want[i][:, 9:], 1e-5)
    assert bool(torch.isfinite(got[5]).all())
    rel_close(got[5], want[5], 1e-5)
    assert not bool(torch.isfinite(got[0][:, 1:9]).all())   # dr reads the overflowed state


def dyadic(seed, b, t, h, dk, dv):
    """Inputs on which every operation of every version is exact: r, k, v,
    u, dout in {+-0.5, +-1, +-2}, w in {0, 0.5, 1}, small integer states and
    dsT; over 6 steps every sum stays within float32's 24 bits."""
    rng = np.random.default_rng(seed)

    def pick(vals, *shape):
        return rng.choice(np.asarray(vals, np.float32), shape)

    vals = (-2.0, -1.0, -0.5, 0.5, 1.0, 2.0)
    ints = (-2.0, -1.0, 0.0, 1.0, 2.0)
    return (pick(vals, b, t, h, dk), pick(vals, b, t, h, dk), pick(vals, b, t, h, dv),
            pick((0.0, 0.5, 1.0), b, t, h, dk), pick(vals, h, dk), pick(ints, b, h, dk, dv),
            pick(vals, b, t, h, dv), pick(ints, b, h, dk, dv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,dv", [(8, 8), (5, 3), (1, 4), (64, 64)])
def test_fma_reference_is_exact_on_dyadic_inputs(dk, dv, dtype):
    """Where every operation is exact the order of the sums cannot matter:
    ``wkv6_bwd_fma_ref`` equals ``wkv6_bwd_ref`` and ``jax.vjp`` of the
    reference exactly (bf16 gradients each the exact value rounded once)."""
    arrays = dyadic(dk * 10 + dv, 2, 6, 2, dk, dv)
    tx = [torch.from_numpy(a) for a in arrays]
    tx = [x.to(dtype) if i in (0, 1, 2, 6) else x for i, x in enumerate(tx)]
    got = tref.wkv6_bwd_fma_ref(*tx)
    for g, w, j in zip(got, tref.wkv6_bwd_ref(*tx), jax_grads(arrays)):
        assert torch.equal(g, w)
        assert torch.equal(g, torch.from_numpy(np.array(j, np.float32)).to(g.dtype))
    assert all(bool((g != 0).any()) for g in got)


def test_fma_reference_gives_bf16_gradients_in_bf16():
    """bf16 r, k, v and dout: dr, dk, dv come back bf16, each the float32
    sum rounded once (within a bf16 step of the float32 run on the widened
    values); dw, du and the state's float32 and equal to that run's."""
    arrays = inputs(4, 2, 2 * CHUNK + 1, 2, 8, 8)
    tx = [torch.from_numpy(a) for a in arrays]
    lo = [x.bfloat16() if i in (0, 1, 2, 6) else x for i, x in enumerate(tx)]
    widened = [x.float() for x in lo]
    got = tref.wkv6_bwd_fma_ref(*lo)
    want = tref.wkv6_bwd_fma_ref(*widened)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 3
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w.bfloat16())
    for g, w in zip(got[3:], want[3:]):
        assert torch.equal(g, w)


def test_plain_version_in_float64():
    """``wkv6_bwd_ref(..., dtype=torch.float64)`` computes every gradient in
    float64; the float32 versions sit within 1e-6 of it."""
    arrays = inputs(5, 2, 19, 2, 16, 16, resets=[(3, 0, 1)])
    tx = [torch.from_numpy(a) for a in arrays]
    f64 = tref.wkv6_bwd_ref(*tx, dtype=torch.float64)
    assert all(g.dtype == torch.float64 for g in f64)
    for version in (tref.wkv6_bwd_ref, tref.wkv6_bwd_fma_ref):
        for g, w in zip(version(*tx), f64):
            rel_close(g, w.float(), 1e-6)


@pytest.mark.parametrize("t,want", [(0, 0), (1, 0), (CHUNK, 0), (2 * CHUNK, 0),
                                    (2 * CHUNK + 1, 1), (512, 62)])
def test_checkpoint_scratch_holds_the_inner_chunk_starts(t, want):
    """A checkpoint per chunk start but the first and the last, 64 x 64
    floats each, per (batch, head)."""
    assert kwkv.bwd_checkpoint_floats(3, t, 2) == 3 * 2 * want * 64 * 64


def test_bwd_chunk_is_the_kernels_ck():
    """The wrapper sizes the checkpoint scratch by ``BWD_CHUNK``: it must be
    ``csrc/wkv6_bwd.cu``'s ``CK``, which the kernel reads."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "wkv6_bwd.cu").read_text()
    assert re.findall(r"constexpr int CK = (\d+);", src) == [str(kwkv.BWD_CHUNK)]
