"""Port vs reference: the three kernels' plain versions and the kernel-mode
policy. The hand-written kernels themselves are checked on the card by
``tests/test_torch_gpu.py``.

The plain versions (``repro_torch.kernels.ref``) are held against the JAX
package's ``kernels.ops`` entry points in ``interpret`` mode (the Pallas
kernel bodies on the interpreter, as ``tests/test_kernel_conformance.py``
runs them) and in ``ref`` mode.

Tolerance policy (``tests/test_kernel_conformance.py:15-31``): float32
``rtol = atol = 1e-4`` at unit scale, ``atol`` scaled by ``scale**2`` for
magnitude-``scale`` inputs; bfloat16 series ``rtol = 5e-2, atol = 2.5e-1``.
Integer argmins are exactly equal, ties included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import summaries as JS
from repro.kernels import ed as jed
from repro.kernels import ops as jops
from repro_torch.core import summaries as TS
from repro_torch.kernels import ed as ked
from repro_torch.kernels import lb_sax as klb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.compat import KERNEL_MODES, resolve_kernel_mode

jax.config.update("jax_platform_name", "cpu")

_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=5e-2, atol=2.5e-1)}
CPU = torch.device("cpu")


def assert_close(got, want, dtype="float32", scale=1.0):
    tol = _TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol["rtol"], atol=tol["atol"] * max(scale, 1.0) ** 2)


def qs(seed, q, n, length, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((q, length)) * scale).astype(np.float32),
            (rng.standard_normal((n, length)) * scale).astype(np.float32))


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the kernel-mode policy
# ---------------------------------------------------------------------------

def test_mode_policy_goes_by_tensor_device():
    assert KERNEL_MODES == ("auto", "cuda", "ref")
    assert resolve_kernel_mode("auto", CPU) == "ref"
    assert resolve_kernel_mode("ref", CPU) == "ref"
    assert resolve_kernel_mode("auto", torch.device("cuda")) == "cuda"
    assert resolve_kernel_mode("ref", torch.device("cuda")) == "ref"
    assert resolve_kernel_mode("cuda", torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        resolve_kernel_mode("cuda", CPU)
    with pytest.raises(ValueError, match="kernel_mode"):
        resolve_kernel_mode("pallas", CPU)


@pytest.mark.parametrize("call", [
    lambda: tops.ed_matrix(torch.zeros(2, 8), torch.zeros(3, 8), mode="cuda"),
    lambda: tops.ed_min(torch.zeros(2, 8), torch.zeros(3, 8), mode="cuda"),
    lambda: tops.lb_sax(torch.zeros(2, 16), torch.zeros(3, 16, dtype=torch.uint8), 64,
                        mode="cuda"),
])
def test_cuda_mode_on_cpu_tensors_raises(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("call", [
    lambda: ked.ed_matrix(torch.zeros(2, 8), torch.zeros(3, 8)),
    lambda: ked.ed_min(torch.zeros(2, 8), torch.zeros(3, 8)),
    lambda: klb.lb_sax_matrix(torch.zeros(2, 16), torch.zeros(3, 16, dtype=torch.uint8), 64),
])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its kernel or raises; it never computes on the CPU."""
    before = (ked.ed_matrix.launches, ked.ed_min.launches, klb.lb_sax_matrix.launches)
    with pytest.raises(ValueError, match="CUDA device"):
        call()
    assert (ked.ed_matrix.launches, ked.ed_min.launches,
            klb.lb_sax_matrix.launches) == before


def test_auto_on_cpu_takes_the_plain_version():
    qa, sa = qs(0, 3, 20, 16)
    before = ked.ed_matrix.launches
    out = tops.ed_matrix(t(qa), t(sa))
    assert torch.equal(out, tref.ed_matrix_ref(t(qa), t(sa)))
    assert ked.ed_matrix.launches == before


# ---------------------------------------------------------------------------
# plain versions vs the reference's kernels (interpret) and oracles (ref)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jmode,q,n,length", [
    ("interpret", 1, 1, 1), ("interpret", 1, 100, 128), ("interpret", 8, 129, 33),
    ("interpret", 5, 77, 48), ("ref", 5, 77, 48)])
def test_ed_matrix(jmode, q, n, length):
    qa, sa = qs(1, q, n, length)
    want = jops.ed_matrix(jnp.asarray(qa), jnp.asarray(sa), mode=jmode)
    assert_close(tops.ed_matrix(t(qa), t(sa)), want)


@pytest.mark.parametrize("jmode", ["interpret", "ref"])
def test_ed_matrix_bf16_series(jmode):
    qa, sa = qs(2, 5, 77, 48)
    sb = jnp.asarray(sa).astype(jnp.bfloat16)
    want = jops.ed_matrix(jnp.asarray(qa), sb, mode=jmode)
    got = tops.ed_matrix(t(qa), t(sa).to(torch.bfloat16))
    assert_close(got, want, "bfloat16")


def test_ed_matrix_large_magnitudes():
    qa, sa = qs(3, 3, 17, 24, scale=1e18)
    want = jops.ed_matrix(jnp.asarray(qa), jnp.asarray(sa), mode="ref")
    assert np.all(np.isfinite(np.asarray(want)))
    assert_close(tops.ed_matrix(t(qa), t(sa)), want, scale=1e18)


@pytest.mark.parametrize("jmode,q,n,length", [
    ("interpret", 1, 1, 1), ("interpret", 3, 13, 64), ("interpret", 5, 77, 48),
    ("ref", 5, 77, 48)])
def test_ed_min(jmode, q, n, length):
    qa, sa = qs(4, q, n, length)
    want_d, want_a = jops.ed_min(jnp.asarray(qa), jnp.asarray(sa), mode=jmode)
    dmin, amin = tops.ed_min(t(qa), t(sa))
    assert amin.dtype == torch.int32
    assert_close(dmin, want_d)
    np.testing.assert_array_equal(amin.numpy(), np.asarray(want_a))


def test_ed_min_valid_n_masks_like_the_pallas_kernel():
    """Rows at or past ``valid_n`` never win: the reference kernel body (its
    own masking, on the interpreter) against the plain version."""
    qa, sa = qs(5, 8, 128, 128)
    sa[100:] = qa[0]                      # masked rows would win if live
    want_d, want_a = jed.ed_min(jnp.asarray(qa), jnp.asarray(sa), bq=8, bn=128,
                                bk=128, valid_n=100, interpret=True)
    dmin, amin = tops.ed_min(t(qa), t(sa), valid_n=100)
    np.testing.assert_array_equal(amin.numpy(), np.asarray(want_a))
    assert int(amin.max()) < 100
    assert_close(dmin, want_d)


def test_ed_min_ties_go_to_the_lowest_index():
    qa, sa = np.zeros((4, 16), np.float32), np.ones((11, 16), np.float32)
    want_d, want_a = jops.ed_min(jnp.asarray(qa), jnp.asarray(sa), mode="interpret")
    dmin, amin = tops.ed_min(t(qa), t(sa))
    np.testing.assert_array_equal(amin.numpy(), np.asarray(want_a))
    assert bool((amin == 0).all())
    assert_close(dmin, want_d)


def test_ed_min_all_inf_row_reports_index_zero():
    qa = np.full((2, 16), 2.0e19, np.float32)
    sa = np.full((5, 16), -2.0e19, np.float32)
    want_d, want_a = jops.ed_min(jnp.asarray(qa), jnp.asarray(sa), mode="interpret")
    dmin, amin = tops.ed_min(t(qa), t(sa))
    assert bool(torch.isinf(dmin).all())
    np.testing.assert_array_equal(dmin.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(amin.numpy(), np.asarray(want_a))


@pytest.mark.parametrize("jmode,q,n,m,alphabet", [
    ("interpret", 1, 1, 16, 256), ("interpret", 5, 77, 16, 256),
    ("interpret", 3, 130, 8, 256), ("interpret", 4, 300, 16, 64), ("ref", 5, 77, 16, 256)])
def test_lb_sax_matrix(jmode, q, n, m, alphabet):
    length = 4 * m
    qa, sa = qs(6, q, n, length)
    q_paa = np.asarray(JS.paa(jnp.asarray(qa), m))
    codes = np.asarray(JS.isax(jnp.asarray(sa), m, alphabet))
    want = jops.lb_sax(jnp.asarray(q_paa), jnp.asarray(codes), length,
                       alphabet=alphabet, mode=jmode)
    got = tops.lb_sax(t(q_paa), t(codes), length, alphabet=alphabet)
    assert_close(got, want)


def test_lb_sax_constant_and_extreme_inputs():
    q_paa = np.zeros((2, 16), np.float32)
    codes = np.asarray(JS.isax(jnp.zeros((5, 64)), 16))
    got = tops.lb_sax(t(q_paa), t(codes), 64)
    np.testing.assert_array_equal(got.numpy(), 0.0)
    q_paa = np.full((2, 16), 1.0e15, np.float32)
    codes = np.asarray(JS.isax(jnp.asarray(qs(7, 1, 7, 64)[1]), 16))
    want = jops.lb_sax(jnp.asarray(q_paa), jnp.asarray(codes), 64, mode="ref")
    assert_close(tops.lb_sax(t(q_paa), t(codes), 64), want, scale=1e15)


def test_lb_sax_bound_tables_match_cell_bounds():
    lo, hi = klb.bound_tables(256, CPU)
    codes = torch.arange(256, dtype=torch.uint8)
    clo, chi = TS.isax_cell_bounds(codes)
    assert torch.equal(lo, clo) and torch.equal(hi, chi)


def test_plain_versions_block_the_series_axis(monkeypatch):
    """Row blocking bounds memory and changes no bits."""
    qa, sa = qs(8, 4, 50, 32)
    full = tref.ed_matrix_ref(t(qa), t(sa))
    lb_full = tref.lb_sax_matrix_ref(TS.paa(t(qa)), TS.isax(t(sa)), 32)
    monkeypatch.setattr(tref, "_BLOCK_ELEMS", 4 * 32 * 7)
    assert torch.equal(tref.ed_matrix_ref(t(qa), t(sa)), full)
    assert torch.equal(tref.lb_sax_matrix_ref(TS.paa(t(qa)), TS.isax(t(sa)), 32), lb_full)
