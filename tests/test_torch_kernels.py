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
import math
from fractions import Fraction

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
from _torch_threads import one_torch_thread  # noqa: F401

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


# ---------------------------------------------------------------------------
# the exact-arithmetic references of the ED kernels
# ---------------------------------------------------------------------------

def _round_f32(x: Fraction, zero_sign: float) -> np.float32:
    """An exact rational rounded to float32, to nearest with ties to even
    (Python's ``round``), subnormals kept, overflow to inf; an exact zero
    takes ``zero_sign``'s sign."""
    if x == 0:
        return np.float32(math.copysign(0.0, zero_sign))
    mag = abs(x)
    e = mag.numerator.bit_length() - mag.denominator.bit_length()
    if Fraction(2) ** e > mag:
        e -= 1
    quantum = Fraction(2) ** (max(e, -126) - 23)
    v = round(mag / quantum) * quantum
    out = math.inf if v >= Fraction(2) ** 128 else float(v)
    return np.float32(out if x > 0 else -out)


def _fma_triples(family: str, count: int = 1000):
    """(a, b, c) float32 triples of one family, from a numpy seed."""
    rng = np.random.default_rng(["random", "halfway", "cancel", "subnormal",
                                 "huge"].index(family))

    def f32(x):
        return np.asarray(x, np.float32)

    def spread(lo, hi):
        return rng.standard_normal(count) * np.exp2(rng.integers(lo, hi, count))

    if family == "random":
        return f32(spread(-60, 60)), f32(spread(-60, 60)), f32(spread(-130, 120))
    if family == "halfway":
        # (1 + i 2^-12)(1 + j 2^-12) needs 25 significant bits: products that
        # sit on a float32 midpoint, nudged by a tiny or a zero addend, so a
        # plain double rounding would land on the midpoint and round wrong
        i = rng.integers(1, 1 << 11, count) * 2 + 1
        j = rng.integers(1, 1 << 11, count) * 2 + 1
        scale = np.exp2(rng.integers(-20, 20, count))
        a = f32((1 + i * 2.0 ** -12) * scale * rng.choice([-1, 1], count))
        b = f32((1 + j * 2.0 ** -12) / scale)
        c = f32(rng.choice([0.0, 1.0, -1.0], count) * np.exp2(rng.integers(-90, -50, count)))
        return a, b, c
    if family == "cancel":
        a, b = f32(spread(-20, 20)), f32(spread(-20, 20))
        c = f32(-(a.astype(np.float64) * b)) + f32(spread(-70, -40) * (rng.random(count) < 0.5))
        return a, b, f32(c)
    if family == "subnormal":
        a, b = f32(spread(-75, -60)), f32(spread(-75, -60))
        c = f32(rng.standard_normal(count) * 2.0 ** -140 * (rng.random(count) < 0.7))
        return a, b, c
    sign = rng.choice([-1.0, 1.0], (3, count))
    return (f32(sign[0] * 1e19 * rng.choice([1.0, 0.5, 3.0], count)), f32(sign[1] * 1e19),
            f32(sign[2] * rng.choice([0.0, 1e19, 1e38, 3e38], count)))


@pytest.mark.parametrize("family", ["random", "halfway", "cancel", "subnormal", "huge"])
def test_fmaf_ref_is_correctly_rounded(family):
    """``fmaf_ref`` equals the exact product-and-sum (``fractions.Fraction``)
    rounded to float32 half to even, in every bit, on each case."""
    a, b, c = _fma_triples(family)
    got = tref.fmaf_ref(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    assert got.dtype == torch.float32
    got = got.numpy()
    want = np.empty_like(got)
    for idx, (x, y, z) in enumerate(zip(a.tolist(), b.tolist(), c.tolist())):
        prod = math.copysign(0.0, x) * math.copysign(0.0, y) if x * y == 0 else x * y
        zero_sign = -1.0 if (math.copysign(1, prod) < 0 and math.copysign(1, z) < 0
                             and prod == 0 and z == 0) else 1.0
        want[idx] = _round_f32(Fraction(x) * Fraction(y) + Fraction(z), zero_sign)
    if family == "subnormal":
        assert (np.abs(want[want != 0]) < np.finfo(np.float32).tiny).any()
    if family == "huge":
        assert np.isinf(want).any() and np.isfinite(want).any()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _decisive(d) -> np.ndarray:
    """Rows whose best distance beats the runner-up by more than the
    rounding band of the matmul identity (the conformance suite's rule)."""
    d = np.sort(np.asarray(d, np.float64), axis=1)
    if d.shape[1] < 2:
        return np.ones(d.shape[0], bool)
    return (d[:, 1] - d[:, 0]) > 1e-3 * np.maximum(d[:, 0], 1.0)


@pytest.mark.parametrize("jmode,q,n,length", [
    ("interpret", 1, 1, 1), ("interpret", 1, 100, 128), ("interpret", 8, 129, 33),
    ("interpret", 5, 77, 48), ("ref", 5, 77, 48)])
def test_fma_refs_match_the_reference_kernels(jmode, q, n, length):
    """``ed_matrix_fma_ref`` and ``ed_min_fma_ref`` against the JAX package's
    ``ed_matrix`` and ``ed_min`` (the Pallas bodies on the interpreter) and
    against the direct-form plain version: within the float32 tolerance,
    argmins equal on decisive rows; the fma reference's minimum is its own
    matrix's row minimum, bit for bit."""
    qa, sa = qs(4, q, n, length)
    mat = tref.ed_matrix_fma_ref(t(qa), t(sa))
    assert mat.dtype == torch.float32 and mat.shape == (q, n)
    assert_close(mat, jops.ed_matrix(jnp.asarray(qa), jnp.asarray(sa), mode=jmode))
    assert_close(mat, tref.ed_matrix_ref(t(qa), t(sa)))
    dmin, amin = tref.ed_min_fma_ref(t(qa), t(sa))
    assert dmin.dtype == torch.float32 and amin.dtype == torch.int32
    want_d, want_a = jops.ed_min(jnp.asarray(qa), jnp.asarray(sa), mode=jmode)
    assert_close(dmin, want_d)
    dec = _decisive(mat)
    np.testing.assert_array_equal(amin.numpy()[dec], np.asarray(want_a)[dec])
    ref_d, ref_a = tref.ed_min_ref(t(qa), t(sa))
    assert_close(dmin, ref_d)
    np.testing.assert_array_equal(amin.numpy()[dec], ref_a.numpy()[dec])
    assert torch.equal(dmin, mat.min(dim=1).values + 0.0)


def test_fma_ref_bf16_series_widen_exactly():
    """bf16 series enter the chains as their exact float32 widening."""
    qa, sa = qs(9, 3, 40, 24)
    sb = t(sa).to(torch.bfloat16)
    assert torch.equal(tref.ed_matrix_fma_ref(t(qa), sb),
                       tref.ed_matrix_fma_ref(t(qa), sb.to(torch.float32)))
    want = jops.ed_matrix(jnp.asarray(qa), jnp.asarray(sa).astype(jnp.bfloat16),
                          mode="interpret")
    assert_close(tref.ed_matrix_fma_ref(t(qa), sb), want, "bfloat16")


def test_fma_ref_is_one_fmaf_chain():
    """One output spelled out: the dot product and both norms are fmaf
    chains over k ascending from +0.0, and the distance is
    (qn + sn) - 2 acc in float32."""
    qa, sa = qs(10, 2, 3, 17, scale=3.0)
    q, s = t(qa), t(sa)
    for i in range(2):
        for j in range(3):
            acc = qn = sn = torch.zeros((), dtype=torch.float32)
            for k in range(17):
                acc = tref.fmaf_ref(q[i, k], s[j, k], acc)
                qn = tref.fmaf_ref(q[i, k], q[i, k], qn)
                sn = tref.fmaf_ref(s[j, k], s[j, k], sn)
            want = (qn + sn) - 2.0 * acc
            assert torch.equal(tref.ed_matrix_fma_ref(q, s)[i, j], want)


def test_fma_refs_block_the_series_axis(monkeypatch):
    """Row blocking of the fma references changes no bit, and the running
    minimum across blocks keeps the lowest index of a tie."""
    qa, sa = qs(11, 4, 50, 32)
    sa[37] = sa[3]                         # equal rows in different blocks
    full = tref.ed_matrix_fma_ref(t(qa), t(sa))
    dmin, amin = tref.ed_min_fma_ref(t(qa), t(sa), valid_n=45)
    monkeypatch.setattr(tref, "_FMA_BLOCK_ELEMS", 4 * 7)
    assert torch.equal(tref.ed_matrix_fma_ref(t(qa), t(sa)), full)
    got_d, got_a = tref.ed_min_fma_ref(t(qa), t(sa), valid_n=45)
    assert torch.equal(got_d, dmin) and torch.equal(got_a, amin)
    qa[1] = sa[3]                          # query 1's nearest rows: 3 and 37
    got_d, got_a = tref.ed_min_fma_ref(t(qa), t(sa))
    assert int(got_a[1]) == 3


def test_ed_min_fma_ref_valid_n_masks_like_the_pallas_kernel():
    qa, sa = qs(5, 8, 128, 128)
    sa[100:] = qa[0]                      # masked rows would win if live
    want_d, want_a = jed.ed_min(jnp.asarray(qa), jnp.asarray(sa), bq=8, bn=128,
                                bk=128, valid_n=100, interpret=True)
    dmin, amin = tref.ed_min_fma_ref(t(qa), t(sa), valid_n=100)
    np.testing.assert_array_equal(amin.numpy(), np.asarray(want_a))
    assert int(amin.max()) < 100
    assert_close(dmin, want_d)
    dmin, amin = tref.ed_min_fma_ref(t(qa), t(sa), valid_n=0)
    assert bool(torch.isinf(dmin).all()) and bool((amin == 0).all())


def test_ed_min_fma_ref_ties_go_to_the_lowest_index():
    qa, sa = np.zeros((4, 16), np.float32), np.ones((11, 16), np.float32)
    want_d, want_a = jops.ed_min(jnp.asarray(qa), jnp.asarray(sa), mode="interpret")
    dmin, amin = tref.ed_min_fma_ref(t(qa), t(sa))
    np.testing.assert_array_equal(amin.numpy(), np.asarray(want_a))
    assert bool((amin == 0).all()) and bool((dmin == 16).all())
    assert_close(dmin, want_d)
    # -0.0 and +0.0 tie: a zero distance reported as +0.0 at the first row
    qz = np.ones((1, 4), np.float32)
    dmin, amin = tref.ed_min_fma_ref(t(qz), t(np.ones((3, 4), np.float32)))
    assert int(amin[0]) == 0 and float(dmin[0]) == 0.0 and not torch.signbit(dmin[0])


def test_ed_min_fma_ref_all_inf_row_reports_index_zero():
    qa = np.full((2, 16), 2.0e19, np.float32)
    sa = np.full((5, 16), -2.0e19, np.float32)
    want_d, want_a = jops.ed_min(jnp.asarray(qa), jnp.asarray(sa), mode="interpret")
    dmin, amin = tref.ed_min_fma_ref(t(qa), t(sa))
    assert bool(torch.isinf(dmin).all())
    np.testing.assert_array_equal(dmin.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(amin.numpy(), np.asarray(want_a))
