"""Port vs reference: summaries (PAA, iSAX, EAPCA) and lower bounds.

The same numpy inputs, made from a seed, go through ``repro.core`` (JAX on
the CPU) and ``repro_torch.core`` (PyTorch on the CPU).

Tolerances and why:

* elementwise statistics computed from the *same* prefix sums: ``rtol=1e-5``
  (division and square root round alike; only XLA's operation fusion can
  move the last bit);
* statistics derived from each package's *own* prefix sums: ``atol=1e-4``.
  fp32 prefix sums accumulate in another order in XLA than in the port's
  doubling scan; XLA against a sequential ``torch.cumsum`` differs by up to
  3.05e-5 on 4096 x 256 z-normalized random walks;
* reductions over a few segments (PAA, LB_EAPCA, LB_SAX, squared ED):
  ``rtol=1e-5`` -- the port sums pairwise in a fixed order, XLA in its own;
* SAX breakpoints: within 2 ulp -- XLA evaluates ``ndtri`` in float32, the
  port in float64 rounded once to float32;
* iSAX codes: equal on the seeded data;
* the matmul-identity ``squared_ed_matrix``: ``rtol=atol=1e-4``, the
  conformance suite's float32 policy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lower_bounds as JLB
from repro.core import summaries as JS
from repro_torch.core import lower_bounds as TLB
from repro_torch.core import summaries as TS


def walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=1)
    return ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)).astype(np.float32)


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.fixture(scope="module")
def data():
    return walks(0, 4096, 64)


def test_znormalize(data):
    raw = np.random.default_rng(1).normal(3.0, 2.0, (64, 48)).astype(np.float32)
    np.testing.assert_allclose(np_(TS.znormalize(torch.from_numpy(raw))),
                               np_(JS.znormalize(jnp.asarray(raw))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [8, 16])
def test_paa(data, m):
    np.testing.assert_allclose(np_(TS.paa(torch.from_numpy(data), m)),
                               np_(JS.paa(jnp.asarray(data), m)), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        TS.paa(torch.zeros(2, 30), 16)


@pytest.mark.parametrize("alphabet", [4, 16, 64, 256])
def test_breakpoints_within_two_ulp(alphabet):
    got = np_(TS.sax_breakpoints(alphabet))
    want = np_(JS.sax_breakpoints(alphabet))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert ulps(got, want).max() <= 2
    assert np.all(np.diff(got) > 0)


def test_paa_bits_equal(data):
    # PAA sums each segment left to right, as XLA does on the CPU
    np.testing.assert_array_equal(np_(TS.paa(torch.from_numpy(data))),
                                  np_(JS.paa(jnp.asarray(data))))


@pytest.mark.parametrize("m,alphabet", [(16, 256), (8, 256), (16, 64), (16, 16)])
def test_isax_codes_equal(data, m, alphabet):
    """Codes are equal except where a PAA value lies between the two
    packages' copies of a breakpoint (they differ by up to 2 ulp): the one
    documented exception, shown here element by element."""
    got = np_(TS.isax(torch.from_numpy(data), m, alphabet))
    want = np_(JS.isax(jnp.asarray(data), m, alphabet))
    assert got.dtype == np.uint8
    paa = np_(JS.paa(jnp.asarray(data), m))
    bp_t = np_(TS.sax_breakpoints(alphabet))
    bp_j = np_(JS.sax_breakpoints(alphabet))
    lo, hi = np.minimum(bp_t, bp_j), np.maximum(bp_t, bp_j)
    for idx in np.argwhere(got != want):
        v = paa[tuple(idx)]
        assert np.any((lo <= v) & (v < hi)), f"code mismatch at {idx} not at a breakpoint"
        assert abs(int(got[tuple(idx)]) - int(want[tuple(idx)])) == 1
    assert (got != want).sum() <= 2
    # away from the breakpoints the codes agree on every element
    clear = ~np.any((lo[None, None] <= paa[..., None]) & (paa[..., None] < hi[None, None]),
                    axis=-1)
    np.testing.assert_array_equal(got[clear], want[clear])


@pytest.mark.parametrize("alphabet", [16, 256])
def test_isax_cell_bounds(alphabet):
    codes = np.arange(alphabet, dtype=np.uint8).reshape(-1, 1).repeat(3, 1)
    lo, hi = TS.isax_cell_bounds(torch.from_numpy(codes), alphabet)
    jlo, jhi = JS.isax_cell_bounds(jnp.asarray(codes), alphabet)
    assert ulps(np_(lo), np_(jlo)).max() <= 2 and ulps(np_(hi), np_(jhi)).max() <= 2
    # the same +-3e38 open ends
    assert np_(lo)[0, 0] == np.float32(-3e38) and np_(hi)[-1, 0] == np.float32(3e38)


def test_prefix_sums(data):
    p, p2 = TS.prefix_sums(torch.from_numpy(data))
    jp, jp2 = JS.prefix_sums(jnp.asarray(data))
    assert p.shape == (4096, 65) and bool((p[:, 0] == 0).all())
    np.testing.assert_allclose(np_(p), np_(jp), rtol=0, atol=1e-4)
    np.testing.assert_allclose(np_(p2), np_(jp2), rtol=1e-5, atol=1e-4)


def test_prefix_sums_are_shape_invariant(data):
    """Fixed-order arithmetic: a row's prefix sums do not depend on the
    batch it is computed in (the build's bit-exactness across devices and
    paths rests on this)."""
    x = torch.from_numpy(data)
    p, _ = TS.prefix_sums(x)
    p_part, _ = TS.prefix_sums(x[17:18])
    assert torch.equal(p[17:18], p_part)
    d = TLB.squared_ed(x[:100], x[5])
    assert torch.equal(d[7:8], TLB.squared_ed(x[7:8], x[5]))


def _endpoints(num, seed):
    rng = np.random.default_rng(seed)
    ep = np.full((num, 16), 64, np.int32)
    for i in range(num):
        k = rng.integers(1, 16)
        ep[i, :k] = np.sort(rng.choice(np.arange(1, 64), size=k, replace=False))
    return ep


def test_segment_stats_from_same_prefix(data):
    jp, jp2 = JS.prefix_sums(jnp.asarray(data))
    ep = _endpoints(data.shape[0], 2)
    tm, ts = TS.segment_stats_from_prefix(torch.from_numpy(np.array(jp)),
                                          torch.from_numpy(np.array(jp2)),
                                          torch.from_numpy(ep))
    jm, js = JS.segment_stats_from_prefix(jp, jp2, jnp.asarray(ep))
    np.testing.assert_allclose(np_(tm), np_(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(ts), np_(js), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("per_row", [False, True])
def test_eapca(data, per_row):
    ep = _endpoints(data.shape[0], 3) if per_row else \
        np.array([8, 16, 40, 64, 64, 64], np.int32)
    tm, ts = TS.eapca(torch.from_numpy(data), torch.from_numpy(ep))
    jm, js = JS.eapca(jnp.asarray(data), jnp.asarray(ep))
    np.testing.assert_allclose(np_(tm), np_(jm), rtol=0, atol=1e-4)
    # stds are compared as variances: the square root turns the prefix-sum
    # rounding of a near-zero variance (a one-point segment) into ~1e-3
    np.testing.assert_allclose(np_(ts) ** 2, np_(js) ** 2, rtol=0, atol=1e-4)


def test_segment_lengths_and_synopses(data):
    ep = _endpoints(8, 4)
    np.testing.assert_array_equal(np_(TS.segment_lengths(torch.from_numpy(ep))),
                                  np_(JS.segment_lengths(jnp.asarray(ep))))
    rng = np.random.default_rng(5)
    means, stds = rng.normal(size=(2, 50, 16)).astype(np.float32)
    syn = TS.synopsis_from_stats(torch.from_numpy(means), torch.from_numpy(stds))
    jsyn = JS.synopsis_from_stats(jnp.asarray(means), jnp.asarray(stds))
    np.testing.assert_array_equal(np_(syn), np_(jsyn))
    other = rng.normal(size=(16, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        np_(TS.merge_synopses(syn, torch.from_numpy(other))),
        np_(JS.merge_synopses(jsyn, jnp.asarray(other))))


def test_fixed_order_sum_odd_widths():
    x = torch.arange(1, 8, dtype=torch.float32).repeat(3, 1)   # width 7
    assert torch.equal(TS.fixed_order_sum(x), torch.full((3,), 28.0))
    assert TS.fixed_order_sum(torch.ones(2, 0)).shape == (2,)


# ---------------------------------------------------------------------------
# lower bounds
# ---------------------------------------------------------------------------

def test_lb_eapca_node_and_series():
    rng = np.random.default_rng(6)
    qm, qs = rng.normal(size=(2, 30, 16)).astype(np.float32)
    lo = rng.normal(size=(30, 16, 2)).astype(np.float32)
    syn = np.stack([lo[..., 0] - 1, lo[..., 0] + 1,
                    np.abs(lo[..., 1]), np.abs(lo[..., 1]) + 1], -1).astype(np.float32)
    lens = rng.integers(0, 9, (30, 16)).astype(np.float32)
    t = TLB.lb_eapca_node(*map(torch.from_numpy, (qm, qs, syn, lens)))
    j = JLB.lb_eapca_node(*map(jnp.asarray, (qm, qs, syn, lens)))
    np.testing.assert_allclose(np_(t), np_(j), rtol=1e-5, atol=1e-6)
    sm, ss = rng.normal(size=(2, 30, 16)).astype(np.float32)
    t = TLB.lb_eapca_series(*map(torch.from_numpy, (qm, qs, sm, ss, lens)))
    j = JLB.lb_eapca_series(*map(jnp.asarray, (qm, qs, sm, ss, lens)))
    np.testing.assert_allclose(np_(t), np_(j), rtol=1e-5, atol=1e-6)


def test_lb_sax_matches_and_lower_bounds(data):
    q = walks(7, 5, 64)
    codes = np.array(JS.isax(jnp.asarray(data[:300])))
    q_paa = np.array(JS.paa(jnp.asarray(q)))
    t = TLB.lb_sax(torch.from_numpy(q_paa)[:, None, :], torch.from_numpy(codes)[None], 64)
    j = JLB.lb_sax(jnp.asarray(q_paa)[:, None, :], jnp.asarray(codes)[None], 64)
    np.testing.assert_allclose(np_(t), np_(j), rtol=1e-5, atol=1e-6)
    # a true lower bound on the squared distance (no false dismissals)
    ed = np_(TLB.squared_ed(torch.from_numpy(q)[:, None, :],
                            torch.from_numpy(data[:300])[None]))
    assert np.all(np_(t) <= ed * (1 + 1e-5) + 1e-5)


def test_squared_ed_and_matrix(data):
    q = walks(8, 6, 64)
    t = TLB.squared_ed(torch.from_numpy(q)[:, None, :], torch.from_numpy(data[:500])[None])
    j = JLB.squared_ed(jnp.asarray(q)[:, None, :], jnp.asarray(data[:500])[None])
    np.testing.assert_allclose(np_(t), np_(j), rtol=1e-5, atol=1e-5)
    tm = TLB.squared_ed_matrix(torch.from_numpy(q), torch.from_numpy(data[:500]))
    jm = JLB.squared_ed_matrix(jnp.asarray(q), jnp.asarray(data[:500]))
    np.testing.assert_allclose(np_(tm), np_(jm), rtol=1e-4, atol=1e-4)
    assert bool((tm >= 0).all())
