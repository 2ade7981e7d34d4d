"""Port vs reference: banded DTW, LB_Keogh and exact DTW kNN
(``repro_torch/core/dtw.py`` against ``repro/core/dtw.py``).

The same numpy inputs go through both packages on the CPU, where the port's
``dtw_band`` runs its plain version ``kernels/ref.py::dtw_band_ref`` (the
card's kernel is held to it bit for bit in ``tests/test_torch_gpu.py``).

Tolerances: ``keogh_envelope`` equal (min/max are exact); ``lb_keogh``
within 1e-6 relative (the two packages sum a row in other orders);
``dtw_distance`` bit for bit equal to the reference at every band tried
(asked: ``rtol = 1e-5``; observed: equal, since every DP cell is one rounded
add of an exact minimum and the reference's row-0 cumulative sum runs left
to right on the CPU), and bit for bit a float32 numpy loop of the same
recurrence; ``dtw_knn`` positions equal and dists within 1e-5 of the
reference's, and bit for bit a brute-force ``dtw_band`` over every row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import BuildConfig as JBuildConfig
from repro.core import HerculesIndex as JIndex
from repro.core import IndexConfig as JIndexConfig
from repro.core import SearchConfig as JSearchConfig
from repro.core import dtw as JD
from repro.data import random_walks as j_random_walks
from repro_torch.core import dtw as TD
from repro_torch.core.index import HerculesIndex
from repro_torch.core.search import SearchConfig
from repro_torch.kernels import dtw as kdtw
from repro_torch.kernels import ref as tref
from _torch_threads import one_torch_thread  # noqa: F401

BIG = np.float32(3.0e38)


def loop_dtw32(a, b, band):
    """``tests/test_dtw.py::_ref_dtw``'s loop with float32 operations and the
    reference's sentinel: each cell ``c + min(...)``, ``c`` rounded first."""
    n = len(a)
    dd = np.full((n, n), BIG, np.float32)
    for i in range(n):
        for j in range(max(0, i - band), min(n, i + band + 1)):
            d = np.float32(b[j] - a[i])
            c = np.float32(d * d)
            prev = np.float32(0.0) if (i == 0 and j == 0) else min(
                dd[i - 1, j] if i else BIG,
                dd[i, j - 1] if j else BIG,
                dd[i - 1, j - 1] if (i and j) else BIG)
            dd[i, j] = np.float32(c + prev)
    return dd[-1, -1]


def words(x):
    return np.asarray(x, np.float32).view(np.int32)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n", [12, 64])
@pytest.mark.parametrize("band", [0, 1, 3, 7, 99])
def test_dtw_distance_equals_reference(rng, n, band):
    a = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=(5, n)).astype(np.float32)
    got = TD.dtw_distance(t(a), t(b), band).numpy()
    want = np.asarray(JD.dtw_distance(jnp.asarray(a), jnp.asarray(b), band))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(words(got), words(want))


@pytest.mark.parametrize("n,band", [(1, 0), (2, 1), (12, 0), (12, 3), (17, 5),
                                    (33, 13), (40, 39), (24, 100)])
def test_dtw_band_ref_equals_float32_loop(rng, n, band):
    a = rng.normal(size=n).astype(np.float32)
    b = (rng.normal(size=(4, n)) * 3).astype(np.float32)
    got = tref.dtw_band_ref(t(a), t(b), band).numpy()
    want = np.array([loop_dtw32(a, x, band) for x in b], np.float32)
    np.testing.assert_array_equal(words(got), words(want))


def test_dtw_band_per_query_candidates(rng):
    """(Q, n) queries against their own (Q, B, n) candidates: each row as
    the query alone; and the result shape of a batched (..., n) call."""
    q = rng.normal(size=(3, 20)).astype(np.float32)
    c = rng.normal(size=(3, 7, 20)).astype(np.float32)
    got = kdtw.dtw_band(t(q), t(c), 4).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], kdtw.dtw_band(t(q[i]), t(c[i]), 4).numpy())
    assert kdtw.dtw_band(t(q[0]), t(c), 4).shape == (3, 7)
    assert kdtw.dtw_band(t(q[0]), t(c[0, 0]), 4).shape == ()


def test_dtw_band_row_blocks_change_nothing(rng, monkeypatch):
    q = rng.normal(size=16).astype(np.float32)
    c = rng.normal(size=(50, 16)).astype(np.float32)
    whole = tref.dtw_band_ref(t(q), t(c), 3)
    monkeypatch.setattr(tref, "_DTW_BLOCK_ELEMS", 17 * 7)
    np.testing.assert_array_equal(tref.dtw_band_ref(t(q), t(c), 3).numpy(), whole.numpy())


def test_dtw_band_modes_and_errors(rng):
    q = t(rng.normal(size=8).astype(np.float32))
    c = t(rng.normal(size=(3, 8)).astype(np.float32))
    before = kdtw.dtw_band.launches
    np.testing.assert_array_equal(kdtw.dtw_band(q, c, 2, mode="ref").numpy(),
                                  kdtw.dtw_band(q, c, 2).numpy())
    assert kdtw.dtw_band.launches == before      # the CPU never launches
    with pytest.raises(ValueError, match="kernel_mode='cuda'"):
        kdtw.dtw_band(q, c, 2, mode="cuda")
    with pytest.raises(ValueError, match="band"):
        kdtw.dtw_band(q, c, -1)
    with pytest.raises(ValueError, match="expected"):
        kdtw.dtw_band(q, c[:, :5], 2)
    with pytest.raises(ValueError, match="expected"):
        kdtw.dtw_band(q.reshape(2, 4), c, 2)
    assert kdtw.dtw_band(q, c[:0], 2).shape == (0,)


def test_identical_series_zero_and_band_zero_is_euclidean(rng):
    a = rng.normal(size=10).astype(np.float32)
    assert float(TD.dtw_distance(t(a), t(a)[None], 3)[0]) == 0.0
    b = rng.normal(size=(3, 10)).astype(np.float32)
    np.testing.assert_allclose(TD.dtw_distance(t(a), t(b), 0).numpy(),
                               ((b - a) ** 2).sum(-1), rtol=1e-5)


@pytest.mark.parametrize("band", [0, 2, 5, 16])
def test_keogh_envelope_equals_reference(rng, band):
    q = rng.normal(size=(2, 16)).astype(np.float32)
    lo, hi = TD.keogh_envelope(t(q), band)
    jlo, jhi = JD.keogh_envelope(jnp.asarray(q), band)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert bool(((lo <= t(q)) & (t(q) <= hi)).all())


@pytest.mark.parametrize("band", [1, 3, 13])
def test_lb_keogh_matches_reference(rng, band, monkeypatch):
    q = rng.normal(size=32).astype(np.float32)
    s = rng.normal(size=(4, 25, 32)).astype(np.float32)
    got = TD.lb_keogh(t(q), t(s), band).numpy()
    want = np.asarray(JD.lb_keogh(jnp.asarray(q), jnp.asarray(s), band))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    monkeypatch.setattr(TD, "_ROW_CHUNK_ELEMS", 32 * 7)     # row blocks of 7
    np.testing.assert_array_equal(TD.lb_keogh(t(q), t(s), band).numpy(), got)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(0, 6))
def test_lb_keogh_lower_bounds_dtw(seed, band):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=12).astype(np.float32)
    b = rng.normal(size=(4, 12)).astype(np.float32)
    lb = TD.lb_keogh(t(a), t(b), band).numpy()
    dtw = TD.dtw_distance(t(a), t(b), band).numpy()
    assert (lb <= dtw + 1e-3).all()


@pytest.fixture(scope="module")
def dtw_pair(tmp_path_factory):
    """``tests/test_dtw.py::test_dtw_knn_exact``'s setup, its index carried
    across with ``idx.save`` -> ``HerculesIndex.load``."""
    data = j_random_walks(jax.random.PRNGKey(0), 300, 32)
    jidx = JIndex.build(data, JIndexConfig(
        build=JBuildConfig(leaf_capacity=64),
        search=JSearchConfig(k=3, chunk=64, scan_block=64, l_max=4)))
    path = str(tmp_path_factory.mktemp("dtw") / "idx.npz")
    jidx.save(path)
    q = np.asarray(data[:2] + 0.05)
    return np.asarray(data), q, jidx, HerculesIndex.load(path, device="cpu")


def brute_force(layout, q, k, band):
    """A stable top-k of a plain dtw_band over every real row, per query."""
    rows = layout.lrd[:layout.num_series]
    d = torch.stack([kdtw.dtw_band(qq, rows, band) for qq in q])
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


@pytest.mark.parametrize("k", [1, 2])
def test_dtw_knn_matches_reference(dtw_pair, k):
    data, q, jidx, tidx = dtw_pair
    cfg = SearchConfig(k=k, chunk=64, scan_block=64)
    d, p = TD.dtw_knn(tidx.layout, t(q), k=k, band=3, cfg=cfg)
    jd, jp = JD.dtw_knn(jidx.layout, jnp.asarray(q), k=k, band=3,
                        cfg=JSearchConfig(k=k, chunk=64, scan_block=64))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    bf_d, bf_p = brute_force(tidx.layout, t(q), k, 3)
    np.testing.assert_array_equal(words(d.numpy()), words(bf_d.numpy()))
    np.testing.assert_array_equal(p.numpy(), bf_p.numpy())
    # the reference test's own oracle: _ref_dtw over the original rows
    perm = tidx.layout.perm.numpy()
    for r in range(len(q)):
        want = np.sort([loop_dtw32(q[r], s, 3) for s in data])[:k]
        np.testing.assert_allclose(d[r].numpy(), want, rtol=1e-5)
        found = [loop_dtw32(q[r], data[perm[pos]], 3) for pos in p[r].numpy()]
        np.testing.assert_array_equal(words(found), words(d[r].numpy()))


@pytest.mark.parametrize("k,band,chunk", [(1, 0, 64), (3, 5, 64), (4, 2, 128), (5, 31, 64)])
def test_dtw_knn_equals_brute_force(dtw_pair, k, band, chunk):
    _, q, _, tidx = dtw_pair
    rng = np.random.default_rng(k + band)
    qs = np.concatenate([q, rng.normal(size=(2, q.shape[1])).astype(np.float32)])
    stats = {}
    d, p = TD.dtw_knn(tidx.layout, t(qs), k=k, band=band,
                      cfg=SearchConfig(k=k, chunk=chunk), stats=stats)
    bf_d, bf_p = brute_force(tidx.layout, t(qs), k, band)
    np.testing.assert_array_equal(words(d.numpy()), words(bf_d.numpy()))
    np.testing.assert_array_equal(p.numpy(), bf_p.numpy())
    n_chunks = tidx.layout.lrd.shape[0] // chunk
    assert 1 <= stats["rounds"] <= n_chunks
    assert len(qs) <= stats["chunks"] <= len(qs) * n_chunks
    assert stats["rows"] == stats["chunks"] * chunk


def test_dtw_knn_default_config_and_padding_error(dtw_pair):
    _, q, _, tidx = dtw_pair
    with pytest.raises(ValueError, match="layout padding must divide refinement chunk"):
        TD.dtw_knn(tidx.layout, t(q), k=1, band=2)        # chunk 256 vs n_pad 384
    with pytest.raises(ValueError, match="layout padding must divide refinement chunk"):
        TD.dtw_knn(tidx.layout, t(q), k=1, band=2, cfg=SearchConfig(k=1, chunk=80))
    d, p = TD.dtw_knn(tidx.layout, t(q[:0]), k=2, band=2, cfg=SearchConfig(k=2, chunk=64))
    assert d.shape == (0, 2) and p.shape == (0, 2) and p.dtype == torch.int32
