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


# ---- the v2 kernels' plan and schedules (csrc/dtw.cu) ----

def test_plan_takes_v1_exactly_past_the_largest_instance():
    for n in (1, 9, 33, 34, 256):
        for band in range(0, 45):
            variant, lanes = kdtw._plan(4096, n, band)
            wide = min(band, n - 1) > kdtw.ROW_BANDS[-1]
            assert (variant == "v1") == wide, (n, band)
            assert lanes == 1 if wide else lanes in (1, *kdtw.LANES)
    assert kdtw._plan(16 * 256, 256, 255) == ("v1", 1)
    assert kdtw._plan(16 * 256, 256, 32) == ("v2", 1)           # past the lanes' 31


def test_plan_lanes_follow_the_pair_count():
    assert kdtw._plan(1 << 22, 256, 13) == ("v2", 1)            # the brute force
    assert kdtw._plan(kdtw.LANE_PAIRS, 256, 13) == ("v2", 1)
    assert kdtw._plan(kdtw.LANE_PAIRS - 1, 256, 13) == ("v2", 16)
    assert kdtw._plan(16 * 256, 256, 13) == ("v2", 16)          # a dtw_knn round
    assert kdtw._plan(4 * 256, 256, 13) == ("v2", 32)           # a late round
    assert kdtw._plan(kdtw.WIDE_LANE_PAIRS, 256, 13) == ("v2", 32)
    assert kdtw._plan(kdtw.WIDE_LANE_PAIRS + 1, 256, 13) == ("v2", 16)
    assert kdtw._plan(1, 256, 1) == ("v2", 32)
    assert kdtw._plan(4096, 256, 0) == ("v2", 1)                 # a one-cell band
    assert kdtw._plan(4096, 1, 13) == ("v2", 1)                  # clamped to band 0
    assert kdtw._plan(16 * 256, 256, 31) == ("v2", 16)
    for pairs in range(1, kdtw.LANE_PAIRS, 997):
        assert kdtw._plan(pairs, 256, 13)[1] in (16, 32)


def _cells(band, lanes):
    """Cells a thread of the instance ``dtw_band_v2_f32`` launches."""
    w = 2 * band + 1
    if lanes == 1:
        return 2 * next(b for b in kdtw.ROW_BANDS if band <= b) + 1
    return (32 if w <= 32 else 64) // lanes


def emulate_rows(q, c, band, S):
    """``dtw_rows_kernel<S>`` step for step, every pair at once (float32
    numpy): the band right-aligned in S cells, each row entered at
    ``start`` with ``left`` read from the cell before (never computed left
    of ``start``), the candidate window shifted by the computed cells, the
    last band rows masked past column n - 1."""
    f32 = np.float32
    num, n = c.shape
    w = 2 * band + 1
    base = S - w
    D = np.full((num, S), BIG, f32)
    D[:, base + band] = 0.0
    cw = np.zeros((num, S), f32)
    for s in range(S):
        j = max(0, s - base - band)
        cw[:, s] = c[:, j] if j < n else 0.0
    a = q[0]
    for i in range(n):
        jn = i + 1 + band
        nxt = c[:, jn] if jn < n else np.zeros(num, f32)
        an = q[i + 1] if i + 1 < n else f32(0.0)
        start = base + max(0, band - i)
        mask, hi = i + band >= n, base + n - 1 - i + band
        for s in range(start, S):
            up = D[:, s + 1] if s + 1 < S else np.full(num, BIG, f32)
            left = D[:, s - 1] if s > 0 else np.full(num, BIG, f32)
            d = cw[:, s] - a
            cur = d * d + np.minimum(np.minimum(D[:, s], up), left)
            if mask and s > hi:
                cur = np.full(num, BIG, f32)
            D[:, s] = cur
            cw[:, s] = cw[:, s + 1] if s + 1 < S else nxt
        a = an
        outside = [s for s in range(S) if s < base or not 0 <= i - band + s - base < n]
        assert (D[:, outside] == BIG).all(), f"row {i}: a cell outside holds a value"
    return D[:, base + band].copy()


def emulate_lanes(q, c, band, S, G):
    """``dtw_lanes_kernel<S, G>`` step for step: every lane of every group in
    lockstep (float32 numpy, vectorised over groups). Lane g holds band
    cells [g S, g S + S) of two pairs, 2 grp + (g & 1) on phase 0 and the
    other on phase 1; at step k it takes row k - g // 2 - (g & 1) of the
    first and row k - g // 2 of the second; left and up come from the
    neighbours' cells published on the phase before."""
    f32 = np.float32
    num, n = c.shape
    w = 2 * band + 1
    groups = (num + 1) // 2
    grp = np.arange(groups)
    pairs = [[np.minimum(2 * grp + (g & 1), num - 1), np.minimum(2 * grp + 1 - (g & 1), num - 1)]
             for g in range(G)]
    init = np.array([0.0 if g * S + s == band else BIG for g in range(G) for s in range(S)],
                    f32).reshape(G, S)
    D = [np.broadcast_to(init[None, :, :], (groups, G, S)).copy() for _ in range(2)]
    cn = [np.zeros((groups, G, S), f32) for _ in range(2)]
    an = [np.zeros((groups, G), f32) for _ in range(2)]
    pub_first, pub_last = D[0][:, :, 0].copy(), D[0][:, :, S - 1].copy()

    def phase(ph, rows):
        nonlocal pub_first, pub_last
        big = np.full(groups, BIG, f32)
        left_in = [big if g == 0 else pub_last[:, g - 1] for g in range(G)]
        up_in = [big if g == G - 1 else pub_first[:, g + 1] for g in range(G)]
        for g in range(G):
            i, o0, dd = rows[g], g * S, D[ph][:, g]
            crow = c[pairs[g][ph]]
            j0 = i - band + o0
            if 0 <= i < n:
                left = left_in[g]
                for s in range(S):
                    j = j0 + s
                    live = o0 + s < w and 0 <= j < n
                    up = dd[:, s + 1] if s + 1 < S else up_in[g]
                    d = cn[ph][:, g, s] - an[ph][:, g]
                    cur = d * d + np.minimum(np.minimum(dd[:, s], up), left)
                    dd[:, s] = cur if live else BIG
                    left = dd[:, s].copy()
                    assert live or (dd[:, s] == BIG).all()
            if 0 <= i + 1 < n:
                an[ph][:, g] = q[i + 1]
                for s in range(S):
                    j = j0 + 1 + s
                    ok = o0 + s < w and 0 <= j < n
                    cn[ph][:, g, s] = crow[:, j] if ok else 0.0
        pub_first, pub_last = D[ph][:, :, 0].copy(), D[ph][:, :, S - 1].copy()

    h = [g >> 1 for g in range(G)]
    phase(0, [-h[g] - (g & 1) - 1 for g in range(G)])
    phase(1, [-h[g] - 1 for g in range(G)])
    pub_first, pub_last = D[0][:, :, 0].copy(), D[0][:, :, S - 1].copy()
    for k in range(n + G // 2):
        phase(0, [k - h[g] - (g & 1) for g in range(G)])
        phase(1, [k - h[g] for g in range(G)])
    out = np.empty(num, f32)
    g = band // S
    for ph in range(2):
        p = 2 * grp + ((g & 1) if ph == 0 else 1 - (g & 1))
        ok = p < num
        out[p[ok]] = D[ph][ok, g, band - g * S]
    return out


@pytest.mark.parametrize("n,band,lanes", [
    (1, 0, 1), (1, 0, 32), (12, 0, 1), (12, 0, 16), (17, 5, 1), (17, 5, 32),
    (37, 13, 1), (37, 13, 16), (37, 13, 32), (9, 20, 1), (9, 20, 16), (20, 8, 1),
    (20, 9, 1), (40, 16, 1), (40, 17, 1), (40, 32, 1), (24, 15, 16), (24, 15, 32),
    (24, 16, 16), (24, 16, 32), (33, 31, 16), (33, 31, 32), (5, 13, 16)])
def test_v2_schedule_emulation_equals_plain_bitwise(rng, n, band, lanes):
    """Both v2 kernels' schedules (which lane owns which band cells, the
    step each cell is written at, where it reads diag, up and left, the
    candidate window), emulated in float32 numpy, equal ``dtw_band_ref``
    bit for bit, every cell outside the band or the matrix exactly 3.0e38
    after each row: band 0, bands past n - 1 (clamped as the kernel does), n <
    W, n not a multiple of anything, each instance's edge band, each lane
    count, an odd pair count (a group's second pair past the end)."""
    q = rng.normal(size=n).astype(np.float32)
    c = (rng.normal(size=(5, n)) * 2).astype(np.float32)
    b = min(band, n - 1)
    S = _cells(b, lanes)
    got = (emulate_rows(q, c, b, S) if lanes == 1
           else emulate_lanes(q, c, b, S, lanes))
    want = tref.dtw_band_ref(t(q), t(c), band).numpy()
    np.testing.assert_array_equal(words(got), words(want))


def test_plan_keeps_lane_blocks_in_shared_memory():
    """A lane block holds its 256 / lanes candidate rows and the query row
    in shared memory: long series take the other lane count, or one thread
    a pair."""
    assert kdtw._lane_smem(256, 32) == 4 * ((256 + 160) * 8 + 256 + 64)
    for n in (256, 2000, 4000, 8000):
        for pairs in (1024, 4096):
            variant, lanes = kdtw._plan(pairs, n, 13)
            assert variant == "v2"
            assert lanes == 1 or kdtw._lane_smem(n, lanes) <= kdtw._SMEM_MAX
    assert kdtw._plan(4096, 4000, 13) == ("v2", 32)             # 16 lanes do not fit
    assert kdtw._plan(4096, 8000, 13) == ("v2", 1)              # neither does
    assert all(kdtw._lane_smem(256, g) <= kdtw._SMEM_MAX for g in kdtw.LANES)
