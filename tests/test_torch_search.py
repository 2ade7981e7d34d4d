"""Port vs reference: exact and approximate kNN over a JAX-built index.

The JAX package builds and saves the index; the port loads the same arrays
(``HerculesIndex.load`` / ``from_arrays``), so query faults and build faults
stay apart. Both answer the same numpy queries.

What must agree: ``positions``, ``ids``, ``path``, ``accessed``,
``eapca_pr``, ``sax_pr`` and ``visited_leaves`` exactly; ``dists`` within
``atol=1e-4`` (the two packages sum a row's squared differences in another
order; the measured gap is a few 1e-6).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search as JSr
from repro.core.index import HerculesIndex as JIndex
from repro.core.index import IndexConfig as JIndexConfig
from repro.core.search import SearchConfig as JSearchConfig
from repro.core.tree import BuildConfig as JBuildConfig
from repro_torch.core import search as TSr
from repro_torch.core.index import HerculesIndex, IndexConfig
from repro_torch.core.search import SearchConfig, validate_runtime_config
from repro_torch.core.tree import BuildConfig

FIELDS_EXACT = ("positions", "ids", "path", "accessed", "eapca_pr", "sax_pr",
                "visited_leaves")


def walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=1)
    return ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)).astype(np.float32)


def workload(data, seed, num=12, ood=4):
    rng = np.random.default_rng(seed)
    q = data[rng.integers(0, data.shape[0], num)] + \
        rng.standard_normal((num, data.shape[1])) * np.sqrt(0.05)
    return np.concatenate([q.astype(np.float32), walks(seed + 100, ood, data.shape[1])])


def jax_index(data, tmp_path, name):
    cfg = JIndexConfig(build=JBuildConfig(leaf_capacity=64),
                       search=JSearchConfig(chunk=128, scan_block=256, kernel_mode="ref"))
    idx = JIndex.build(jnp.asarray(data), cfg)
    path = str(tmp_path / f"{name}.npz")
    idx.save(path)
    return idx, HerculesIndex.load(path, device="cpu")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    data = walks(0, 2048, 64)
    jidx, tidx = jax_index(data, tmp_path_factory.mktemp("idx"), "walks")
    return data, workload(data, 9), jidx, tidx


def compare(jres, tres):
    for f in FIELDS_EXACT:
        np.testing.assert_array_equal(getattr(tres, f).numpy(), np.asarray(getattr(jres, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tres.dists.numpy(), np.asarray(jres.dists), rtol=0, atol=1e-4)


def run_both(jidx, tidx, q, **over):
    jc = dataclasses.replace(jidx.config.search, **over)
    tc = dataclasses.replace(tidx.config.search, **over)
    jres = JSr.exact_knn(jidx.tree, jidx.layout, jnp.asarray(q), jc, jidx.max_depth)
    tres = TSr.exact_knn(tidx.tree, tidx.layout, torch.from_numpy(q), tc, tidx.max_depth)
    return jres, tres


@pytest.mark.parametrize("k,refine_select", [(1, "argsort"), (5, "argsort"), (5, "topk")])
def test_exact_knn_matches_reference(pair, k, refine_select):
    _, q, jidx, tidx = pair
    compare(*run_both(jidx, tidx, q, k=k, refine_select=refine_select))


@pytest.mark.parametrize("over", [
    dict(use_sax=False, l_max=2, chunk=64), dict(adaptive=False), dict(force_scan=True),
    dict(eapca_th=0.99),                      # every query takes scan path 0
    dict(eapca_th=0.0, sax_th=1.1),           # scan path 1
    dict(refine_select="topk", topk_budget_chunks=1, adaptive=False),  # budget runs out
], ids=["nosax", "nothresh", "forced", "scan0", "scan1", "topk_exhausted"])
def test_exact_knn_ablations_match_reference(pair, over):
    _, q, jidx, tidx = pair
    jres, tres = run_both(jidx, tidx, q, k=5, **over)
    compare(jres, tres)
    if "eapca_th" in over:
        assert set(tres.path.tolist()) == ({0} if over["eapca_th"] > 0.5 else {1})


def test_topk_budget_fallback_is_exercised(pair):
    """With a one-chunk budget the ood queries run out of candidates and
    finish with the dense scan; answers still match the full scan."""
    data, q, _, tidx = pair
    cfg = dataclasses.replace(tidx.config.search, k=5, refine_select="topk",
                              topk_budget_chunks=1, adaptive=False)
    res = TSr.exact_knn(tidx.tree, tidx.layout, torch.from_numpy(q), cfg, tidx.max_depth)
    assert int(res.accessed.max()) > data.shape[0]     # refine + scan fallback
    d, idx = TSr.brute_force_knn(torch.from_numpy(data), torch.from_numpy(q), 5)
    np.testing.assert_array_equal(res.ids.numpy(), idx.numpy())


def test_approx_knn_matches_reference(pair):
    _, q, jidx, tidx = pair
    cfg = dataclasses.replace(jidx.config.search, k=3, l_max=4)
    jd, jids = JSr.approx_knn(jidx.tree, jidx.layout, jnp.asarray(q), cfg, jidx.max_depth)
    td, tids = tidx.knn_approx(q, k=3, l_max=4)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-4)


def test_exact_ties_resolve_like_the_reference(tmp_path):
    """Every series twice: distances tie exactly, and the tie order (lowest
    position first) must match ``lax.top_k``/``argsort`` -- in the leaf
    visits, the refinement order and the running top-k merge."""
    base = walks(1, 700, 64)
    data = np.concatenate([base, base])
    jidx, tidx = jax_index(data, tmp_path, "dup")
    q = workload(data, 11, num=8, ood=2)
    for over in (dict(k=4, eapca_th=0.99),            # phase 1 + the dense scan
                 dict(k=3, adaptive=False, refine_select="topk")):
        compare(*run_both(jidx, tidx, q, **over))


def test_merge_topk_matches_reference():
    d0 = np.array([1.0, 2.0, np.inf], np.float32)
    p0 = np.array([7, 3, -1], np.int32)
    d1 = np.array([2.0, 1.0, 0.5, 2.0], np.float32)
    p1 = np.array([8, 7, 9, 1], np.int32)             # 7 is already present
    jd, jp = JSr._merge_topk(jnp.asarray(d0), jnp.asarray(p0), jnp.asarray(d1),
                             jnp.asarray(p1), 3)
    td, tp = TSr._merge_topk(*map(torch.from_numpy, (d0, p0, d1, p1)), 3)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_own_build_answers_equal_brute_force():
    data = walks(2, 3000, 64)
    q = workload(data, 12)
    cfg = IndexConfig(build=BuildConfig(leaf_capacity=100),
                      search=SearchConfig(chunk=128, scan_block=512))
    idx = HerculesIndex.build(data, cfg, device="cpu")
    for k in (1, 7):
        res = idx.knn(q, k=k)
        d, ids = TSr.brute_force_knn(torch.from_numpy(data), torch.from_numpy(q), k)
        np.testing.assert_array_equal(res.ids.numpy(), ids.numpy())
        np.testing.assert_allclose(res.dists.numpy(), d.numpy(), rtol=1e-4, atol=1e-4)
        pd, pp = TSr.pscan_knn(torch.from_numpy(data), torch.from_numpy(q), k, block=700)
        np.testing.assert_array_equal(pp.numpy(), ids.numpy())
    assert idx.stats()["total_in_leaves"] == 3000
    with pytest.raises(ValueError):
        HerculesIndex.build(data[:, :60], cfg, device="cpu")


def test_from_arrays_maps_reference_kernel_modes(pair, tmp_path):
    data, q, jidx, _ = pair
    jidx = JIndex(jidx.tree, jidx.layout, dataclasses.replace(
        jidx.config, search=dataclasses.replace(jidx.config.search, kernel_mode="pallas")),
        jidx.max_depth)
    path = str(tmp_path / "pallas.npz")
    jidx.save(path)
    with np.load(path) as z:
        import json
        meta = json.loads(str(z["__meta__"]))
        arrays = {key: z[key] for key in z.files if key != "__meta__"}
    tidx = HerculesIndex.from_arrays(arrays, meta, device="cpu")
    assert tidx.config.search.kernel_mode == "auto"
    assert tidx.layout.lrd.dtype == torch.float32 and tidx.tree.is_leaf.dtype == torch.bool
    assert tidx.stats() == jidx.stats()


def test_search_config_validation_matches_reference():
    for bad in (dict(k=0), dict(l_max=True), dict(eapca_th=float("nan")),
                dict(lb_slack=1.0), dict(use_sax=1), dict(refine_select="heap"),
                dict(kernel_mode="pallas"), dict(prefetch="async"), dict(codec="zip")):
        with pytest.raises(ValueError):
            SearchConfig(**bad)
    assert SearchConfig(codec="sax-residual", prefetch="thread").pad_multiple() == 4096
    with pytest.raises(ValueError, match="does not divide"):
        validate_runtime_config(SearchConfig(chunk=100), 4096)
    assert {f.name for f in dataclasses.fields(SearchConfig)} == \
        {f.name for f in dataclasses.fields(JSearchConfig)}
