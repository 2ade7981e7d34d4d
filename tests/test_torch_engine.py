"""The port's query engine, entry points and package isolation.

On the CPU every backend takes the plain arithmetic: ``local`` and ``scan``
answer with bit-identical distances (the same difference-form sums), and
``scan-mxu`` (matmul identity, float32) with the same ids and distances
within ``rtol=atol=1e-4``. The JAX package's engine is the reference for
ids.
"""
import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import make_backend as jax_make_backend
from repro.core.search import SearchConfig as JSearchConfig
from repro_torch.core import engine as E
from repro_torch.core.index import HerculesIndex, IndexConfig
from repro_torch.core.search import SearchConfig
from repro_torch.core.tree import BuildConfig
from repro_torch.data import synthetic
from repro_torch.launch import search as cli
from _torch_threads import one_torch_thread  # noqa: F401

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=1)
    return ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    data = walks(0, 2048, 64)
    rng = np.random.default_rng(5)
    q = (data[rng.integers(0, 2048, 10)]
         + rng.standard_normal((10, 64)) * np.sqrt(0.05)).astype(np.float32)
    q = np.concatenate([q, walks(6, 3, 64)])
    icfg = IndexConfig(build=BuildConfig(leaf_capacity=64),
                       search=SearchConfig(chunk=128, scan_block=256))
    backends = {name: E.make_backend(name, data, index_config=icfg, device="cpu")
                for name in E.backend_names("memory")}
    return data, q, icfg, backends


@pytest.mark.parametrize("k", [1, 5])
def test_backends_agree(setup, k):
    data, q, _, backends = setup
    res = {name: E.QueryEngine(b).knn(q, k=k) for name, b in backends.items()}
    assert torch.equal(res["local"].ids, res["scan"].ids.to(res["local"].ids.dtype))
    assert torch.equal(res["local"].dists, res["scan"].dists)
    assert torch.equal(res["scan-mxu"].ids.long(), res["scan"].ids.long())
    np.testing.assert_allclose(res["scan-mxu"].dists.numpy(), res["scan"].dists.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert set(res["scan"].path.tolist()) == {3}
    # the reference's scan backend finds the same neighbours
    jres = jax_make_backend("scan", jnp.asarray(data), search=JSearchConfig(
        scan_block=256, kernel_mode="ref")).knn(jnp.asarray(q), k=k)
    np.testing.assert_array_equal(res["local"].ids.numpy(), np.asarray(jres.ids))


def test_bucketing_and_plan_cache(setup):
    _, q, _, backends = setup
    eng = E.QueryEngine(backends["local"], E.EngineConfig(plan_cache_size=2))
    eng.knn(q[:3])            # bucket 4, k=1: miss
    eng.knn(q[:4])            # bucket 4, k=1: hit
    eng.knn(q[:5])            # bucket 8: miss
    eng.knn(q[:3], k=2)       # new cfg: miss, evicts the oldest
    eng.knn(q[:3])            # evicted: miss again
    t = eng.telemetry()
    assert (t.plan_cache.hits, t.plan_cache.misses, t.plan_cache.evictions) == (1, 4, 2)
    assert t.plan_cache.size == 2 and t.calls == 5 and t.queries == 18
    assert t.ooc is None and t.dist is None
    assert sum(dataclasses.astuple(t.paths)) == 18
    assert 0.0 <= t.pruning.eapca_mean <= 1.0 and t.latency.total > 0
    eng2 = E.QueryEngine(backends["local"], E.EngineConfig(bucket_sizes=(6, 16)))
    eng2.knn(q[:2])
    eng2.knn(q[:13])
    assert [p["bucket"] for p in eng2.describe()["engine"]["cached_plans"]] == [6, 16]


def test_valid_rows_and_padding(setup):
    _, q, _, backends = setup
    eng = E.QueryEngine(backends["local"])
    full = eng.knn(q[:6], k=3)
    padded = np.concatenate([q[:4], np.zeros((4, 64), np.float32)])
    part = eng.knn(padded, k=3, valid_rows=4)
    assert part.dists.shape == (4, 3)
    assert torch.equal(part.ids, full.ids[:4])
    one = eng.knn(q[0], k=3)
    assert torch.equal(one.ids, full.ids[:1])
    with pytest.raises(ValueError, match="valid_rows"):
        eng.knn(q[:2], valid_rows=3)


def test_query_length_error(setup):
    _, _, _, backends = setup
    for b in backends.values():
        with pytest.raises(ValueError, match="query length"):
            E.QueryEngine(b).knn(np.zeros((2, 32), np.float32))


@pytest.mark.parametrize("k", [1, 4])
def test_kernel_scan_ref_equals_dense_scan(setup, k):
    data, q, _, _ = setup
    x, qq = torch.from_numpy(data[:1000]), torch.from_numpy(q)
    kd, kp = E.kernel_scan_knn(x, qq, k=k, block=256, mode="ref")
    dd, dp = E.dense_scan_knn(x, qq, k=k, block=256)
    assert torch.equal(kp, dp) and torch.equal(kd, dd)


def test_scan_backend_arithmetic_selection(setup):
    data, q, _, backends = setup
    qq = torch.from_numpy(q)
    scan = backends["scan"]
    r_ref = scan.knn(q, k=3, kernel_mode="ref")
    assert torch.equal(r_ref.dists, scan.knn(q, k=3).dists)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        scan.knn(q, k=3, kernel_mode="cuda")
    assert backends["scan-mxu"].describe()["mxu"] is True
    d, p = E.dense_scan_knn(torch.from_numpy(data[:3]), qq, k=5)
    assert bool((p[:, 3:] == -1).all()) and bool(torch.isinf(d[:, 3:]).all())
    with pytest.raises(ValueError, match="unknown backend"):
        E.make_backend("sharded", data, device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = walks(1, 64, 16)
    for call in (lambda: E.make_backend("scan", x),
                 lambda: E.make_backend("local", x),
                 lambda: HerculesIndex.build(x),
                 lambda: synthetic.random_walks(4, 16),
                 lambda: cli.main(["--num-series", "64", "--length", "16"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError):
        E.make_backend("scan", x, device="mps")


def test_synthetic_generators():
    a = synthetic.random_walks(50, 32, seed=3, device="cpu")
    b = synthetic.random_walks(50, 32, seed=3, device="cpu")
    assert a.shape == (50, 32) and a.dtype == torch.float32 and torch.equal(a, b)
    torch.testing.assert_close(a.mean(1), torch.zeros(50), atol=1e-5, rtol=0)
    torch.testing.assert_close(a.std(1, correction=0), torch.ones(50), atol=1e-4, rtol=0)
    q = synthetic.make_query_workload(a, 7, "5%", seed=4)
    assert q.shape == (7, 32)
    assert synthetic.make_query_workload(a, 3, "ood").shape == (3, 32)
    with pytest.raises(ValueError):
        synthetic.make_query_workload(a, 3, "50%")


def test_cli_runs_on_cpu_and_verifies(capsys):
    cli.main(["--num-series", "3000", "--length", "64", "--queries", "5", "--k", "2",
              "--leaf-size", "100", "--device", "cpu", "--verify"])
    out = capsys.readouterr().out
    assert "exact match: True" in out and "5 x 2-NN" in out


def test_port_never_imports_jax_or_the_reference_package():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(PORT)}:{node.lineno} {name}")
    assert len(list(PORT.rglob("*.py"))) > 10
    assert not offenders, offenders
