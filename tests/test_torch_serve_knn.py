"""The port's kNN serving (``KnnServeEngine`` and its CLI) against the
reference's (``tests/test_engine.py::TestKnnServeEngine`` mirrored).

The reference builds the index from a numpy-seeded collection and saves it;
the port loads the same arrays, so both serve the same tree. Answers are
held to brute force (``rtol = atol = 1e-3``, as the reference's tests hold
its own), and against the reference's ``KnnServeEngine`` on the same
requests: ids equal, distances within ``atol=1e-4``, the same waves.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import LocalBackend as JLocalBackend
from repro.core.engine import QueryEngine as JQueryEngine
from repro.core.index import HerculesIndex as JIndex
from repro.core.index import IndexConfig as JIndexConfig
from repro.core.search import SearchConfig as JSearchConfig
from repro.core.tree import BuildConfig as JBuildConfig
from repro.serve import KnnServeConfig as JKnnServeConfig
from repro.serve import KnnServeEngine as JKnnServeEngine
from repro_torch.core.engine import LocalBackend, QueryEngine, make_disk_backend
from repro_torch.core.index import HerculesIndex
from repro_torch.core.search import brute_force_knn
from repro_torch.data.pipeline import ArrayChunkSource
from repro_torch.launch import serve_knn
from repro_torch.serve import (KnnAnswer, KnnFailure, KnnServeConfig, KnnServeEngine,
                               QueueFull)
from repro_torch.storage import build_index_to_disk
from _torch_threads import one_torch_thread  # noqa: F401

NUM, LEN, K = 2000, 64, 3
JCFG = JIndexConfig(build=JBuildConfig(leaf_capacity=64),
                    search=JSearchConfig(k=K, l_max=4, chunk=128, scan_block=256))


def walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=1)
    return ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)).astype(np.float32)


def workload(data, seed, num, level="5%"):
    """Dataset rows plus noise of variance ``level``, or fresh walks ("ood")."""
    if level == "ood":
        return walks(seed + 100, num, data.shape[1])
    rng = np.random.default_rng(seed)
    sigma2 = float(level.rstrip("%")) / 100.0
    q = data[rng.integers(0, data.shape[0], num)] + \
        rng.standard_normal((num, data.shape[1])) * np.sqrt(sigma2)
    return q.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return walks(0, NUM, LEN)


@pytest.fixture(scope="module")
def pair(data, tmp_path_factory):
    jidx = JIndex.build(jnp.asarray(data), JCFG)
    path = str(tmp_path_factory.mktemp("serve") / "idx.npz")
    jidx.save(path)
    return jidx, HerculesIndex.load(path, device="cpu")


@pytest.fixture
def engine(pair):
    return QueryEngine(LocalBackend(pair[1]))


def assert_exact(data, queries, got, k):
    bf_d, _ = brute_force_knn(torch.from_numpy(data), torch.from_numpy(queries), k)
    np.testing.assert_allclose(got, bf_d.numpy(), rtol=1e-3, atol=1e-3)


class TestKnnServeEngine:
    def test_submit_poll_drain(self, data, engine):
        serve = KnnServeEngine(engine, KnnServeConfig(batch_slots=4))
        q = workload(data, 7, 10)
        rids = [serve.submit(qi) for qi in q]
        assert serve.poll(rids[0]) is None and serve.pending() == 10
        answers = serve.drain()
        assert set(answers) == set(rids) and serve.pending() == 0
        assert_exact(data, q, np.stack([answers[r].dists for r in rids]), K)
        assert isinstance(answers[rids[0]], KnnAnswer)
        # drain claimed every answer: results are handed out exactly once
        assert serve.poll(rids[0]) is None
        tele = serve.telemetry()
        assert tele.serving["unclaimed"] == 0 and tele.serving["served"] == 10
        # 3 waves, each padded to the slot pool -> exactly one plan
        assert (tele.plan_cache.misses, tele.plan_cache.hits) == (1, 2)
        # slot padding does not enter telemetry: 10 real queries only
        assert tele.queries == 10
        assert sum(vars(tele.paths).values()) == 10

    def test_step_serves_one_wave(self, data, engine):
        serve = KnnServeEngine(engine, KnnServeConfig(batch_slots=4))
        for qi in workload(data, 8, 6):
            serve.submit(qi)
        assert serve.step() == 4 and serve.pending() == 2
        assert serve.step() == 2 and serve.pending() == 0
        assert serve.step() == 0

    def test_mixed_k_groups_into_sub_waves(self, data, engine):
        serve = KnnServeEngine(engine, KnnServeConfig(batch_slots=4))
        q = workload(data, 9, 10)
        ks = [1 if i % 2 == 0 else 2 for i in range(10)]
        rids = [serve.submit(qi, k=k) for qi, k in zip(q, ks)]
        # the head is k=1: its sub-wave takes the 4 oldest k=1 requests only
        assert serve.step() == 4 and serve.pending() == 6
        answers = serve.drain()
        assert set(answers) == set(rids) and serve.pending() == 0
        for k in (1, 2):
            rows = [i for i, kk in enumerate(ks) if kk == k]
            got = np.stack([answers[rids[i]].dists for i in rows])
            assert got.shape == (len(rows), k)
            assert_exact(data, q[rows], got, k)
        # 4 sub-waves: 4 x k=1, 4 x k=2, then the k=1 and k=2 stragglers
        sv = serve.telemetry().serving
        assert sv["failed"] == 0 and sv["waves"] == 4

    @pytest.mark.parametrize("wave", [False, True])
    def test_poisoned_request_fails_alone(self, data, engine, wave):
        serve = KnnServeEngine(engine, KnnServeConfig(batch_slots=4, wave=wave))
        good = workload(data, 10, 3)
        g0 = serve.submit(good[0])
        bad = serve.submit(np.zeros(LEN // 2, np.float32))   # wrong length
        g1 = serve.submit(good[1])
        g2 = serve.submit(good[2])
        answers = serve.drain()
        assert serve.pending() == 0
        assert isinstance(answers[bad], KnnFailure)
        assert "ValueError" in answers[bad].error
        assert_exact(data, good, np.stack([answers[r].dists for r in (g0, g1, g2)]), K)
        assert serve.telemetry().serving["failed"] == 1

    def test_admission_control_queue_full(self, data, engine):
        serve = KnnServeEngine(engine, KnnServeConfig(batch_slots=2, max_queue=3))
        q = workload(data, 11, 5)
        for i in range(3):
            serve.submit(q[i])
        with pytest.raises(QueueFull):
            serve.submit(q[3])
        assert serve.telemetry().serving["rejected"] == 1
        serve.step()                      # frees two slots
        serve.submit(q[3])                # the backpressure retry succeeds
        serve.drain()
        assert serve.pending() == 0

    def test_difficulty_packing_serves_everything(self, data, engine):
        serve = KnnServeEngine(engine, KnnServeConfig(batch_slots=4, pack="difficulty"))
        q = np.concatenate([workload(data, 12, 5, "1%"), workload(data, 13, 5, "ood")])
        order = [0, 5, 1, 6, 2, 7, 3, 8, 4, 9]    # easy and hard interleaved
        rids = [serve.submit(q[i]) for i in order]
        answers = serve.drain()
        assert set(answers) == set(rids) and serve.pending() == 0
        assert_exact(data, q[order], np.stack([answers[r].dists for r in rids]), K)
        sv = serve.telemetry().serving
        assert sv["pack"] == "difficulty" and sv["difficulty_scored"] == 10

    def test_submit_takes_one_series(self, engine):
        serve = KnnServeEngine(engine)
        with pytest.raises(ValueError, match="one query series"):
            serve.submit(np.zeros((2, LEN), np.float32))

    @pytest.mark.parametrize("bad", [dict(batch_slots=0), dict(batch_slots=True),
                                     dict(k=0), dict(wave=1), dict(max_queue=0),
                                     dict(pack="lifo")], ids=str)
    def test_config_validates_every_field(self, bad):
        with pytest.raises(ValueError):
            KnnServeConfig(**bad)


def serve_both(pair, queries, ks, cfg):
    """Serve the requests through the port's and the reference's engines;
    returns [(answers in submission order, serving section)] for each."""
    jidx, tidx = pair
    out = []
    for serve in (KnnServeEngine(QueryEngine(LocalBackend(tidx)), KnnServeConfig(**cfg)),
                  JKnnServeEngine(JQueryEngine(JLocalBackend(jidx)), JKnnServeConfig(**cfg))):
        rids = [serve.submit(q, k=k) for q, k in zip(queries, ks)]
        answers = serve.drain()
        t = serve.telemetry()
        out.append(([answers[r] for r in rids], t.serving))
    return out


@pytest.mark.parametrize("cfg", [dict(batch_slots=4), dict(batch_slots=4, wave=True),
                                 dict(batch_slots=3, wave=True, pack="difficulty")],
                         ids=str)
def test_serving_matches_reference(pair, data, cfg):
    """The same mixed-k requests served by both packages' engines: equal
    ids, distances within 1e-4, paths, waves and difficulty scoring."""
    q = np.concatenate([workload(data, 14, 6), workload(data, 15, 4, "ood")])
    ks = [1, 3, 3, 1, 3, 3, 1, 3, 3, 3]
    (t_ans, t_sv), (j_ans, j_sv) = serve_both(pair, q, ks, cfg)
    for t, j in zip(t_ans, j_ans):
        np.testing.assert_array_equal(t.ids, np.asarray(j.ids))
        np.testing.assert_allclose(t.dists, np.asarray(j.dists), rtol=0, atol=1e-4)
        assert t.path == j.path
    for key in ("served", "waves", "failed", "rejected", "difficulty_scored"):
        assert t_sv[key] == j_sv[key], key
    assert t_sv["difficulty_mean"] == pytest.approx(j_sv["difficulty_mean"], abs=1e-6)


def test_wave_serving_over_ooc_local(data, pair, tmp_path):
    """Waves over the out-of-core backend answer as the per-query engine
    does: distances bit for bit, ids as sets per row."""
    path = str(tmp_path / "idx")
    build_index_to_disk(ArrayChunkSource(data, 500), path, pair[1].config, codec="bf16",
                        device="cpu")
    eng = QueryEngine(make_disk_backend("ooc-local", path, memory_budget_mb=0.25,
                                        device="cpu"))
    q = workload(data, 16, 9)
    serve = KnnServeEngine(eng, KnnServeConfig(batch_slots=4, wave=True,
                                               pack="difficulty"))
    rids = [serve.submit(qi) for qi in q]
    answers = serve.drain()
    solo = [eng.knn(qi) for qi in q]
    for r, s in zip(rids, solo):
        np.testing.assert_array_equal(answers[r].dists, s.dists[0].numpy())
        np.testing.assert_array_equal(np.sort(answers[r].ids), np.sort(s.ids[0].numpy()))
    tele = serve.telemetry()
    assert tele.wave_calls == 3 and tele.ooc.wave_calls == 3
    assert tele.serving["difficulty_scored"] == 9


@pytest.mark.parametrize("extra", [[], ["--wave", "--mixed-k", "--max-queue", "6",
                                        "--pack", "difficulty"]], ids=str)
def test_cli_smoke_on_cpu(capsys, extra):
    serve_knn.main(["--device", "cpu", "--smoke", *extra])
    out = capsys.readouterr().out
    assert "smoke exactness vs brute force: OK" in out
    assert "failed=0" in out
