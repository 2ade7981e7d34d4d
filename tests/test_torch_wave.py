"""The port's wave-fused plans against the port's per-query path and against
the reference (``tests/test_wave.py`` mirrored).

One seeded collection (2048 x 64 float32) and its queries are numpy arrays
that both packages take. The reference builds the in-memory index (saved to
``.npz``, loaded by the port) and one index directory per codec, which both
packages serve.

* Within the port (the exactness contract): ``wave_knn`` equals
  ``exact_knn`` in every field, bit for bit; ``QueryEngine.knn(wave=True)``
  equals the per-query calls on ``local``, ``scan``, ``ooc-scan`` and
  ``ooc-local`` under every codec: distances bit for bit, ids as sets per
  row (a wave may order exact ties otherwise).
* Against the reference: positions, ids and every counter equal, distances
  within ``atol=1e-4`` (the packages sum in other orders); the wave
  counters (``runs_deduped``, ``runs_skipped_bsf``, ``wave_rows_shared``,
  ``rows_streamed``) and ``estimate_difficulty`` equal.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search as JSr
from repro.core.engine import LocalBackend as JLocalBackend
from repro.core.engine import QueryEngine as JQueryEngine
from repro.core.engine import make_disk_backend as jax_disk_backend
from repro.core.index import HerculesIndex as JIndex
from repro.core.index import IndexConfig as JIndexConfig
from repro.core.search import SearchConfig as JSearchConfig
from repro.core.tree import BuildConfig as JBuildConfig
from repro.data.pipeline import ArrayChunkSource as JArrayChunkSource
from repro.storage import build_index_to_disk as jax_build_to_disk
from repro_torch.core import engine as E
from repro_torch.core import search as TSr
from repro_torch.core.index import HerculesIndex
from repro_torch.data.pipeline import (PREFETCH_MODES, iter_scheduled_chunks,
                                       make_chunk_reader)
from _torch_threads import one_torch_thread  # noqa: F401

NUM, LEN, K = 2048, 64, 3
JCFG = JIndexConfig(build=JBuildConfig(leaf_capacity=64),
                    search=JSearchConfig(k=K, l_max=4, chunk=256, scan_block=256))
BUDGET_MB = 1.0
CODECS = ("raw", "bf16", "sax-residual")
WAVE_COUNTERS = ("calls", "blocks", "rows_streamed", "bytes_streamed", "sax_rows_read",
                 "wave_calls", "wave_rows_shared", "runs_deduped", "runs_skipped_bsf",
                 "codec_refine_rows", "codec_fallbacks")
RESULT_EXACT = ("positions", "ids", "path", "accessed", "visited_leaves")


def walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=1)
    return ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return walks(0, NUM, LEN)


@pytest.fixture(scope="module")
def queries(data):
    """Four easy queries (dataset rows + 1% noise) and four out of the
    distribution, so both access paths occur."""
    rng = np.random.default_rng(1)
    easy = data[rng.integers(0, NUM, 4)] + rng.standard_normal((4, LEN)) * 0.1
    return np.concatenate([easy.astype(np.float32), walks(2, 4, LEN)])


@pytest.fixture(scope="module")
def clustered(data):
    """Queries perturbed from nearby dataset rows: wave members share home
    leaves, so the merged run schedule has real overlap to dedup."""
    noise = 0.01 * np.random.default_rng(3).standard_normal((8, LEN))
    return (data[100:108] + noise).astype(np.float32)


@pytest.fixture(scope="module")
def pair(data, tmp_path_factory):
    jidx = JIndex.build(jnp.asarray(data), JCFG)
    path = str(tmp_path_factory.mktemp("wave") / "idx.npz")
    jidx.save(path)
    return jidx, HerculesIndex.load(path, device="cpu")


@pytest.fixture(scope="module")
def dirs(data, tmp_path_factory):
    root = tmp_path_factory.mktemp("wave-dirs")
    out = {}
    for codec in CODECS:
        out[codec] = str(root / codec)
        jax_build_to_disk(JArrayChunkSource(jnp.asarray(data), 512), out[codec], JCFG,
                          codec=codec)
    return out


def disk_engine(dirs, codec, name, **search):
    search = dataclasses.replace(TSr.SearchConfig(k=K, l_max=4, chunk=256,
                                                  scan_block=256), **search)
    return E.QueryEngine(E.make_disk_backend(name, dirs[codec], search=search,
                                             memory_budget_mb=BUDGET_MB, device="cpu"))


def jax_disk_engine(dirs, codec, name, **search):
    search = dataclasses.replace(JCFG.search, **search)
    return JQueryEngine(jax_disk_backend(name, dirs[codec], search=search,
                                         memory_budget_mb=BUDGET_MB))


def per_query(engine, queries, **kw):
    outs = [engine.knn(q[None], **kw) for q in queries]
    return types.SimpleNamespace(
        dists=torch.cat([r.dists for r in outs]),
        ids=torch.cat([r.ids for r in outs]),
        path=torch.cat([r.path for r in outs]))


def assert_wave_parity(engine, queries):
    solo = per_query(engine, queries)
    wave = engine.knn(queries, wave=True)
    assert torch.equal(wave.dists, solo.dists)
    assert torch.equal(torch.sort(wave.ids.long(), dim=1).values,
                       torch.sort(solo.ids.long(), dim=1).values)
    return wave


VARIANTS = [{}, dict(use_sax=False), dict(force_scan=True), dict(adaptive=False),
            dict(refine_select="topk"), dict(k=1), dict(k=10, l_max=12)]


class TestCoreWaveKnn:
    @pytest.mark.parametrize("over", VARIANTS, ids=str)
    def test_wave_knn_equals_exact_knn_bitwise(self, pair, queries, over):
        _, tidx = pair
        cfg = dataclasses.replace(tidx.config.search, **over)
        q = torch.from_numpy(queries)
        wave = TSr.wave_knn(tidx.tree, tidx.layout, q, cfg, tidx.max_depth)
        solo = TSr.exact_knn(tidx.tree, tidx.layout, q, cfg, tidx.max_depth)
        for f in wave._fields:
            assert torch.equal(getattr(wave, f), getattr(solo, f)), f

    @pytest.mark.parametrize("over", VARIANTS, ids=str)
    def test_wave_knn_matches_reference(self, pair, queries, over):
        jidx, tidx = pair
        jres = JSr.wave_knn(jidx.tree, jidx.layout, jnp.asarray(queries),
                            dataclasses.replace(jidx.config.search, **over),
                            jidx.max_depth)
        tres = TSr.wave_knn(tidx.tree, tidx.layout, torch.from_numpy(queries),
                            dataclasses.replace(tidx.config.search, **over),
                            tidx.max_depth)
        for f in RESULT_EXACT:
            np.testing.assert_array_equal(getattr(tres, f).numpy(),
                                          np.asarray(getattr(jres, f)), err_msg=f)
        np.testing.assert_allclose(tres.dists.numpy(), np.asarray(jres.dists),
                                   rtol=0, atol=1e-4)
        for f in ("eapca_pr", "sax_pr"):
            np.testing.assert_allclose(getattr(tres, f).numpy(),
                                       np.asarray(getattr(jres, f)), atol=1e-6)

    def test_empty_wave(self, pair):
        _, tidx = pair
        res = TSr.wave_knn(tidx.tree, tidx.layout, torch.zeros((0, LEN)),
                           tidx.config.search, tidx.max_depth)
        assert res.dists.shape == (0, K) and res.path.shape == (0,)


class TestEngineWaveParity:
    def test_local(self, pair, queries):
        assert_wave_parity(E.QueryEngine(E.LocalBackend(pair[1])), queries)

    def test_scan(self, data, queries):
        assert_wave_parity(E.QueryEngine(E.make_backend(
            "scan", data, search=TSr.SearchConfig(k=K, scan_block=256), device="cpu")),
            queries)

    @pytest.mark.parametrize("codec", CODECS)
    def test_ooc_scan(self, dirs, queries, codec):
        eng = disk_engine(dirs, codec, "ooc-scan")
        assert_wave_parity(eng, queries)
        st = eng.stats()
        assert st["wave_calls"] == 1 and st["wave_rows_shared"] > 0

    @pytest.mark.parametrize("codec", CODECS)
    @pytest.mark.parametrize("use_sax", [True, False])
    @pytest.mark.parametrize("prefetch", PREFETCH_MODES)
    def test_ooc_local(self, dirs, queries, codec, use_sax, prefetch):
        eng = disk_engine(dirs, codec, "ooc-local", use_sax=use_sax, prefetch=prefetch)
        assert_wave_parity(eng, queries)
        assert eng.stats()["wave_calls"] == 1


class TestWaveAgainstReference:
    @pytest.mark.parametrize("codec", CODECS)
    @pytest.mark.parametrize("name,use_sax", [("ooc-scan", True), ("ooc-local", True),
                                              ("ooc-local", False)])
    def test_wave_counters_equal_the_reference(self, dirs, queries, clustered, codec,
                                               name, use_sax):
        """The same directory served by both packages' wave plans: every
        streaming and sharing counter equal, positions and ids equal."""
        q = np.concatenate([queries, clustered])
        t_eng = disk_engine(dirs, codec, name, use_sax=use_sax)
        j_eng = jax_disk_engine(dirs, codec, name, use_sax=use_sax)
        got, want = t_eng.knn(q, wave=True), j_eng.knn(jnp.asarray(q), wave=True)
        np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                                   rtol=0, atol=1e-4)
        t_st, j_st = t_eng.stats(), j_eng.stats()
        for key in WAVE_COUNTERS:
            assert t_st[key] == j_st[key], key
        assert t_eng.telemetry().wave_calls == j_eng.telemetry()["wave_calls"] == 1

    def test_local_wave_engine_matches_reference(self, pair, queries):
        jidx, tidx = pair
        got = E.QueryEngine(E.LocalBackend(tidx)).knn(queries, wave=True)
        want = JQueryEngine(JLocalBackend(jidx)).knn(jnp.asarray(queries), wave=True)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                                   rtol=0, atol=1e-4)

    def test_estimate_difficulty_equals_the_reference(self, pair, dirs, queries,
                                                      clustered):
        jidx, tidx = pair
        q = np.concatenate([queries, clustered])
        got = E.QueryEngine(E.LocalBackend(tidx)).estimate_difficulty(q)
        want = JQueryEngine(JLocalBackend(jidx)).estimate_difficulty(jnp.asarray(q))
        np.testing.assert_array_equal(got, np.asarray(want))
        assert got.dtype == np.asarray(want).dtype and ((got >= 0) & (got <= 1)).all()
        got = disk_engine(dirs, "raw", "ooc-local").estimate_difficulty(q)
        want = jax_disk_engine(dirs, "raw", "ooc-local").estimate_difficulty(
            jnp.asarray(q))
        np.testing.assert_array_equal(got, np.asarray(want))
        # one query as a 1-D series; a dense scan has no landscape to score
        assert disk_engine(dirs, "raw", "ooc-local").estimate_difficulty(q[0]).shape == (1,)
        assert disk_engine(dirs, "raw", "ooc-scan").estimate_difficulty(q) is None


class TestWaveSharing:
    def test_clustered_wave_dedups_runs_and_streams_less(self, dirs, clustered):
        eng = disk_engine(dirs, "raw", "ooc-local")
        solo = per_query(eng, clustered)
        rows_solo = eng.stats()["rows_streamed"]
        assert eng.stats()["runs_deduped"] == 0     # per-query: nothing shared
        wave = eng.knn(clustered, wave=True)
        st = eng.stats()
        assert torch.equal(wave.dists, solo.dists)
        assert st["runs_deduped"] > 0 and st["wave_rows_shared"] > 0
        assert st["rows_streamed"] - rows_solo < rows_solo

    def test_engine_telemetry_surfaces_ooc_wave_counters(self, dirs, clustered):
        eng = disk_engine(dirs, "raw", "ooc-local")
        eng.knn(clustered, wave=True)
        tele = eng.telemetry()
        assert tele.wave_calls == 1 and tele.ooc.wave_calls == 1
        assert tele.ooc.runs_deduped > 0 and tele.ooc.wave_rows_shared > 0
        assert tele.serving is None

    def test_in_memory_telemetry_has_no_ooc_section(self, pair, queries):
        eng = E.QueryEngine(E.LocalBackend(pair[1]))
        eng.knn(queries, wave=True)
        assert eng.telemetry().ooc is None and eng.telemetry().wave_calls == 1


class TestWavePlanCache:
    def test_wave_and_solo_plans_are_distinct(self, pair, queries):
        eng = E.QueryEngine(E.LocalBackend(pair[1]))
        eng.knn(queries)
        eng.knn(queries, wave=True)
        pc = eng.telemetry().plan_cache
        assert pc.misses == 2
        # repeats of either flavour hit their own plan
        eng.knn(queries)
        eng.knn(queries, wave=True)
        pc = eng.telemetry().plan_cache
        assert (pc.misses, pc.hits) == (2, 2)


class TestScheduledChunks:
    """The wave path's demand-scheduled fetch loop, as
    ``tests/test_prefetch.py::TestScheduledChunks`` holds the reference's."""
    ROWS = np.arange(100 * 8, dtype=np.float32).reshape(100, 8)

    def _reqs(self):
        return [("a", 0, 10, 16), ("b", 20, 10, 16), ("c", 40, 10, 16),
                ("d", 60, 10, 16)]

    @pytest.mark.parametrize("mode", PREFETCH_MODES)
    def test_fetches_in_request_order(self, mode):
        with make_chunk_reader(self.ROWS, 32, 8, prefetch=mode, device="cpu") as r:
            got = list(iter_scheduled_chunks(r, self._reqs()))
        assert [t for t, _ in got] == ["a", "b", "c", "d"]
        for (_, rows), (_, start, cnt, pad) in zip(got, self._reqs()):
            assert rows.shape == (pad, 8)
            np.testing.assert_array_equal(rows.numpy()[:cnt], self.ROWS[start:start + cnt])
            assert not rows.numpy()[cnt:].any()

    @pytest.mark.parametrize("mode", PREFETCH_MODES)
    def test_still_needed_checked_at_submit_time(self, mode):
        """A request whose consumers were satisfied while earlier blocks
        were in flight is dropped without a read; the decision runs per
        request, as late as the lookahead window allows."""
        dead = set()
        checked = []

        def still_needed(tag):
            checked.append(tag)
            return tag not in dead

        with make_chunk_reader(self.ROWS, 32, 8, prefetch=mode, device="cpu") as r:
            out = []
            for tag, _ in iter_scheduled_chunks(r, self._reqs(),
                                                still_needed=still_needed, lookahead=1):
                out.append(tag)
                if tag == "a":
                    dead.add("c")   # bound tightened: run c no longer needed
            assert r.stats["blocks"] == 3
        assert out == ["a", "b", "d"]
        assert checked == ["a", "b", "c", "d"]

    def test_lookahead_window(self):
        """With ``lookahead=2`` the second request is submitted before the
        first is consumed, and ``still_needed`` sees the third only after the
        first block was handed out."""
        seen = []
        gen = iter_scheduled_chunks(
            make_chunk_reader(self.ROWS, 32, 8, device="cpu"), self._reqs(),
            still_needed=lambda tag: seen.append(tag) or True, lookahead=2)
        tag, _ = next(gen)
        assert tag == "a" and seen == ["a", "b", "c"]
        assert [t for t, _ in gen] == ["b", "c", "d"]

    def test_lookahead_validation(self):
        with make_chunk_reader(self.ROWS, 32, 8, device="cpu") as r:
            with pytest.raises(ValueError, match="lookahead"):
                list(iter_scheduled_chunks(r, self._reqs(), lookahead=0))
