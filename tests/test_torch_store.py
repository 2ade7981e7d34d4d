"""The port's store handle (repro_torch/storage/store.py), held against itself
as ``tests/test_store.py`` holds the reference's, and against the reference.

Class by class as ``tests/test_store.py``, on the CPU:

* append + compact equals a from-scratch build over A∥B (tree, layout, LRD,
  LSD bit for bit; answers of ``local``, ``scan``, ``ooc-scan`` and
  ``ooc-local`` bit-identical to the in-memory backends);
* with rows pending, ``query`` answers bit-identically to the
  difference-form scan over the whole collection, on every backend;
* validation, crash safety (orphan sweep, interrupted compaction, corrupt
  segments, version-1 directories), resource release, plan invalidation,
  the streamed LSD filter, and random chunkings (hypothesis).

Interchange with the reference (the JAX package on the CPU):

* (a) a store the reference created and appended to opens in the port,
  whose ``query`` gives the reference's ids and positions and its distances
  within ``DIST_TOL`` (the packages sum in different orders);
* (b) a store the port wrote opens (checksums verified), serves and
  compacts in the reference, and compacting the same A and B in both
  packages gives equal tree structure, layout, LRD and LSD, with split
  values and synopses within 1e-4 (``test_torch_tree.py``'s rule; a series
  within float32 rounding of a SAX breakpoint could code differently, which
  these seeds do not show);
* (c) the single-file ``.npz`` of ``HerculesIndex.save`` both ways;
* (d) ``generation_of``, ``segment_file_names`` and ``partition_of``;
* (e) the journal merge's tie order and padding;
* (f) ``launch/build_index.py`` and ``launch/search.py --save`` through
  ``main(argv)``, and the provenance rule: each package regenerates only
  its own synthetic kind and reads any other collection back from the LRD.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro.core.index import HerculesIndex as JHerculesIndex
from repro.core.index import IndexConfig as JIndexConfig
from repro.core.search import SearchConfig as JSearchConfig
from repro.core.tree import BuildConfig as JBuildConfig
from repro.launch import build_index as jax_cli
from repro.storage import Hercules as JHercules
from repro.storage import format as JF
from repro_torch.core import engine as E
from repro_torch.core.engine import LocalBackend, ScanBackend, make_disk_backend
from repro_torch.core.index import HerculesIndex, IndexConfig
from repro_torch.core.search import SearchConfig
from repro_torch.core.tree import BuildConfig
from repro_torch.data.pipeline import ArrayChunkSource
from repro_torch.launch import build_index as cli
from repro_torch.launch import search as search_cli
from repro_torch.storage import (Hercules, IndexFormatError, load_index,
                                 open_index, save_index)
from repro_torch.storage import format as TF
from repro_torch.storage.format import FORMAT_VERSION, JOURNAL_DIR, MANIFEST_FILE
from repro_torch.storage import store as store_mod
from repro_torch.storage.store import _merge_triplet
from _torch_threads import one_torch_thread  # noqa: F401
from tests._hypothesis_compat import given, settings, st

NUM_A, NUM_B, LEN = 2048, 1024, 64
CFG = IndexConfig(
    build=BuildConfig(leaf_capacity=64),
    search=SearchConfig(k=3, l_max=4, chunk=256, scan_block=512))
JCFG = JIndexConfig(
    build=JBuildConfig(leaf_capacity=64),
    search=JSearchConfig(k=3, l_max=4, chunk=256, scan_block=512))
BUDGET_MB = 0.25   # collection is several x the ooc streaming budget
BACKENDS = ("local", "scan", "ooc-scan", "ooc-local")
DIST_TOL = dict(rtol=1e-4, atol=1e-4)   # port vs reference distances
STRUCTURE = ("parent", "left", "right", "is_leaf", "no_split", "depth",
             "endpoints", "num_segs", "split_lo", "split_hi", "split_use_std",
             "count", "num_nodes")
CPU = "cpu"


def walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=1)
    return ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data_a():
    return walks(0, NUM_A, LEN)


@pytest.fixture(scope="module")
def data_b():
    return walks(5, NUM_B, LEN)


@pytest.fixture(scope="module")
def data_ab(data_a, data_b):
    return np.concatenate([data_a, data_b])


@pytest.fixture(scope="module")
def queries(data_ab):
    rng = np.random.default_rng(1)
    idx = rng.integers(0, data_ab.shape[0], 5)
    idx[:2] = NUM_A + rng.integers(0, NUM_B, 2)     # two near journal rows
    return (data_ab[idx] + rng.standard_normal((5, LEN)) * np.sqrt(0.05)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def scratch_index(data_ab):
    """From-scratch one-shot build over A∥B: the acceptance oracle."""
    return HerculesIndex.build(data_ab, CFG, device=CPU)


@pytest.fixture(scope="module")
def scan_ab(data_ab):
    return ScanBackend(torch.from_numpy(data_ab), CFG.search)


@pytest.fixture(scope="module")
def compacted_dir(data_a, data_b, tmp_path_factory):
    """create(A) -> reopen -> append(B) -> compact, in distinct handles."""
    path = str(tmp_path_factory.mktemp("store") / "idx")
    with Hercules.create(path, CFG, data=data_a, chunk_size=700, device=CPU):
        pass
    with Hercules.open(path, "a", device=CPU) as hx:
        hx.append(data_b, chunk_size=500)
        hx.compact(chunk_size=900)
    return path


def _same(a, b, positions=True):
    assert torch.equal(a.dists, b.dists)
    assert torch.equal(a.ids, b.ids)
    if positions:
        assert torch.equal(a.positions, b.positions)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TestAppendCompactParity:
    """Acceptance oracle: append+compact == from-scratch build over A∥B."""

    def test_tree_and_layout_bit_identical(self, compacted_dir, scratch_index):
        with Hercules.open(compacted_dir, device=CPU) as hx:
            loaded = hx.index()
        for name in scratch_index.tree._fields:
            assert torch.equal(getattr(scratch_index.tree, name),
                               getattr(loaded.tree, name)), name
        for f in dataclasses.fields(scratch_index.layout):
            a = getattr(scratch_index.layout, f.name)
            b = getattr(loaded.layout, f.name)
            if isinstance(a, int):
                assert a == b, f.name
            else:
                assert torch.equal(a, b), f.name

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_backend_parity(self, compacted_dir, scratch_index, scan_ab,
                            queries, backend):
        mem = LocalBackend(scratch_index) if backend == "local" else scan_ab
        with Hercules.open(compacted_dir, device=CPU) as hx:
            res = hx.engine(backend, memory_budget_mb=BUDGET_MB).knn(queries, k=3)
            _same(res, mem.knn(queries, k=3), positions=backend == "local")

    def test_query_routes_through_engine(self, compacted_dir, scratch_index,
                                         queries):
        with Hercules.open(compacted_dir, device=CPU) as hx:
            _same(hx.query(queries, k=3),
                  LocalBackend(scratch_index).knn(queries, k=3))

    def test_multi_append_equals_single(self, data_a, data_b, scratch_index,
                                        tmp_path):
        """Two appends in different chunkings compact to the same bytes."""
        path = str(tmp_path / "idx")
        with Hercules.create(path, CFG, data=data_a, device=CPU) as hx:
            hx.append(data_b[:300], chunk_size=128)
            hx.append(data_b[300:], chunk_size=999)
            assert len(hx.journal["segments"]) == 2
            hx.compact()
            np.testing.assert_array_equal(scratch_index.layout.lrd.numpy(),
                                          hx.saved._mapped("lrd"))


class TestJournalQueries:
    """Exactness with rows pending compaction (no rebuild needed)."""

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("k", [1, 3])
    def test_journal_merge_matches_scan(self, data_a, data_b, scan_ab,
                                        queries, tmp_path, backend, k):
        path = str(tmp_path / "idx")
        with Hercules.create(path, CFG, data=data_a, device=CPU) as hx:
            hx.append(data_b[:600])
            hx.append(data_b[600:], chunk_size=100)
            res = hx.query(queries, k, backend=backend,
                           memory_budget_mb=BUDGET_MB)
            ref = scan_ab.knn(queries, k=k)
            assert torch.equal(res.dists, ref.dists)
            assert torch.equal(res.ids, ref.ids)
            # journal rows have no layout position yet
            journal_hits = res.ids >= NUM_A
            assert journal_hits.any()
            assert (res.positions[journal_hits] == -1).all()
            assert (res.positions[~journal_hits] >= 0).all()

    def test_empty_store_journal_only(self, data_ab, scan_ab, queries, tmp_path):
        path = str(tmp_path / "idx")
        with Hercules.create(path, CFG, device=CPU) as hx:
            assert hx.saved is None and hx.num_series == 0
            with pytest.raises(IndexFormatError, match="empty"):
                hx.query(queries, k=3)
            hx.append(data_ab[:NUM_A])
            hx.append(data_ab[NUM_A:])
            res = hx.query(queries, k=3)
            ref = scan_ab.knn(queries, k=3)
            assert torch.equal(res.dists, ref.dists)
            assert torch.equal(res.ids, ref.ids)
            # engine() needs a base; query() does not
            with pytest.raises(IndexFormatError, match="base"):
                hx.engine("local")
            hx.compact()
            res2 = hx.engine("local").knn(queries, k=3)
            assert torch.equal(res2.dists, ref.dists)

    def test_index_refuses_pending_rows(self, data_a, data_b, tmp_path):
        path = str(tmp_path / "idx")
        with Hercules.create(path, CFG, data=data_a, device=CPU) as hx:
            hx.append(data_b)
            with pytest.raises(IndexFormatError, match="pending"):
                hx.index()


class TestAppendValidation:
    def test_mode_r_rejects_mutation(self, compacted_dir, data_b):
        with Hercules.open(compacted_dir, device=CPU) as hx:
            with pytest.raises(IndexFormatError, match="read-only"):
                hx.append(data_b)
            with pytest.raises(IndexFormatError, match="read-only"):
                hx.compact()

    def test_series_len_mismatch(self, data_a, tmp_path):
        path = str(tmp_path / "idx")
        with Hercules.create(path, CFG, data=data_a, device=CPU) as hx:
            with pytest.raises(ValueError, match="series length"):
                hx.append(np.zeros((4, LEN * 2), np.float32))

    def test_empty_append(self, data_a, tmp_path):
        path = str(tmp_path / "idx")
        with Hercules.create(path, CFG, data=data_a, device=CPU) as hx:
            with pytest.raises(ValueError, match="at least one row"):
                hx.append(np.zeros((0, LEN), np.float32))

    def test_create_refuses_existing(self, compacted_dir, data_a):
        with pytest.raises(IndexFormatError, match="already"):
            Hercules.create(compacted_dir, CFG, data=data_a, device=CPU)

    def test_compact_without_journal_is_noop(self, data_a, tmp_path):
        path = str(tmp_path / "idx")
        with Hercules.create(path, CFG, data=data_a, device=CPU) as hx:
            gen = hx.generation
            hx.compact()
            assert hx.generation == gen

    def test_bad_mode_and_engine_name(self, compacted_dir):
        with pytest.raises(ValueError, match="mode"):
            Hercules.open(compacted_dir, "w", device=CPU)
        with Hercules.open(compacted_dir, device=CPU) as hx:
            # the registry's message for a name it does not hold
            with pytest.raises(ValueError, match="unknown backend 'sharded'"):
                hx.engine("sharded")
            # dist-ooc is registered: two shards answer as ooc-local does
            q = np.asarray(hx.saved.original_data()[:4]) + np.float32(0.01)
            want = hx.engine("ooc-local").knn(q, k=3)
            got = hx.engine("dist-ooc", shards=2).knn(q, k=3)
            for field in ("dists", "positions", "ids"):
                assert torch.equal(getattr(got, field), getattr(want, field)), field


class TestCrashSafety:
    def _store(self, data_a, tmp_path) -> str:
        path = str(tmp_path / "idx")
        Hercules.create(path, CFG, data=data_a, device=CPU).close()
        return path

    def test_segment_without_commit_is_swept(self, data_a, data_b, tmp_path,
                                             queries):
        """Kill between journal-segment write and manifest commit: the
        segment files exist but the manifest never named them; reopen
        recovers cleanly and serves the committed state."""
        path = self._store(data_a, tmp_path)
        os.makedirs(os.path.join(path, JOURNAL_DIR), exist_ok=True)
        np.save(os.path.join(path, JOURNAL_DIR, "seg-00000.lrd.npy"), data_b)
        np.save(os.path.join(path, JOURNAL_DIR, "seg-00000.lsd.npy"),
                np.zeros((NUM_B, 16), np.uint8))
        with Hercules.open(path, "a", device=CPU) as hx:
            assert sorted(hx.recovered) == [
                f"{JOURNAL_DIR}/seg-00000.lrd.npy",
                f"{JOURNAL_DIR}/seg-00000.lsd.npy"]
            assert hx.pending_rows == 0
            assert hx.num_series == NUM_A
            hx.query(queries, k=1)      # serves the committed state
            # the swept name is reusable: append lands a fresh segment 0
            seg = hx.append(data_b)
            assert seg["name"] == "seg-00000"
            assert hx.pending_rows == NUM_B

    def test_readonly_open_does_not_sweep(self, data_a, tmp_path):
        path = self._store(data_a, tmp_path)
        orphan = os.path.join(path, JOURNAL_DIR, "seg-00000.lrd.npy")
        os.makedirs(os.path.dirname(orphan), exist_ok=True)
        np.save(orphan, np.zeros((2, LEN), np.float32))
        with Hercules.open(path, device=CPU) as hx:
            assert hx.recovered == []
        assert os.path.exists(orphan)

    def test_interrupted_compaction_cleanup(self, data_a, data_b, tmp_path):
        """Kill after the compaction's manifest commit but before the old
        generation and the journal were deleted: reopen sweeps them."""
        path = self._store(data_a, tmp_path)
        with Hercules.open(path, "a", device=CPU) as hx:
            hx.append(data_b)
            hx.compact()
            assert hx.generation == 1
            assert sorted(os.listdir(os.path.join(path, JOURNAL_DIR))) == []
            assert not os.path.exists(os.path.join(path, "lrd.npy"))
        np.save(os.path.join(path, "lrd.npy"), np.zeros((4, LEN), np.float32))
        os.makedirs(os.path.join(path, JOURNAL_DIR), exist_ok=True)
        np.save(os.path.join(path, JOURNAL_DIR, "seg-00000.lrd.npy"), data_b)
        with Hercules.open(path, "a", device=CPU) as hx:
            assert "lrd.npy" in hx.recovered
            assert f"{JOURNAL_DIR}/seg-00000.lrd.npy" in hx.recovered
            assert hx.num_series == NUM_A + NUM_B

    def test_staged_base_copy_is_swept(self, data_a, tmp_path):
        """Kill during a compaction, while its id-order copy of the base
        rows exists: a writable reopen sweeps the copy."""
        path = self._store(data_a, tmp_path)
        np.save(os.path.join(path, "compact-base.npy"), data_a)
        with Hercules.open(path, "a", device=CPU) as hx:
            assert hx.recovered == ["compact-base.npy"]
            assert hx.num_series == NUM_A

    def test_compaction_stages_base_in_id_order(self, data_a, data_b, tmp_path,
                                                monkeypatch):
        """The compaction's replay source holds the base rows in original
        id order, and its scratch copy is removed when the build fails as
        when it commits."""
        path = self._store(data_a, tmp_path)
        seen = {}

        def failing_build(source, *args, **kwargs):
            seen["rows"] = np.asarray(source._rows[0:NUM_A]).copy()
            raise RuntimeError("build failed")

        with Hercules.open(path, "a", device=CPU) as hx:
            hx.append(data_b)
            monkeypatch.setattr(store_mod, "stream_base_files", failing_build)
            with pytest.raises(RuntimeError, match="build failed"):
                hx.compact()
            assert not os.path.exists(os.path.join(path, "compact-base.npy"))
            np.testing.assert_array_equal(seen["rows"], data_a)
            assert hx.generation == 0 and hx.pending_rows == NUM_B
            monkeypatch.undo()
            manifest = hx.compact()
            assert manifest["extra"]["compact"]["stage_seconds"] >= 0.0
        assert not os.path.exists(os.path.join(path, "compact-base.npy"))

    def test_journal_segment_corruption_detected(self, data_a, data_b,
                                                 tmp_path):
        path = self._store(data_a, tmp_path)
        with Hercules.open(path, "a", device=CPU) as hx:
            hx.append(data_b)
        seg = os.path.join(path, JOURNAL_DIR, "seg-00000.lrd.npy")
        size = os.path.getsize(seg)
        with open(seg, "r+b") as f:
            f.seek(size // 2)
            byte = f.read(1)
            f.seek(size // 2)
            f.write(bytes([byte[0] ^ 0xFF]))
        with pytest.raises(IndexFormatError, match="checksum|corrupted"):
            Hercules.open(path, "a", device=CPU)

    def test_v1_directory_still_opens(self, data_a, tmp_path, queries):
        """A pre-journal (version 1) manifest opens, serves, and migrates
        to the current format version on its first append."""
        path = str(tmp_path / "idx")
        save_index(HerculesIndex.build(data_a, CFG, device=CPU), path)
        mf = os.path.join(path, MANIFEST_FILE)
        with open(mf) as f:
            manifest = json.load(f)
        for key in ("journal", "generation"):
            manifest.pop(key, None)
        manifest["version"] = 1
        with open(mf, "w") as f:
            json.dump(manifest, f)
        assert load_index(path, device=CPU).layout.num_series == NUM_A
        with Hercules.open(path, "a", device=CPU) as hx:
            assert hx.generation == 0 and hx.pending_rows == 0
            hx.query(queries, k=1)
            hx.append(data_a[:16])
        with open(mf) as f:
            assert json.load(f)["version"] == FORMAT_VERSION


class TestResourceRelease:
    def test_saved_index_close_releases_memmaps(self, compacted_dir):
        saved = open_index(compacted_dir)
        mm = saved.lrd._mmap
        saved.close()
        assert saved.closed and saved.lrd is None and saved.lsd is None
        assert mm.closed
        saved.close()                    # idempotent
        with pytest.raises(IndexFormatError, match="closed"):
            saved.original_data()

    def test_saved_index_context_manager(self, compacted_dir):
        with open_index(compacted_dir) as saved:
            assert saved.num_series == NUM_A + NUM_B
        assert saved.closed

    def test_store_close_is_loud_for_stale_backends(self, compacted_dir,
                                                    queries):
        hx = Hercules.open(compacted_dir, device=CPU)
        backend = make_disk_backend("ooc-scan", hx, memory_budget_mb=BUDGET_MB,
                                    device=CPU)
        hx.close()
        with pytest.raises(IndexFormatError, match="closed"):
            backend.knn(queries, k=1)
        with pytest.raises(IndexFormatError, match="closed"):
            hx.query(queries, k=1)

    def test_compact_closes_previous_generation(self, data_a, data_b, queries,
                                                tmp_path):
        path = str(tmp_path / "idx")
        with Hercules.create(path, CFG, data=data_a, device=CPU) as hx:
            old = hx.saved
            stale = make_disk_backend("ooc-local", hx, memory_budget_mb=BUDGET_MB,
                                      device=CPU)
            hx.append(data_b)
            hx.compact()
            assert old.closed and not hx.saved.closed
            with pytest.raises(IndexFormatError, match="closed"):
                stale.knn(queries, k=1)


class TestPlanInvalidation:
    def test_append_and_compact_invalidate_engines(self, data_a, data_b,
                                                   scratch_index, queries,
                                                   tmp_path):
        path = str(tmp_path / "idx")
        with Hercules.create(path, CFG, data=data_a, device=CPU) as hx:
            eng = hx.engine("local")
            eng.knn(queries, k=1)
            assert eng.telemetry().plan_cache.size == 1
            v0 = hx.data_version

            hx.append(data_b)
            assert hx.data_version == v0 + 1
            tele = eng.telemetry().plan_cache
            assert tele.invalidations == 1 and tele.size == 0
            # the store hands out a *fresh* engine after the mutation
            assert hx.engine("local") is not eng
            assert hx.describe()["pending_rows"] == NUM_B
            assert hx.describe()["journal_segments"] == 1

            eng2 = hx.engine("local")
            hx.compact()
            assert eng2.telemetry().plan_cache.invalidations == 1
            # post-compact engine serves the appended rows
            res = hx.engine("local").knn(queries, k=3)
            ref = LocalBackend(scratch_index).knn(queries, k=3)
            assert torch.equal(res.dists, ref.dists)

    def test_engine_cache_reuse(self, compacted_dir):
        with Hercules.open(compacted_dir, device=CPU) as hx:
            assert hx.engine("local") is hx.engine("local")
            assert hx.engine("local") is not hx.engine("scan")
            # the budget keys only the streaming backends
            assert hx.engine("scan", memory_budget_mb=1) is hx.engine("scan")
            assert (hx.engine("ooc-scan", memory_budget_mb=1)
                    is not hx.engine("ooc-scan", memory_budget_mb=2))

    def test_make_disk_backend_accepts_handle_and_saved(self, compacted_dir,
                                                        queries, tmp_path):
        with Hercules.open(compacted_dir, device=CPU) as hx:
            via_handle = make_disk_backend("local", hx, device=CPU)
            via_saved = make_disk_backend("local", hx.saved, device=CPU)
            via_path = make_disk_backend("local", compacted_dir, device=CPU)
            r1 = via_handle.knn(queries, k=1)
            _same(via_saved.knn(queries, k=1), r1)
            _same(via_path.knn(queries, k=1), r1)
        with Hercules.create(str(tmp_path / "empty"), CFG, device=CPU) as hx:
            with pytest.raises(ValueError, match="no base index"):
                make_disk_backend("local", hx, device=CPU)

    def test_invalidate_counts_and_clears_plans(self, scratch_index, queries):
        eng = E.QueryEngine(LocalBackend(scratch_index))
        eng.knn(queries, k=1)
        eng.knn(queries, k=2)
        assert eng.telemetry().plan_cache.size == 2
        eng.invalidate()
        eng.invalidate()
        pc = eng.telemetry().plan_cache
        assert (pc.size, pc.invalidations, pc.misses) == (0, 2, 2)
        eng.knn(queries, k=1)            # rebuilt, not a hit
        assert eng.telemetry().plan_cache.misses == 3


class TestOocSaxStreaming:
    """Streamed LSD phase-3 pruning for ooc-local, through the store."""

    def test_sax_filter_cuts_reads_and_stays_exact(self, compacted_dir,
                                                   scratch_index, queries):
        with Hercules.open(compacted_dir, device=CPU) as hx:
            with_sax = hx.engine("ooc-local", memory_budget_mb=BUDGET_MB)
            res = with_sax.knn(queries, k=3)
            ref = LocalBackend(scratch_index).knn(queries, k=3)
            assert torch.equal(res.dists, ref.dists)
            assert torch.equal(res.ids, ref.ids)
            st_sax = with_sax.backend.stats()
            assert st_sax["sax_rows_read"] > 0
            assert (res.sax_pr >= 0).all()

            no_sax = hx.engine(
                "ooc-local",
                search=dataclasses.replace(CFG.search, use_sax=False),
                memory_budget_mb=BUDGET_MB)
            res2 = no_sax.knn(queries, k=3)
            assert torch.equal(res2.dists, ref.dists)
            st_no = no_sax.backend.stats()
            assert st_no["sax_rows_read"] == 0
            # the per-series filter fetches no more rows than leaf-level
            # pruning alone
            assert st_sax["rows_streamed"] <= st_no["rows_streamed"]


class TestRandomChunkings:
    @settings(max_examples=5, deadline=None)
    @given(st.data())
    def test_append_any_chunking_equals_oneshot(self, tmp_path_factory, data):
        """Property: appending the collection in arbitrary pieces (random
        split points, random per-append chunk sizes) and compacting equals
        the one-shot build bit for bit."""
        num, n = 384, 32
        cfg = IndexConfig(
            build=BuildConfig(leaf_capacity=48),
            search=SearchConfig(k=1, l_max=2, chunk=64, scan_block=64))
        rows = walks(7, num, n)
        n_cuts = data.draw(st.integers(0, 3), label="n_cuts")
        cuts = sorted(data.draw(
            st.lists(st.integers(1, num - 1), min_size=n_cuts,
                     max_size=n_cuts, unique=True), label="cuts"))
        pieces = np.split(rows, cuts)
        first_chunk = data.draw(st.integers(32, 512), label="first_chunk")

        path = str(tmp_path_factory.mktemp("prop") / "idx")
        with Hercules.create(path, cfg, device=CPU,
                             data=ArrayChunkSource(pieces[0], first_chunk)) \
                as hx:
            for piece in pieces[1:]:
                hx.append(piece, chunk_size=data.draw(
                    st.integers(16, 512), label="chunk"))
            hx.compact(chunk_size=data.draw(st.integers(32, 512),
                                            label="compact_chunk"))
            oneshot = HerculesIndex.build(rows, cfg, device=CPU)
            for name in oneshot.tree._fields:
                assert torch.equal(getattr(oneshot.tree, name),
                                   getattr(hx.saved.tree, name)), name
            np.testing.assert_array_equal(oneshot.layout.lrd.numpy(),
                                          hx.saved._mapped("lrd"))
            np.testing.assert_array_equal(oneshot.layout.lsd.numpy(),
                                          hx.saved._mapped("lsd"))


# ---------------------------------------------------------------------------
# interchange with the reference
# ---------------------------------------------------------------------------

def _assert_trees_match(j_tree, t_tree):
    for f in STRUCTURE:
        np.testing.assert_array_equal(_np(getattr(t_tree, f)),
                                      _np(getattr(j_tree, f)), err_msg=f)
    for f in ("split_value", "synopsis"):
        np.testing.assert_allclose(_np(getattr(t_tree, f)), _np(getattr(j_tree, f)),
                                   rtol=0, atol=1e-4, err_msg=f)


def _assert_saved_match(j_saved, t_saved):
    """Two compacted generations: tree structure, LRD, LSD and every small
    layout array equal; split values and synopses within 1e-4."""
    _assert_trees_match(j_saved.tree, t_saved.tree)
    np.testing.assert_array_equal(t_saved._mapped("lrd"), j_saved._mapped("lrd"))
    np.testing.assert_array_equal(t_saved._mapped("lsd"), j_saved._mapped("lsd"))
    for name, arr in t_saved.small.items():
        if name == "leaf_synopsis":
            np.testing.assert_allclose(arr, j_saved.small[name], atol=1e-4)
        else:
            np.testing.assert_array_equal(arr, j_saved.small[name], err_msg=name)
    assert t_saved.manifest["layout_static"] == j_saved.manifest["layout_static"]


def _assert_answers_match(t_res, j_res):
    np.testing.assert_array_equal(t_res.ids.numpy(), np.asarray(j_res.ids))
    np.testing.assert_array_equal(t_res.positions.numpy(),
                                  np.asarray(j_res.positions))
    np.testing.assert_allclose(t_res.dists.numpy(), np.asarray(j_res.dists),
                               **DIST_TOL)


@pytest.fixture(scope="module")
def jax_store(data_a, data_b, tmp_path_factory):
    """A store the reference created over A and appended B to (two
    segments), left with its rows pending."""
    path = str(tmp_path_factory.mktemp("jax_store") / "idx")
    with JHercules.create(path, JCFG, data=data_a, chunk_size=700) as hx:
        hx.append(data_b[:400], chunk_size=128)
        hx.append(data_b[400:])
    return path


@pytest.fixture(scope="module")
def port_store(data_a, data_b, tmp_path_factory):
    """The same store written by the port."""
    path = str(tmp_path_factory.mktemp("port_store") / "idx")
    with Hercules.create(path, CFG, data=data_a, chunk_size=700,
                         device=CPU) as hx:
        hx.append(data_b[:400], chunk_size=128)
        hx.append(data_b[400:])
    return path


def _copy(path, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(path, dst)
    return dst


class TestJaxStoreInPort:
    """(a) the reference's store, with rows pending, served by the port."""

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_query_matches_reference(self, jax_store, queries, backend):
        with JHercules.open(jax_store) as jhx:
            want = jhx.query(queries, k=3, backend=backend,
                             memory_budget_mb=BUDGET_MB)
        with Hercules.open(jax_store, device=CPU) as hx:
            assert (hx.base_rows, hx.pending_rows) == (NUM_A, NUM_B)
            got = hx.query(queries, 3, backend=backend,
                           memory_budget_mb=BUDGET_MB)
        _assert_answers_match(got, want)
        assert (got.ids >= NUM_A).any()

    def test_port_appends_and_compacts_reference_store(self, jax_store,
                                                       scratch_index, queries,
                                                       tmp_path):
        path = _copy(jax_store, tmp_path, "idx")
        with Hercules.open(path, "a", device=CPU) as hx:
            hx.compact(chunk_size=512)
            assert hx.generation == 1 and hx.pending_rows == 0
            res = hx.query(queries, k=3)
        _same(res, LocalBackend(scratch_index).knn(queries, k=3))


class TestPortStoreInJax:
    """(b) the port's store opened, verified, served and compacted by the
    reference."""

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_reference_serves_port_store(self, port_store, queries, backend):
        with JHercules.open(port_store, verify=True) as jhx:
            assert (jhx.base_rows, jhx.pending_rows) == (NUM_A, NUM_B)
            want = jhx.query(queries, k=3, backend=backend,
                             memory_budget_mb=BUDGET_MB)
        with Hercules.open(port_store, device=CPU) as hx:
            got = hx.query(queries, 3, backend=backend,
                           memory_budget_mb=BUDGET_MB)
        _assert_answers_match(got, want)

    def test_both_compactions_agree(self, port_store, queries, tmp_path):
        by_jax = _copy(port_store, tmp_path, "by_jax")
        by_port = _copy(port_store, tmp_path, "by_port")
        with JHercules.open(by_jax, "a") as jhx:
            jhx.compact(chunk_size=900)
            assert jhx.generation == 1
            assert os.listdir(os.path.join(by_jax, JOURNAL_DIR)) == []
        with Hercules.open(by_port, "a", device=CPU) as hx:
            hx.compact(chunk_size=900)
        # each package reads the other's generation 1 (checksums verified)
        with JHercules.open(by_port, verify=True) as jhx, \
                Hercules.open(by_jax, device=CPU) as hx:
            _assert_saved_match(jhx.saved, hx.saved)
            _assert_answers_match(hx.query(queries, k=3), jhx.query(queries, k=3))
        for path in (by_jax, by_port):
            assert sorted(os.listdir(path)) == sorted(
                ["journal", "manifest.json", "layout-00001.npz", "lrd-00001.npy",
                 "lsd-00001.npy", "tree-00001.npz"])

    def test_compacting_in_each_package_from_its_own_store(
            self, jax_store, port_store, tmp_path):
        j_path = _copy(jax_store, tmp_path, "j")
        t_path = _copy(port_store, tmp_path, "t")
        with JHercules.open(j_path, "a") as jhx, \
                Hercules.open(t_path, "a", device=CPU) as hx:
            jhx.compact()
            hx.compact()
            _assert_saved_match(jhx.saved, hx.saved)
            assert jhx.manifest["partition"] == hx.manifest["partition"]


class TestNpzInterchange:
    """(c) ``HerculesIndex.save`` / ``load`` across the packages."""

    def test_port_save_reference_load(self, scratch_index, tmp_path):
        path = str(tmp_path / "sub" / "port.npz")
        scratch_index.save(path)
        assert not os.path.exists(path + ".tmp")
        j = JHerculesIndex.load(path)
        for name in scratch_index.tree._fields:
            np.testing.assert_array_equal(np.asarray(getattr(j.tree, name)),
                                          getattr(scratch_index.tree, name).numpy())
        for f in dataclasses.fields(j.layout):
            a, b = getattr(j.layout, f.name), getattr(scratch_index.layout, f.name)
            if isinstance(b, int):
                assert a == b, f.name
            else:
                np.testing.assert_array_equal(np.asarray(a), b.numpy(), f.name)
        assert j.max_depth == scratch_index.max_depth
        assert dataclasses.asdict(j.config.build) == dataclasses.asdict(
            scratch_index.config.build)
        assert dataclasses.asdict(j.config.search) == dataclasses.asdict(
            scratch_index.config.search)
        again = HerculesIndex.load(path, device=CPU)
        for name in scratch_index.tree._fields:
            assert torch.equal(getattr(again.tree, name),
                               getattr(scratch_index.tree, name))

    def test_reference_save_port_load(self, data_ab, tmp_path):
        j = JHerculesIndex.build(data_ab, JCFG)
        path = str(tmp_path / "jax.npz")
        j.save(path)
        t = HerculesIndex.load(path, device=CPU)
        for name in j.tree._fields:
            np.testing.assert_array_equal(getattr(t.tree, name).numpy(),
                                          np.asarray(getattr(j.tree, name)))
        for f in dataclasses.fields(j.layout):
            a, b = getattr(j.layout, f.name), getattr(t.layout, f.name)
            if isinstance(a, int):
                assert a == b, f.name
            else:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a), f.name)
        # the port's file carries the same array names and meta keys
        mine = str(tmp_path / "port.npz")
        t.save(mine)
        with np.load(path) as zj, np.load(mine) as zt:
            assert zj.files == zt.files
            assert json.loads(str(zj["__meta__"])) == json.loads(str(zt["__meta__"]))


class TestIndexFacade:
    """The ``HerculesIndex`` entry points the store's users keep."""

    @pytest.mark.parametrize("chunk,prefetch", [(700, "sync"), (512, "thread")])
    def test_build_streaming_equals_build(self, data_ab, scratch_index, chunk,
                                          prefetch):
        got = HerculesIndex.build_streaming(ArrayChunkSource(data_ab, chunk), CFG,
                                            prefetch=prefetch, device=CPU)
        for name in scratch_index.tree._fields:
            assert torch.equal(getattr(got.tree, name),
                               getattr(scratch_index.tree, name)), name
        for f in dataclasses.fields(got.layout):
            a, b = getattr(got.layout, f.name), getattr(scratch_index.layout, f.name)
            assert a == b if isinstance(a, int) else torch.equal(a, b), f.name


class TestFormatHelpers:
    """(d) the manifest helpers the store relies on."""

    @pytest.mark.parametrize("gen", [None, 0, 1, 7, 12345])
    def test_generation_of(self, gen):
        manifest = {} if gen is None else {"generation": gen}
        assert TF.generation_of(manifest) == JF.generation_of(manifest)
        for name in ("lrd.npy", "tree.npz", "enc.npy"):
            g = gen or 0
            assert TF.generation_name(name, g) == JF.generation_name(name, g)

    @pytest.mark.parametrize("seg_id", [0, 1, 42, 99999])
    def test_segment_file_names(self, seg_id):
        assert TF.segment_file_names(seg_id) == JF.segment_file_names(seg_id)

    def test_partition_of(self, port_store):
        manifest = TF.read_manifest(port_store)
        for m in (manifest, {}, {"partition": None},
                  {"partition": {"version": 2}}):
            assert TF.partition_of(m) == JF.partition_of(m)
        assert TF.partition_of(manifest)["plans"]


class TestMergeOrder:
    """(e) the journal merge: stable, no dedup, base before journal."""

    def test_tie_breaks_toward_base(self, data_a, tmp_path):
        path = str(tmp_path / "idx")
        q = data_a[[17]] + np.float32(0.25)
        with Hercules.create(path, CFG, data=data_a, device=CPU) as hx:
            hx.append(data_a[[17, 17]])              # exact copies of row 17
            res = hx.query(q, k=3, backend="scan")
            assert res.ids.tolist() == [[17, NUM_A, NUM_A + 1]]
            assert res.positions[0, 1:].tolist() == [-1, -1]
            assert res.positions[0, 0] >= 0
            assert res.dists[0, 0] == res.dists[0, 1] == res.dists[0, 2]

    def test_journal_only_pads_with_inf(self, data_a, tmp_path):
        path = str(tmp_path / "idx")
        with Hercules.create(path, CFG, device=CPU) as hx:
            hx.append(data_a[:2])
            res = hx.query(data_a[:1], k=4)
        assert res.ids.tolist() == [[0, 1, -1, -1]]
        assert res.positions.tolist() == [[-1, -1, -1, -1]]
        assert torch.isinf(res.dists[0, 2:]).all() and res.dists[0, 0] == 0

    def test_merge_triplet_is_stable_without_dedup(self):
        inf = float("inf")
        d0 = torch.tensor([[1.0, 2.0, inf]])
        p0 = torch.tensor([[5, 6, -1]], dtype=torch.int32)
        i0 = torch.tensor([[50, 60, -1]], dtype=torch.int32)
        d1 = torch.tensor([[2.0, 1.0, inf, 0.5]])
        p1 = torch.full((1, 4), -1, dtype=torch.int32)
        i1 = torch.tensor([[100, 101, 102, 103]], dtype=torch.int32)
        d, p, i = _merge_triplet(d0, p0, i0, d1, p1, i1, k=6)
        assert d.tolist() == [[0.5, 1.0, 1.0, 2.0, 2.0, inf]]
        assert i.tolist() == [[103, 50, 101, 60, 100, -1]]
        assert p.tolist() == [[-1, 5, -1, 6, -1, -1]]


class TestCli:
    """(f) the CLIs through ``main(argv)`` on the CPU."""

    ARGS = ["--length", "64", "--device", "cpu"]

    def test_lifecycle_with_parity(self, tmp_path, capsys):
        idx = str(tmp_path / "idx")
        cli.main(["build", "--out", idx, "--num", "3000", "--seed", "7",
                  "--chunk-size", "700", "--verify-one-shot", *self.ARGS])
        cli.main(["append", "--index", idx, "--num", "600", "--seed", "11",
                  *self.ARGS])
        with pytest.raises(SystemExit, match="pending"):
            cli.main(["query", "--index", idx, "--verify", "parity",
                      "--device", "cpu"])
        cli.main(["compact", "--index", idx, "--device", "cpu",
                  "--json", str(tmp_path / "compact.json")])
        cli.main(["query", "--index", idx, "--verify", "parity",
                  "--device", "cpu"])
        cli.main(["query", "--index", idx, "--backend", "ooc-scan",
                  "--memory-budget-mb", "0.25", "--verify", "exact",
                  "--prefetch", "thread", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "tree + layout bit-identical" in out
        assert "local: bit-identical" in out and "scan: bit-identical" in out
        assert "exact vs brute force: OK" in out
        with open(str(tmp_path / "compact.json")) as f:
            assert json.load(f)["generation"] == 1
        prov = TF.read_manifest(idx)["extra"]["data"]
        assert prov == {"kind": "concat", "parts": [
            {"kind": "synthetic-torch", "seed": 7, "num": 3000, "length": 64},
            {"kind": "synthetic-torch", "seed": 11, "num": 600, "length": 64}]}
        # regenerated from the record: the port's own draw, in id order
        with open_index(idx) as saved:
            np.testing.assert_array_equal(cli._regenerate(saved),
                                          saved.original_data())
            # the reference does not know the kind and reads the LRD back
        with JF.open_index(idx) as jsaved:
            np.testing.assert_array_equal(jax_cli._regenerate(jsaved),
                                          jsaved.original_data())

    def test_reference_store_falls_back_to_lrd(self, tmp_path, capsys):
        """A store the reference's CLI wrote records ``jax.random`` data;
        the port reads the collection back instead of regenerating it."""
        idx = str(tmp_path / "jidx")
        jax_cli.main(["build", "--out", idx, "--num", "2048", "--length", "64",
                      "--seed", "3", "--chunk-size", "512"])
        jax_cli.main(["append", "--index", idx, "--num", "300", "--length", "64",
                      "--seed", "4"])
        cli.main(["compact", "--index", idx, "--device", "cpu"])
        with open_index(idx) as saved:
            assert saved.manifest["extra"]["data"]["parts"][0]["kind"] == "synthetic"
            np.testing.assert_array_equal(cli._regenerate(saved),
                                          saved.original_data())
        cli.main(["query", "--index", idx, "--verify", "parity", "--k", "2",
                  "--device", "cpu"])
        assert "scan: bit-identical" in capsys.readouterr().out

    def test_search_save(self, tmp_path, capsys):
        path = str(tmp_path / "out" / "idx.npz")
        search_cli.main(["--num-series", "2000", "--length", "64", "--queries", "3",
                         "--leaf-size", "100", "--device", "cpu", "--save", path])
        assert f"saved to {path}" in capsys.readouterr().out
        t = HerculesIndex.load(path, device=CPU)
        j = JHerculesIndex.load(path)
        assert t.layout.num_series == j.layout.num_series == 2000
        np.testing.assert_array_equal(t.layout.lrd.numpy(), np.asarray(j.layout.lrd))


@pytest.fixture(scope="module")
def bf16_seed7_store(tmp_path_factory):
    """The 4,096 x 64 bf16 store of the CLI's default seed 7."""
    idx = str(tmp_path_factory.mktemp("seed7") / "idx")
    cli.main(["build", "--out", idx, "--num", "4096", "--length", "64",
              "--codec", "bf16", "--device", "cpu"])
    return idx


class TestVerifyExact:
    """``query --verify exact``: ids equal to a float64 difference-form brute
    force and dists within 1e-5. The matmul-identity oracle it replaces lost
    up to 3.9e-5 at distances near 3 on this store and refused exact
    answers of every backend."""

    @pytest.mark.parametrize("backend", ["local", "ooc-local"])
    def test_exact_answers_pass(self, bf16_seed7_store, capsys, backend):
        cli.main(["query", "--index", bf16_seed7_store, "--backend", backend,
                  "--queries", "16", "--difficulty", "5%", "--verify", "exact",
                  "--device", "cpu"])
        assert "exact vs brute force: OK" in capsys.readouterr().out

    def test_oracle_is_a_float64_difference_scan(self, monkeypatch):
        rng = np.random.default_rng(12)
        data = rng.standard_normal((300, 24)).astype(np.float32)
        data[200] = data[17]                     # a tie: the lower id wins
        q = torch.from_numpy(np.stack([data[17], data[5] + 0.01]))
        d, i = cli._exact_oracle(data, q, 3)
        want = ((data[None].astype(np.float64)
                 - q.numpy()[:, None].astype(np.float64)) ** 2).sum(-1)
        np.testing.assert_array_equal(i.numpy(), np.argsort(want, 1, kind="stable")[:, :3])
        # float64 sums in another order: equal to ~1e-16 relative
        np.testing.assert_allclose(d.numpy(), np.sort(want, 1)[:, :3], rtol=1e-12)
        assert i[0, :2].tolist() == [17, 200]
        monkeypatch.setattr(cli, "_ORACLE_BLOCK_ELEMS", 2 * 24 * 7)   # blocks of 7 rows
        d7, i7 = cli._exact_oracle(data, q, 3)
        assert torch.equal(d7, d) and torch.equal(i7, i)

    def test_wrong_ids_are_refused(self, bf16_seed7_store, monkeypatch):
        """Ids are held now, not only dists: an answer whose ids are off
        fails even where its dists pass."""
        real = cli._exact_oracle

        def shifted(data, queries, k):
            d, i = real(data, queries, k)
            return d, i + 1

        monkeypatch.setattr(cli, "_exact_oracle", shifted)
        with pytest.raises(SystemExit, match="ids differ"):
            cli.main(["query", "--index", bf16_seed7_store, "--verify", "exact",
                      "--device", "cpu"])
