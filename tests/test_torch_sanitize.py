"""The port's runtime sanitizer (``REPRO_SANITIZE=1``): the reader's slot
canaries and the memory-map use-after-close guards
(``repro_torch/analysis/sanitize.py``, wired into ``data/pipeline.py`` and
``storage/format.py``). Mirrors ``tests/test_analysis.py::TestSlotCanary``
and ``::TestUseAfterCloseGuard``; the sanitized index answers are held bit
for bit to the same index opened without the sanitizer.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import sanitize
from repro_torch.core.engine import QueryEngine, make_disk_backend
from repro_torch.core.index import IndexConfig
from repro_torch.core.search import SearchConfig
from repro_torch.core.tree import BuildConfig
from repro_torch.data import pipeline as TP
from repro_torch.storage import Hercules, open_index
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"


@pytest.fixture
def sanitized(monkeypatch):
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    assert sanitize.sanitize_enabled()


def _drain(reader, n_chunks, chunk):
    for i in range(n_chunks):
        reader.submit(i * chunk, chunk)


def _alias(monkeypatch):
    """A stage that returns a tensor aliasing the slot (``torch.from_numpy``
    of the view): the bug class the canaries exist for."""
    monkeypatch.setattr(TP, "_owned_copy", lambda view, device: torch.from_numpy(view))


class TestSlotCanary:
    @pytest.mark.parametrize("dtype", [np.float32, np.uint8])
    def test_aliased_stage_trips_canary(self, sanitized, monkeypatch, dtype):
        _alias(monkeypatch)
        rows = np.arange(64).reshape(8, 8).astype(dtype)
        reader = TP.AsyncChunkReader(rows, 4, 8, dtype, device=CPU)
        try:
            _drain(reader, 2, 4)
            reader.stage(reader.get())
            with pytest.raises(sanitize.SanitizerError, match="aliases reader slot"):
                reader.get()            # recycles the aliased slot
        finally:
            reader.close()

    def test_alias_of_the_last_slot_trips_at_close(self, sanitized, monkeypatch):
        """``close()`` is a recycle too: it poisons every slot and checks
        the stages still tracked."""
        _alias(monkeypatch)
        rows = np.arange(32, dtype=np.float32).reshape(4, 8)
        reader = TP.AsyncChunkReader(rows, 4, 8, device=CPU)
        reader.submit(0, 4)
        staged = reader.stage(reader.get())
        with pytest.raises(sanitize.SanitizerError, match="reader.stage()"):
            reader.close()
        assert torch.isnan(staged).all()    # the alias reads the canary now

    def test_clean_stage_does_not_trip(self, sanitized):
        rows = np.arange(256, dtype=np.float32).reshape(32, 8)
        reader = TP.AsyncChunkReader(rows, 8, 8, device=CPU)
        try:
            _drain(reader, 4, 8)
            outs = [reader.stage(reader.get()).numpy() for _ in range(4)]
        finally:
            reader.close()
        np.testing.assert_array_equal(np.concatenate(outs), rows)
        assert reader._staged_tracks == []

    def test_streams_bitwise_identical_under_sanitizer(self, sanitized):
        rows = np.random.default_rng(7).normal(size=(64, 16)).astype(np.float32)
        src = TP.ArrayChunkSource(rows, 16)
        sync = [c for _, c in TP.iter_device_chunks(src, CPU)]
        thread = [c for _, c in TP.iter_device_chunks(src, CPU, prefetch="thread")]
        for a, b in zip(sync, thread):
            assert torch.equal(a, b)

    def test_sanitizer_off_by_default(self, monkeypatch):
        monkeypatch.delenv(sanitize.ENV_VAR, raising=False)
        assert not sanitize.sanitize_enabled()
        _alias(monkeypatch)
        rows = np.arange(64, dtype=np.float32).reshape(8, 8)
        reader = TP.AsyncChunkReader(rows, 4, 8, device=CPU)
        try:
            assert reader._sanitize is False
            _drain(reader, 2, 4)
            staged = reader.stage(reader.get())
            reader.get()                # no check: the alias goes unnoticed
            assert not torch.isnan(staged).any() and reader._staged_tracks == []
        finally:
            reader.close()


class TestCanaryPieces:
    @pytest.mark.parametrize("dtype,canary", [(np.float32, np.nan), (np.uint8, 0xAB),
                                              (np.int32, 0xAB), (np.bool_, False)])
    def test_poison(self, dtype, canary):
        buf = np.ones((3, 4), dtype)
        sanitize.poison(buf)
        np.testing.assert_array_equal(buf, np.full((3, 4), canary, dtype))

    def test_snapshot_is_a_copy(self):
        view = np.arange(6, dtype=np.float32)
        snap = sanitize.snapshot(view)
        view[:] = 0
        np.testing.assert_array_equal(snap, np.arange(6, dtype=np.float32))

    def test_verify_staged(self):
        snap = np.array([1.0, np.nan], np.float32)
        sanitize.verify_staged(torch.tensor([1.0, float("nan")]), snap, slot_id=0)
        with pytest.raises(sanitize.SanitizerError, match="aliases reader slot 3"):
            sanitize.verify_staged(torch.tensor([2.0, float("nan")]), snap, slot_id=3)

    def test_verify_staged_waits_for_the_copy_event(self):
        """The staged tensor is read only after its copy event completes."""
        calls = []

        class Event:
            def synchronize(self):
                calls.append("synchronize")

        sanitize.verify_staged(torch.zeros(2), np.zeros(2, np.float32), slot_id=0,
                               event=Event())
        assert calls == ["synchronize"]


def _store(path, rows, codec="raw"):
    cfg = IndexConfig(build=BuildConfig(leaf_capacity=32),
                      search=SearchConfig(k=3, chunk=32, scan_block=32))
    Hercules.create(path, cfg, data=rows, chunk_size=48, codec=codec, device=CPU).close()


class TestUseAfterCloseGuard:
    def test_guard_trips_after_close(self, sanitized, tmp_path):
        rows = np.random.default_rng(3).normal(size=(64, 16)).astype(np.float32)
        path = str(tmp_path / "idx")
        _store(path, rows)
        saved = open_index(path)
        assert isinstance(saved.lrd, sanitize.MmapGuard)
        escaped = saved.lrd
        assert escaped.shape[0] >= 64 and escaped.ndim == 2 and len(escaped) >= 64
        np.testing.assert_array_equal(np.asarray(escaped)[:2],
                                      np.asarray(saved._mapped("lrd"))[:2])
        assert np.shares_memory(np.asarray(escaped), escaped[:])
        assert not np.shares_memory(np.array(escaped, copy=True), escaped[:])
        kept = torch.from_numpy(np.array(escaped[:4], copy=True))
        saved.close()
        assert saved.closed
        with pytest.raises(sanitize.UseAfterCloseError):
            escaped[0]
        with pytest.raises(sanitize.UseAfterCloseError):
            _ = escaped.shape
        with pytest.raises(sanitize.UseAfterCloseError, match="after close"):
            np.asarray(escaped)
        assert kept.shape == (4, 16)          # a copy outlives the map

    def test_encoded_sidecar_is_guarded(self, sanitized, tmp_path):
        rows = np.random.default_rng(4).normal(size=(64, 16)).astype(np.float32)
        path = str(tmp_path / "idx")
        _store(path, rows, codec="bf16")
        saved = open_index(path)
        guards = [saved.lrd, saved.lsd, saved.enc]
        assert all(isinstance(g, sanitize.MmapGuard) for g in guards)
        saved.close()
        for g in guards:
            with pytest.raises(sanitize.UseAfterCloseError):
                g[:1]
        assert "released" in repr(guards[0])

    @pytest.mark.parametrize("codec", ["raw", "bf16"])
    def test_answers_bit_identical_under_the_sanitizer(self, tmp_path, monkeypatch,
                                                       codec):
        """``local``, ``ooc-scan`` and ``ooc-local`` (both readers) over an
        index opened under REPRO_SANITIZE=1 answer as over one opened
        without it, every field bit for bit; none raises."""
        rng = np.random.default_rng(5)
        rows = rng.normal(size=(600, 16)).astype(np.float32)
        q = rows[:5] + rng.normal(size=(5, 16)).astype(np.float32) * 0.1
        path = str(tmp_path / "idx")
        _store(path, rows, codec)
        monkeypatch.delenv(sanitize.ENV_VAR, raising=False)
        runs = [("local", "sync"), ("ooc-scan", "sync"), ("ooc-scan", "thread"),
                ("ooc-local", "sync"), ("ooc-local", "thread")]

        def answer(name, prefetch):
            saved = open_index(path)
            try:
                eng = QueryEngine(make_disk_backend(
                    name, saved, memory_budget_mb=0.01, prefetch=prefetch, device=CPU,
                    search=SearchConfig(k=3, chunk=32, scan_block=32, codec=codec)))
                return [eng.knn(q, k=k) for k in (1, 3)]
            finally:
                saved.close()

        plain = {run: answer(*run) for run in runs}
        monkeypatch.setenv(sanitize.ENV_VAR, "1")
        for run in runs:
            for g, want in zip(answer(*run), plain[run]):
                for field in g._fields:
                    assert torch.equal(getattr(g, field), getattr(want, field)), \
                        (run, field)

    def test_store_queries_through_the_guard(self, sanitized, tmp_path):
        rows = np.random.default_rng(6).normal(size=(128, 16)).astype(np.float32)
        path = str(tmp_path / "idx")
        _store(path, rows)
        with Hercules.open(path, device=CPU) as hx:
            assert isinstance(hx.saved.lrd, sanitize.MmapGuard)
            q = rows[:3] + 1e-3
            res = hx.query(q, k=3, backend="ooc-local", memory_budget_mb=0.01)
        brute = np.argsort(((rows[None] - q[:, None]) ** 2).sum(-1), axis=1)[:, :3]
        np.testing.assert_array_equal(res.ids.numpy(), brute)

    def test_no_guard_when_disabled(self, monkeypatch, tmp_path):
        monkeypatch.delenv(sanitize.ENV_VAR, raising=False)
        rows = np.random.default_rng(7).normal(size=(64, 16)).astype(np.float32)
        path = str(tmp_path / "idx")
        _store(path, rows, codec="bf16")
        saved = open_index(path)
        try:
            for arr in (saved.lrd, saved.lsd, saved.enc):
                assert isinstance(arr, np.memmap)
                assert not isinstance(arr, sanitize.MmapGuard)
        finally:
            saved.close()
        assert sanitize.guard_mmap(None, "x") is None
