"""Port vs reference: chunk sources and chunk readers.

The port's readers must hand out the reference's bytes (data rows, zeroed
pad rows) in submission order in both prefetch modes, stage tensors that
own their memory (never a view of a reusable slot or of a memory map),
surface reader-side failures at ``get()``, and join their thread on
``close()`` (the autouse fixture in ``conftest.py`` fails any test that
leaks a ``repro-chunk-reader`` thread). Everything here is exact.
"""
import threading

import numpy as np
import pytest
import torch

from repro.data import pipeline as JP
from repro_torch.data import pipeline as TP
from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def rows(num=1000, width=24, seed=0):
    return np.random.default_rng(seed).standard_normal((num, width)).astype(np.float32)


EXTENTS = [(0, 100, 100), (37, 50, 64), (990, 10, 128), (500, 128, 128), (3, 1, 1)]


@pytest.mark.parametrize("prefetch", ["sync", "thread"])
def test_reader_bytes_match_reference(prefetch):
    data = rows()
    want, got = [], []
    jr = JP.make_chunk_reader(data, 128, data.shape[1], prefetch=prefetch)
    tr = TP.make_chunk_reader(data, 128, data.shape[1], prefetch=prefetch, device=CPU)
    try:
        for reader in (jr, tr):
            for start, cnt, pad_to in EXTENTS:
                reader.submit(start, cnt, pad_to)
        for start, cnt, pad_to in EXTENTS:
            want.append(np.array(jr.get(), copy=True))
            staged = tr.stage(tr.get())
            assert isinstance(staged, torch.Tensor) and staged.device == CPU
            got.append(staged.numpy())
    finally:
        jr.close()
        tr.close()
    for (start, cnt, pad_to), w, g in zip(EXTENTS, want, got):
        assert g.shape == (pad_to, data.shape[1])
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g[:cnt], data[start:start + cnt])
        assert not g[cnt:].any()                 # pad rows are zeros
    assert tr.stats["blocks"] == len(EXTENTS)
    assert set(TP.READ_STAT_KEYS) <= set(tr.stats)


@pytest.mark.parametrize("prefetch", ["sync", "thread"])
@pytest.mark.parametrize("chunk", [100, 333, 1000, 4096])
def test_device_chunks_sync_thread_parity(prefetch, chunk):
    data = rows(1000)
    src = TP.ArrayChunkSource(data, chunk)
    tele: dict = {}
    got = list(TP.iter_device_chunks(src, CPU, prefetch=prefetch, telemetry=tele))
    assert [s for s, _ in got] == list(range(0, 1000, chunk))
    np.testing.assert_array_equal(torch.cat([c for _, c in got]).numpy(), data)
    assert set(TP.READ_STAT_KEYS) <= set(tele)
    host = list(TP.iter_host_chunks(src, prefetch=prefetch, telemetry={}))
    assert [s for s, _ in host] == [s for s, _ in got]
    ref = list(JP.iter_chunks(JP.ArrayChunkSource(data, chunk)))
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b)


def test_staged_tensor_survives_slot_reuse():
    """Mutating the slot after stage() (what the reader thread does when it
    refills it) must not reach the staged tensor, and every staged block
    keeps its own bytes across many slot refills."""
    data = rows(2000)
    reader = TP.make_chunk_reader(data, 64, data.shape[1], prefetch="thread",
                                  slots=2, device=CPU)
    try:
        staged = []
        for i in range(20):
            reader.submit(i * 64, 64)
        for i in range(20):
            view = reader.get()
            t = reader.stage(view)
            view[:] = -7.0                       # scribble over the slot
            assert not np.shares_memory(t.numpy(), view)
            staged.append(t)
        for i, t in enumerate(staged):
            np.testing.assert_array_equal(t.numpy(), data[i * 64:(i + 1) * 64])
    finally:
        reader.close()


def test_memmap_source_stages_owned_copies(tmp_path):
    data = rows(300)
    fp = str(tmp_path / "x.npy")
    np.save(fp, data)
    src = TP.NpyChunkSource(fp, 128)
    assert (src.num_series, src.series_len, src.num_chunks) == (300, 24, 3)
    for prefetch in ("sync", "thread"):
        for start, t in TP.iter_device_chunks(src, CPU, prefetch=prefetch):
            assert t.is_contiguous() and t.untyped_storage().data_ptr() != 0
            np.testing.assert_array_equal(t.numpy(), data[start:start + 128])
            t.fill_(0.0)                         # writable: owned, not the map
    np.testing.assert_array_equal(np.load(fp), data)


def test_thread_joins_on_close_and_errors_surface():
    data = rows(100)
    reader = TP.make_chunk_reader(data, 32, 24, prefetch="thread", device=CPU)
    assert any(t.name == TP.AsyncChunkReader.THREAD_NAME for t in threading.enumerate())
    reader.submit(0, 10)
    reader.get()
    reader.close()
    reader.close()                               # idempotent
    assert not reader._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        reader.submit(0, 1)

    class Broken:
        def __getitem__(self, sl):
            raise OSError("disk on fire")

    reader = TP.make_chunk_reader(Broken(), 32, 24, prefetch="thread", device=CPU)
    try:
        reader.submit(0, 4)
        with pytest.raises(OSError, match="disk on fire"):
            reader.get()
        with pytest.raises(RuntimeError, match="already failed"):
            reader.get()
    finally:
        reader.close()
    assert not reader._thread.is_alive()


@pytest.mark.parametrize("prefetch", ["sync", "thread"])
def test_reader_argument_checks(prefetch):
    reader = TP.make_chunk_reader(rows(10), 8, 24, prefetch=prefetch, device=CPU)
    try:
        with pytest.raises(ValueError, match="slot capacity"):
            reader.submit(0, 4, pad_to=9)
        with pytest.raises(ValueError, match="positive"):
            reader.submit(0, 0)
        with pytest.raises(RuntimeError, match="without a pending"):
            reader.get()
    finally:
        reader.close()
    with pytest.raises(ValueError, match="prefetch"):
        TP.make_chunk_reader(rows(10), 8, 24, prefetch="eager", device=CPU)
    with pytest.raises(ValueError, match="chunk_size"):
        TP.ArrayChunkSource(rows(10), 0)
    assert TP.PREFETCH_MODES == JP.PREFETCH_MODES
    assert TP.READ_STAT_KEYS == JP.READ_STAT_KEYS
    assert TP.AsyncChunkReader.THREAD_NAME == JP.AsyncChunkReader.THREAD_NAME
