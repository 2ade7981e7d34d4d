"""The LM loader, and chunk sources and chunk readers for the out-of-core
build and serving.

Port of ``repro/data/pipeline.py``.

* :class:`DoubleBufferedLoader` hands out batch t of a deterministic batch
  function while batch t+1 is already staged on the device (the paper's
  DBuffer, §3.3, for training batches). Its state is the next step, so a
  restarted worker regenerates the same stream. Like the reference's, it
  runs no thread: the overlap comes from an asynchronous host-to-device
  copy.
* A :class:`ChunkSource` carves one series collection into fixed-size row
  chunks with stable boundaries, re-iterable any number of times (the
  chunked build makes two passes per round). :class:`ArrayChunkSource`
  wraps a host array; :class:`NpyChunkSource` memory-maps a ``.npy`` file.
* The chunk readers (:func:`make_chunk_reader`) schedule the disk reads:
  :class:`SyncChunkReader` reads inline when asked; :class:`AsyncChunkReader`
  fills a bounded set of reusable host slots from a daemon thread (the
  paper's DBuffer coordinator), so read, host-to-device copy and device
  compute overlap. Extents are served strictly in submission order, so both
  modes give bit-identical answers.
* :func:`iter_device_chunks` streams a whole source to the device with two
  chunks in flight; :func:`iter_host_chunks` streams it on the host.
* :func:`iter_scheduled_chunks` fetches an ordered list of extents through
  one reader, each once, and asks the caller right before each submit
  whether the extent is still needed (the wave path's run scheduler).

Staging. ``reader.stage(view)`` always returns a tensor that owns its
memory: a reader slot is refilled by the reader thread and a memory map
dies with its index handle, so a tensor that aliased either would change or
fault under the consumer.
On a CUDA device the threaded reader's slots are pinned host tensors; the
copy runs on a side stream with ``non_blocking=True``, the consumer's
stream waits on a CUDA event recorded after it, and a slot goes back to the
reader thread only once that event has completed. The loader stages the
same way, from a pinned copy of each array that it makes itself. Under ``REPRO_SANITIZE=1``
every recycle (at ``get()`` and ``close()``) first poisons the rows the slot
handed out and then checks each tensor staged from it against a snapshot
(``analysis/sanitize.py``), so a stage that aliased the slot raises there.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, Iterator, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.analysis import sanitize
from repro_torch.device import resolve_device

PREFETCH_MODES = ("sync", "thread")


class DoubleBufferedLoader:
    """Prefetching loader over a deterministic batch function.

    ``make_batch(step)`` returns a dict (or list) of numpy arrays or CPU
    tensors, nested freely, and must be pure in ``step``. Batch
    ``start_step`` is staged on ``device`` (default: the CUDA device) at
    construction; each ``next()`` hands out the staged batch and stages
    the following one. Every staged tensor owns its memory, so
    ``make_batch`` may reuse its arrays. On a CUDA device each array is
    copied into a fresh pinned host tensor, then to the device on a side
    stream (``non_blocking``); the consumer's current stream waits on the
    event behind that copy when the batch is handed out, so the copy of
    t+1 overlaps the consumer's work on t."""

    def __init__(self, make_batch: Callable[[int], dict], start_step: int = 0,
                 device: str | torch.device | None = None):
        self._make = make_batch
        self._step = int(start_step)
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)
        self._next = self._stage(self._step)

    def _stage(self, step: int) -> tuple:
        host = self._make(step)
        if self._stream is None:
            return _map_leaves(_owned_cpu, host), None
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)           # outputs may reuse freed memory
        batch = _map_leaves(self._copy_to_device, host)
        event = torch.cuda.Event()
        event.record(self._stream)
        return batch, event

    def _copy_to_device(self, leaf) -> torch.Tensor:
        """A pinned copy of ``leaf`` (the caching host allocator keeps it
        until the copy behind it completes), copied on the side stream."""
        src = torch.as_tensor(leaf)
        pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        pinned.copy_(src)
        out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        with torch.cuda.stream(self._stream):
            out.copy_(pinned, non_blocking=True)
        return out

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        batch, event = self._next
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        self._step += 1
        self._next = self._stage(self._step)    # prefetch t+1 while t runs
        return batch

    @property
    def state(self) -> int:
        """Checkpointable pipeline state: the next step index."""
        return self._step


def _map_leaves(fn, tree):
    """``fn`` over the arrays of a nested dict/list/tuple batch."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _owned_cpu(leaf) -> torch.Tensor:
    """A CPU tensor holding a contiguous copy of ``leaf``, never an alias."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().clone(memory_format=torch.contiguous_format)
    return _owned_copy(np.asarray(leaf), torch.device("cpu"))


# ---------------------------------------------------------------------------
# Chunk sources (out-of-core ingest)
# ---------------------------------------------------------------------------

@runtime_checkable
class ChunkSource(Protocol):
    """A series collection carved into fixed-size row chunks.

    Chunk boundaries are a pure function of (num_series, chunk_size), so
    repeated iterations see identical chunks. ``chunk(i)`` returns host rows
    ``[i * chunk_size, min((i + 1) * chunk_size, num_series))``.
    """

    num_series: int
    series_len: int
    chunk_size: int

    @property
    def num_chunks(self) -> int: ...

    def chunk(self, i: int) -> np.ndarray: ...


class _ChunkedBase:
    """Shared chunk arithmetic over a row-sliceable backing store."""

    def __init__(self, rows, chunk_size: int, dtype=np.float32):
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        self._rows = rows
        self.num_series = int(rows.shape[0])
        self.series_len = int(rows.shape[1])
        self.chunk_size = int(chunk_size)
        # float32 raw series by default; encoded sources stream uint8 rows
        self.dtype = np.dtype(dtype)

    @property
    def num_chunks(self) -> int:
        return -(-self.num_series // self.chunk_size)

    def chunk(self, i: int) -> np.ndarray:
        if not 0 <= i < self.num_chunks:
            raise IndexError(f"chunk {i} out of range ({self.num_chunks})")
        lo = i * self.chunk_size
        hi = min(lo + self.chunk_size, self.num_series)
        return np.asarray(self._rows[lo:hi], dtype=self.dtype)


class ArrayChunkSource(_ChunkedBase):
    """Chunk view over a host (N, n) array (numpy or a memory map)."""

    def __init__(self, data, chunk_size: int, dtype=np.float32):
        super().__init__(np.asarray(data), chunk_size, dtype)


class NpyChunkSource(_ChunkedBase):
    """Chunk view over an on-disk ``.npy`` file via ``np.load(mmap_mode="r")``:
    rows reach RAM only when a chunk is sliced."""

    def __init__(self, path: str, chunk_size: int):
        mm = np.load(path, mmap_mode="r")
        if mm.ndim != 2:
            raise ValueError(f"{path}: expected a 2-D series collection, "
                             f"got shape {mm.shape}")
        super().__init__(mm, chunk_size)
        self.path = path


def iter_chunks(source: ChunkSource) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (row_start, host_chunk) over the whole source."""
    for i in range(source.num_chunks):
        yield i * source.chunk_size, source.chunk(i)


# ---------------------------------------------------------------------------
# Chunk readers (the paper's DBuffer coordinator)
# ---------------------------------------------------------------------------

READ_STAT_KEYS = ("read_seconds", "read_wait_seconds", "overlap_blocks")


def _tally(telemetry: dict | None, stats: dict) -> None:
    """Accumulate a reader's read-timing stats into a shared telemetry dict
    (``blocks`` is left out: consumers count their own blocks)."""
    if telemetry is None:
        return
    for key in READ_STAT_KEYS:
        telemetry[key] = telemetry.get(key, 0) + stats[key]


def _owned_copy(view: np.ndarray, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` holding a copy of ``view``, never an alias."""
    host = torch.from_numpy(np.ascontiguousarray(view))
    return host.clone() if device.type == "cpu" else host.to(device)


class SyncChunkReader:
    """Inline reads behind the reader surface (``prefetch="sync"``).

    ``get()`` performs the read it was submitted, into a fresh array (data
    rows copied out of the store, pad rows zeroed). The copy faults the
    store's pages inside the timed region, so ``read_wait_seconds`` counts
    the real synchronous disk wait; ``overlap_blocks`` stays 0. Submission
    bounds match the threaded reader's slot capacity, so a consumer that
    works in one mode works in the other.
    """

    def __init__(self, rows, capacity_rows: int, width: int,
                 dtype=np.float32, *, slots: int = 2,
                 device: str | torch.device | None = None):
        del slots
        self._rows = rows
        self._capacity = max(int(capacity_rows), 1)
        self._width = int(width)
        self._dtype = np.dtype(dtype)
        self.device = resolve_device(device)
        self._reqs: collections.deque = collections.deque()
        self.stats = {"blocks": 0, "read_seconds": 0.0,
                      "read_wait_seconds": 0.0, "overlap_blocks": 0}
        self._closed = False

    def submit(self, start: int, count: int, pad_to: int | None = None):
        if self._closed:
            raise RuntimeError("reader is closed")
        if count <= 0:
            raise ValueError(f"count must be positive, got {count}")
        pad_to = count if pad_to is None else pad_to
        if not count <= pad_to <= self._capacity:
            raise ValueError(f"pad_to={pad_to} outside [count={count}, "
                             f"slot capacity={self._capacity}]")
        self._reqs.append((int(start), int(count), int(pad_to)))

    def get(self) -> np.ndarray:
        if self._closed:
            raise RuntimeError("reader is closed")
        if not self._reqs:
            raise RuntimeError("get() without a pending submit()")
        start, count, pad_to = self._reqs.popleft()
        t0 = time.perf_counter()
        out = np.empty((pad_to, self._width), self._dtype)
        out[:count] = self._rows[start:start + count]
        if pad_to > count:
            out[count:] = 0
        dt = time.perf_counter() - t0
        self.stats["read_seconds"] += dt
        self.stats["read_wait_seconds"] += dt
        self.stats["blocks"] += 1
        return out

    def stage(self, view: np.ndarray, *, block: bool = True) -> torch.Tensor:
        """Copy a fetched block to the reader's device. From pageable host
        memory the copy is complete when this returns, so ``block`` (kept
        for surface parity with the threaded reader) has nothing to wait
        for."""
        del block
        return _owned_copy(view, self.device)

    def close(self) -> None:
        self._closed = True
        self._reqs.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AsyncChunkReader:
    """Daemon reader thread + bounded reusable host slots (DBuffer, §3.3).

    ``rows`` is any row-sliceable store (an ``np.memmap``, an ndarray).
    ``submit(start, count, pad_to)`` enqueues one extent; ``get()`` serves
    extents strictly in submission order as views into one of ``slots``
    reusable ``(capacity_rows, width)`` host arrays. A view is valid only
    until the next ``get()`` or ``close()``: move it off the slot with
    :meth:`stage` first. Rows past ``count`` up to ``pad_to`` are zeroed.
    A reader-side exception re-raises at the ``get()`` of the failing
    extent and ends the stream. ``close()`` is idempotent, unblocks the
    thread wherever it waits, and joins it.

    On a CUDA device the slots are pinned, :meth:`stage` copies on a side
    stream, and a slot is handed back to the thread (at the next ``get()``)
    only after the event recorded behind its last copy has completed.
    """

    THREAD_NAME = "repro-chunk-reader"

    def __init__(self, rows, capacity_rows: int, width: int,
                 dtype=np.float32, *, slots: int = 2,
                 device: str | torch.device | None = None):
        if slots < 2:
            raise ValueError("need at least two slots (one computing, one "
                             "filling)")
        self.device = resolve_device(device)
        self._rows = rows
        shape = (max(int(capacity_rows), 1), int(width))
        tdtype = torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
        pin = self.device.type == "cuda"
        self._slot_t = [torch.empty(shape, dtype=tdtype, pin_memory=pin)
                        for _ in range(slots)]
        self._slots = [t.numpy() for t in self._slot_t]
        # per slot: the event behind its last staged copy (CUDA only)
        self._copied: dict[int, torch.cuda.Event] = {}
        self._copy_stream = torch.cuda.Stream(self.device) if pin else None
        self._requests: queue.SimpleQueue = queue.SimpleQueue()
        self._free: queue.SimpleQueue = queue.SimpleQueue()
        for i in range(slots):
            self._free.put(i)
        self._ready: queue.SimpleQueue = queue.SimpleQueue()
        self._held: int | None = None
        self._pending = 0
        self._stop = threading.Event()
        self._closed = False
        self._exc: BaseException | None = None
        self.stats = {"blocks": 0, "read_seconds": 0.0,
                      "read_wait_seconds": 0.0, "overlap_blocks": 0}
        # REPRO_SANITIZE=1: (slot, host snapshot, staged tensor, copy event)
        # per stage(), checked against the poisoned slot when it is recycled
        self._sanitize = sanitize.sanitize_enabled()
        self._staged_tracks: list = []
        self._handed: dict[int, int] = {}       # slot -> rows of its last view
        self._thread = threading.Thread(target=self._run,
                                        name=self.THREAD_NAME, daemon=True)
        self._thread.start()

    # -- reader thread -------------------------------------------------------

    def _fill(self, buf: np.ndarray, start: int, count: int,
              pad_to: int) -> None:
        buf[:count] = self._rows[start:start + count]
        if pad_to > count:
            buf[count:pad_to] = 0

    def _run(self) -> None:
        while True:
            req = self._requests.get()
            if req is None or self._stop.is_set():
                break
            sid = self._free.get()
            if sid is None or self._stop.is_set():
                break
            start, count, pad_to = req
            t0 = time.perf_counter()
            try:
                self._fill(self._slots[sid], start, count, pad_to)
            except BaseException as e:          # propagate to the consumer
                self._ready.put((None, 0, 0.0, e))
                break
            # the read time rides the ready tuple: the thread never touches
            # self.stats, which the consumer owns
            self._ready.put((sid, pad_to, time.perf_counter() - t0, None))

    # -- consumer side -------------------------------------------------------

    def _check_alive(self) -> None:
        if self._closed:
            raise RuntimeError("reader is closed")
        if self._exc is not None:
            raise RuntimeError("reader stream already failed") from self._exc

    def submit(self, start: int, count: int, pad_to: int | None = None):
        self._check_alive()
        if count <= 0:
            raise ValueError(f"count must be positive, got {count}")
        pad_to = count if pad_to is None else pad_to
        if not count <= pad_to <= self._slots[0].shape[0]:
            raise ValueError(f"pad_to={pad_to} outside [count={count}, "
                             f"slot capacity={self._slots[0].shape[0]}]")
        self._pending += 1
        self._requests.put((int(start), int(count), int(pad_to)))

    def _wait_copied(self, sid: int) -> None:
        ev = self._copied.pop(sid, None)
        if ev is not None:
            ev.synchronize()

    def get(self) -> np.ndarray:
        self._check_alive()
        if self._pending <= 0:
            raise RuntimeError("get() without a pending submit()")
        self._pending -= 1
        if self._held is not None:              # recycle the previous slot
            self._recycle(self._held)
            self._held = None
        overlapped = not self._ready.empty()    # read finished before asked
        t0 = time.perf_counter()
        sid, n_rows, read_s, exc = self._ready.get()
        self.stats["read_wait_seconds"] += time.perf_counter() - t0
        if exc is not None:
            # the thread has exited: latch the failure so later calls fail
            # loudly instead of blocking forever
            self._exc = exc
            raise exc
        self.stats["read_seconds"] += read_s
        self.stats["overlap_blocks"] += int(overlapped)
        self.stats["blocks"] += 1
        self._held = sid
        self._handed[sid] = n_rows
        return self._slots[sid][:n_rows]

    def _recycle(self, sid: int) -> None:
        """Hand a slot back to the reader thread once its last copy has
        completed. Under REPRO_SANITIZE=1 the rows the slot handed out are
        poisoned first (a slot holds a whole stream block; a leaf run uses
        its head), then every tensor staged from it is checked against its
        snapshot: an alias shows the canary and raises before the thread
        can refill the slot under it."""
        self._wait_copied(sid)
        if self._sanitize:
            sanitize.poison(self._slots[sid][:self._handed.get(sid, 0)])
            self._verify_staged(sid)
        self._free.put(sid)

    def _verify_staged(self, sid: int | None) -> None:
        """Check (and forget) the tracked stages of slot ``sid`` (all of
        them for ``None``)."""
        tracked = [t for t in self._staged_tracks if sid is None or t[0] == sid]
        self._staged_tracks = [t for t in self._staged_tracks
                               if not (sid is None or t[0] == sid)]
        for slot_id, snap, staged, event in tracked:
            sanitize.verify_staged(staged, snap, slot_id=slot_id, event=event)

    def stage(self, view: np.ndarray, *, block: bool = True) -> torch.Tensor:
        """Copy the view of the held slot to the reader's device; the
        result owns its memory.

        On a CUDA device the copy is issued on the side stream and the
        current stream waits for it. ``block=True`` also waits on the host
        until the copy is done (the slot may then be mutated at once);
        ``block=False`` returns at once, and the slot still goes back to the
        reader thread only after the copy (see :meth:`get`)."""
        if self._copy_stream is None:
            out = _owned_copy(view, self.device)
            self._track(view, out, None)
            return out
        sid = self._held
        if sid is None or not np.may_share_memory(view, self._slots[sid]):
            raise ValueError("stage() takes the view the last get() returned")
        src = self._slot_t[sid][:view.shape[0]]
        cur = torch.cuda.current_stream(self.device)
        out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        self._copy_stream.wait_stream(cur)      # `out` may reuse freed memory
        with torch.cuda.stream(self._copy_stream):
            out.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._copy_stream)
        cur.wait_event(ev)
        self._copied[sid] = ev
        if block:
            ev.synchronize()
        self._track(view, out, ev)
        return out

    def _track(self, view: np.ndarray, out: torch.Tensor, event) -> None:
        if self._sanitize and self._held is not None:
            self._staged_tracks.append(
                (self._held, sanitize.snapshot(view), out, event))

    def close(self) -> None:
        """Idempotent: stops and joins the reader thread (sentinels unblock
        it from whichever queue it waits on), invalidating every view."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._requests.put(None)
        self._free.put(None)
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():             # pragma: no cover
            raise RuntimeError("chunk reader thread failed to join")
        for sid in list(self._copied):          # no copy may outlive a slot
            self._wait_copied(sid)
        self._held = None
        if self._sanitize:
            # the last sweep: nothing refills the slots now; poison what
            # each handed out and check every stage still tracked
            for sid, rows in self._handed.items():
                sanitize.poison(self._slots[sid][:rows])
            self._verify_staged(None)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:                       # pragma: no cover
            pass


def make_chunk_reader(rows, capacity_rows: int, width: int,
                      dtype=np.float32, *, prefetch: str = "sync",
                      slots: int = 2,
                      device: str | torch.device | None = None):
    """Reader over a row-sliceable store that stages onto ``device``
    (default: the CUDA device): ``"thread"`` -> :class:`AsyncChunkReader`,
    ``"sync"`` -> :class:`SyncChunkReader` (same surface, same bytes)."""
    if prefetch not in PREFETCH_MODES:
        raise ValueError(f"prefetch={prefetch!r}; expected one of "
                         f"{PREFETCH_MODES}")
    cls = AsyncChunkReader if prefetch == "thread" else SyncChunkReader
    return cls(rows, capacity_rows, width, dtype, slots=slots, device=device)


class _SourceRows:
    """Row-sliceable adapter over a protocol-only :class:`ChunkSource`
    (slices must start on the source's chunk boundaries)."""

    def __init__(self, source: ChunkSource):
        self._source = source

    def __getitem__(self, sl: slice) -> np.ndarray:
        i, rem = divmod(sl.start, self._source.chunk_size)
        if rem:
            raise ValueError(f"row {sl.start} is not a chunk boundary of "
                             f"chunk_size={self._source.chunk_size}")
        return self._source.chunk(i)[:sl.stop - sl.start]


def _source_rows(source: ChunkSource):
    """The source's backing store when it has one (memmap reads land
    straight in the slot), else the chunk-aligned adapter."""
    rows = getattr(source, "_rows", None)
    return _SourceRows(source) if rows is None else rows


def _whole_source_reader(source: ChunkSource, prefetch: str,
                         device: torch.device):
    """A reader with every chunk of ``source`` submitted, in order."""
    reader = make_chunk_reader(_source_rows(source), source.chunk_size,
                               source.series_len,
                               getattr(source, "dtype", np.float32),
                               prefetch=prefetch, device=device)
    num = source.num_series
    for i in range(source.num_chunks):
        lo = i * source.chunk_size
        reader.submit(lo, min(source.chunk_size, num - lo))
    return reader


def iter_host_chunks(source: ChunkSource, prefetch: str = "sync",
                     telemetry: dict | None = None
                     ) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (row_start, host_chunk) over the whole source through a chunk
    reader. With ``prefetch="thread"`` the chunk is a reusable slot view,
    valid only until the next iteration: consume (copy or scatter) it
    before advancing. Reader stats accumulate into ``telemetry``."""
    if prefetch == "sync" and telemetry is None:
        yield from iter_chunks(source)
        return
    reader = _whole_source_reader(source, prefetch, torch.device("cpu"))
    try:
        for i in range(source.num_chunks):
            yield i * source.chunk_size, reader.get()
    finally:
        reader.close()
        _tally(telemetry, reader.stats)


def iter_device_chunks(source: ChunkSource,
                       device: str | torch.device | None = None,
                       prefetch: str = "sync",
                       telemetry: dict | None = None
                       ) -> Iterator[tuple[int, torch.Tensor]]:
    """Yield (row_start, device_chunk) with two chunks in flight (DBuffer).

    Chunk i+1 is read and its copy issued before chunk i is yielded. With
    ``prefetch="thread"`` the reads themselves run ahead on the reader
    thread, so read, copy and compute all overlap. Every yielded tensor owns
    its memory. ``device`` defaults to the CUDA device. Read stats
    accumulate into ``telemetry``.
    """
    dev = resolve_device(device)
    if prefetch not in PREFETCH_MODES:
        raise ValueError(f"prefetch={prefetch!r}; expected one of "
                         f"{PREFETCH_MODES}")
    n = source.num_chunks
    if n == 0:
        return
    reader = _whole_source_reader(source, prefetch, dev)
    try:
        staged = reader.stage(reader.get(), block=False)
        for i in range(n):
            cur = staged
            if i + 1 < n:
                # get() hands cur's slot back to the reader only after cur's
                # copy has completed
                staged = reader.stage(reader.get(), block=False)
            yield i * source.chunk_size, cur
    finally:
        reader.close()
        _tally(telemetry, reader.stats)


def iter_scheduled_chunks(reader, requests, still_needed=None,
                          lookahead: int = 2
                          ) -> Iterator[tuple[object, torch.Tensor]]:
    """Demand-scheduled fetches over one shared chunk reader (the wave
    path's multi-consumer submissions).

    ``requests`` is an ordered iterable of ``(tag, start, count, pad_to)``,
    typically leaf runs sorted by how many consumers still need them. Each
    surviving request is fetched once and yielded as ``(tag,
    staged_rows)`` on the reader's device; the tag tells the caller which
    run (and so which consumers) the block belongs to.

    ``still_needed(tag) -> bool`` is consulted immediately before each
    ``submit()``, as late as possible, so a run whose every interested
    consumer has since been satisfied is dropped without touching the
    disk. ``lookahead`` bounds the submissions in flight: large enough that
    reads overlap the consumer's compute (the reader's slot pair), small
    enough that the drop decision still sees a recent bound.
    """
    if lookahead < 1:
        raise ValueError(f"lookahead={lookahead}; expected >= 1")
    pending: collections.deque = collections.deque()
    it = iter(requests)

    def pump() -> None:
        while len(pending) < lookahead:
            for tag, start, count, pad_to in it:
                if still_needed is None or still_needed(tag):
                    reader.submit(start, count, pad_to)
                    pending.append(tag)
                    break
            else:
                return

    pump()
    while pending:
        tag = pending.popleft()
        rows = reader.stage(reader.get())
        pump()                       # refill the window before the consumer
        yield tag, rows              # computes, so the next read overlaps
