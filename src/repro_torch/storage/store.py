"""``Hercules`` -- one handle for the whole index lifecycle, on PyTorch.

Port of ``repro/storage/store.py``: the same directory, manifest, journal
segments and file generations, so a store either package writes opens,
appends, serves and compacts in the other. One object owns creation,
incremental ingest, compaction and query serving for an index directory::

    from repro_torch import api

    with api.Hercules.create("idx/", config, data=chunks_a) as hx:
        hx.append(chunks_b)          # journal segment; atomic manifest commit
        hx.query(queries, k=5)       # exact: base index + journal merge
        hx.compact()                 # replay journal through the chunked
                                     # build; bit-identical to a from-scratch
                                     # build over A concat B
        hx.engine("ooc-local").knn(queries)

* ``append`` lands new rows in **journal segments** (raw LRD rows in append
  order + iSAX LSD sidecar, each file CRC-checksummed). The base files are
  never touched; the atomic manifest ``os.replace`` is the single commit
  point, so a crash between segment write and manifest commit leaves
  uncommitted orphans that the next writable ``open`` sweeps away.
* ``query`` stays **exact** with a pending journal: the base backend
  answers as usual and journal rows are merged in with the difference-form
  squared ED every exact path reports (``_diff_dists``), so the merged
  answers equal a dense scan over the whole collection bit for bit.
* ``compact`` replays base rows (original id order) and journal rows
  through the chunked build (``stream_base_files``) into a new file
  **generation**, then republishes the manifest atomically: bit-identical
  to a from-scratch build over A concat B.

Every handle works on one device (``device=``; ``None`` means the CUDA
device): the build, the journal's iSAX codes, the served backends and the
journal merge run there. Engines handed out by :meth:`Hercules.engine` are
cached per configuration; ``append``/``compact`` invalidate each of them
(:meth:`repro_torch.core.engine.QueryEngine.invalidate`) and drop them from
the cache, so a stale plan never serves a mutated collection.
"""
from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import summaries as S
from repro_torch.core.engine import (QueryEngine, _diff_dists,
                                     make_disk_backend, resolve_backend_name)
from repro_torch.core.index import HerculesIndex, IndexConfig
from repro_torch.core.search import INF, KnnResult, SearchConfig, _stable_smallest
from repro_torch.data.pipeline import (ChunkSource, _ChunkedBase, _owned_copy,
                                       iter_chunks)
from repro_torch.device import resolve_device
from repro_torch.storage.build import build_index_to_disk, stream_base_files
from repro_torch.storage.codecs import get_codec
from repro_torch.storage.format import (JOURNAL_DIR, LAYOUT_STATIC_FIELDS,
                                        MANIFEST_FILE, IndexFormatError,
                                        SavedIndex, _file_entry,
                                        _restore_config, codec_of,
                                        generation_of, has_base, journal_of,
                                        open_saved, read_manifest, save_index,
                                        segment_file_names, verify_files,
                                        write_manifest)

# files a crashed (uncommitted) mutation may leave behind; anything matching
# that the manifest does not reference is swept by a writable open
_ORPHAN_BASE_RE = re.compile(
    r"^(?:tree|layout)(?:-\d{5})?\.npz$|^(?:lrd|lsd|enc)(?:-\d{5})?\.npy$"
    r"|^manifest\.json\.tmp$|^compact-base\.npy$")
_ORPHAN_SEG_RE = re.compile(r"^seg-\d{5}\.(?:lrd|lsd)\.npy$")
# the compaction's scratch copy of the base rows in id order (_BaseRows)
_STAGED_BASE_FILE = "compact-base.npy"

_EMPTY_STATICS = {k: 0 for k in LAYOUT_STATIC_FIELDS}
_I32 = torch.int32


def _as_source(data, chunk_size: int) -> ChunkSource:
    if all(hasattr(data, a) for a in ("chunk", "num_chunks", "num_series")):
        return data                                  # already a ChunkSource
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu()
    arr = np.asarray(data, np.float32)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2-D series collection, got {arr.shape}")
    return _ChunkedBase(arr, chunk_size)


class _ConcatRows:
    """Row-sliceable view over base rows (original id order, gathered lazily
    from the LRD memory map) followed by journal segments (append order):
    the compaction's replay source. Reads only the rows a slice asks for."""

    def __init__(self, parts: list):
        self._parts = parts               # row-sliceable, shape (rows, n)
        self._offsets = np.cumsum([0] + [int(p.shape[0]) for p in parts])
        self.shape = (int(self._offsets[-1]), int(parts[0].shape[1]))

    def __getitem__(self, sl: slice) -> np.ndarray:
        lo, hi, step = sl.indices(self.shape[0])
        if step != 1:
            raise ValueError("the replay source reads contiguous row ranges")
        out = []
        for part, off in zip(self._parts, self._offsets[:-1]):
            p_lo = max(lo - off, 0)
            p_hi = min(hi - off, int(part.shape[0]))
            if p_lo < p_hi:
                out.append(np.asarray(part[p_lo:p_hi], np.float32))
        return out[0] if len(out) == 1 else np.concatenate(out, axis=0)


class _BaseRows:
    """A SavedIndex's LRD rows in original id order, the compaction's
    replay source for the base. The rows are permuted back through
    ``inv_perm`` once, into a scratch ``.npy`` file at ``path`` (the only
    random row reads, each block's read in position order); every pass of
    the chunked build then reads contiguous rows of that file. ``close``
    releases the map; the caller removes the file."""

    STAGE_ROWS = 1 << 16

    def __init__(self, saved: SavedIndex, path: str):
        inv_perm = np.asarray(saved.small["inv_perm"])
        lrd = saved._mapped("lrd")
        self.shape = (saved.num_series, saved.series_len)
        t0 = time.perf_counter()
        self._rows = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                               shape=self.shape)
        for lo in range(0, self.shape[0], self.STAGE_ROWS):
            pos = inv_perm[lo:lo + self.STAGE_ROWS]
            order = np.argsort(pos, kind="stable")
            block = np.empty((pos.shape[0], self.shape[1]), np.float32)
            block[order] = lrd[pos[order]]
            self._rows[lo:lo + pos.shape[0]] = block
        self.stage_seconds = time.perf_counter() - t0

    def __getitem__(self, sl: slice) -> np.ndarray:
        return self._rows[sl]

    def close(self) -> None:
        self._rows = None


def _merge_triplet(d0, p0, i0, d1, p1, i1, k: int):
    """Merge (dists, positions, ids) candidate sets (Q, a) and (Q, b) into
    the k smallest per query. A stable sort of the concatenation: ties break
    toward the earlier array (the running top-k before the block, so base
    results before journal rows, and lower ids first), as ``jax.lax.top_k``
    does on the reference's concatenation. No candidate is dropped as a
    duplicate: every journal row, and every empty slot, has position -1."""
    vals, idx = _stable_smallest(torch.cat([d0, d1], dim=1), k)
    return (vals, torch.gather(torch.cat([p0, p1], dim=1), 1, idx),
            torch.gather(torch.cat([i0, i1], dim=1), 1, idx))


class Hercules:
    """A Hercules store: one index directory, one handle, whole lifecycle.

    Modes: ``"r"`` (read/serve only) and ``"a"`` (append/compact allowed;
    also sweeps uncommitted orphan files left by a crashed mutation).
    Context-managed: ``close()`` releases the base memory maps and drops
    every cached engine.
    """

    def __init__(self, path: str, mode: str, manifest: dict,
                 device: str | torch.device | None = None):
        if mode not in ("r", "a"):
            raise ValueError(f"mode must be 'r' or 'a', got {mode!r}")
        self.device = resolve_device(device)
        self.path = path
        self.mode = mode
        self.manifest = manifest
        self.recovered: list[str] = []
        if mode == "a":
            self.recovered = self._sweep_orphans()
        self.saved: SavedIndex | None = (
            open_saved(path, manifest) if has_base(manifest) else None)
        self._engines: dict[Any, QueryEngine] = {}
        self._data_version = 0
        self._closed = False

    # -- lifecycle ----------------------------------------------------------

    @classmethod
    def create(cls, path: str, config: IndexConfig | None = None, *,
               data=None, chunk_size: int = 8192, overwrite: bool = False,
               extra_meta: dict | None = None, codec: str = "raw",
               device: str | torch.device | None = None) -> "Hercules":
        """Create a store at ``path`` (mode ``"a"``) on ``device``. With
        ``data`` (an array, a tensor or a :class:`ChunkSource`) the base
        index is built at once by the chunked streaming builder, its reader
        picked by ``config.search.prefetch``; without it the store starts
        empty and the first ``append`` + ``compact`` builds the base.
        ``codec`` selects the leaf codec of the base files
        (``repro_torch.storage.codecs``); answers are bit-identical under
        every codec."""
        get_codec(codec)  # validate before touching the directory
        dev = resolve_device(device)
        config = config or IndexConfig()
        mf = os.path.join(path, MANIFEST_FILE)
        if os.path.exists(mf):
            if not overwrite:
                raise IndexFormatError(
                    f"{path!r} already holds an index (pass overwrite=True "
                    f"to replace it, or Hercules.open(path, 'a') to extend)")
            os.remove(mf)
        os.makedirs(path, exist_ok=True)
        if data is None:
            write_manifest(path, config, 0, _EMPTY_STATICS, extra=extra_meta,
                           base=False, codec=codec)
        else:
            build_index_to_disk(_as_source(data, chunk_size), path, config,
                                extra_meta=extra_meta, codec=codec, device=dev)
        return cls.open(path, "a", device=dev)

    @classmethod
    def open(cls, path: str, mode: str = "r", verify: bool = True,
             device: str | torch.device | None = None) -> "Hercules":
        """Open an existing store. Version-1 directories open unchanged (no
        journal); their first ``append`` migrates the manifest to the
        current version."""
        manifest = read_manifest(path)
        if verify:
            verify_files(path, manifest)
        return cls(path, mode, manifest, device)

    @classmethod
    def from_index(cls, path: str, index: HerculesIndex,
                   extra_meta: dict | None = None,
                   device: str | torch.device | None = None) -> "Hercules":
        """Persist an in-memory :class:`HerculesIndex` and return the live
        store handle on ``device``."""
        save_index(index, path, extra_meta=extra_meta)
        return cls.open(path, "a", device=device)

    def close(self) -> None:
        """Release the base memory maps and drop cached engines. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._engines.clear()
        if self.saved is not None:
            self.saved.close()

    def __enter__(self) -> "Hercules":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- introspection ------------------------------------------------------

    @property
    def config(self) -> IndexConfig:
        return _restore_config(self.manifest)

    @property
    def journal(self) -> dict:
        return journal_of(self.manifest)

    @property
    def generation(self) -> int:
        return generation_of(self.manifest)

    @property
    def base_rows(self) -> int:
        return self.saved.num_series if self.saved is not None else 0

    @property
    def pending_rows(self) -> int:
        """Rows appended since the last compaction (journal-resident)."""
        return self.journal["rows"]

    @property
    def num_series(self) -> int:
        return self.base_rows + self.pending_rows

    @property
    def series_len(self) -> int | None:
        if self.saved is not None:
            return self.saved.series_len
        segs = self.journal["segments"]
        return int(segs[0]["series_len"]) if segs else None

    @property
    def codec(self) -> str:
        """Leaf codec of the committed base files (``"raw"`` for v1/v2
        indexes and empty stores). Change it with ``compact(codec=...)``."""
        return codec_of(self.manifest)

    @property
    def data_version(self) -> int:
        """Bumped by every append/compact: the plan-invalidation epoch."""
        return self._data_version

    def index(self) -> HerculesIndex:
        """Materialize the base as an in-memory index on the handle's
        device. Refuses while journal rows are pending: compact first, so
        the materialization cannot silently drop appended rows."""
        self._require_open()
        if self.saved is None:
            raise IndexFormatError(f"{self.path!r}: store has no base index")
        if self.pending_rows:
            raise IndexFormatError(
                f"{self.path!r}: {self.pending_rows} journal rows pending; "
                f"compact() before materializing the index")
        return self.saved.to_index(self.device)

    def describe(self) -> dict:
        return {
            "path": self.path,
            "mode": self.mode,
            "generation": self.generation,
            "base_rows": self.base_rows,
            "pending_rows": self.pending_rows,
            "journal_segments": len(self.journal["segments"]),
            "series_len": self.series_len,
            "codec": self.codec,
            "data_version": self._data_version,
            "cached_engines": len(self._engines),
        }

    # -- guards -------------------------------------------------------------

    def _require_open(self) -> None:
        if self._closed:
            raise IndexFormatError(f"{self.path!r}: store handle is closed")

    def _require_writable(self) -> None:
        self._require_open()
        if self.mode != "a":
            raise IndexFormatError(
                f"{self.path!r} is open read-only; Hercules.open(path, 'a') "
                f"to append or compact")

    # -- crash recovery -----------------------------------------------------

    def _sweep_orphans(self) -> list[str]:
        """Delete files a crashed mutation left uncommitted (present on disk
        but not named by the manifest). Safe because the manifest commit is
        atomic: anything it does not name was never part of the store."""
        keep = set()
        for name, entry in self.manifest.get("files", {}).items():
            keep.add(entry.get("path", name))
        for seg in journal_of(self.manifest)["segments"]:
            keep.update(seg.get("files", {}))
        removed = []
        for fn in sorted(os.listdir(self.path)):
            if fn in keep or not _ORPHAN_BASE_RE.match(fn):
                continue
            os.remove(os.path.join(self.path, fn))
            removed.append(fn)
        jdir = os.path.join(self.path, JOURNAL_DIR)
        if os.path.isdir(jdir):
            for fn in sorted(os.listdir(jdir)):
                rel = f"{JOURNAL_DIR}/{fn}"
                if rel in keep or not _ORPHAN_SEG_RE.match(fn):
                    continue
                os.remove(os.path.join(jdir, fn))
                removed.append(rel)
        return removed

    # -- ingest -------------------------------------------------------------

    def append(self, data, *, chunk_size: int = 8192,
               provenance: dict | None = None) -> dict:
        """Append rows as one journal segment; returns the segment record.

        The segment's LRD rows (append order) and iSAX LSD sidecar (codes
        computed on the handle's device) are written and checksummed first;
        the atomic manifest republish is the commit. Appended rows take
        original ids following the existing collection (base, then journal
        order), are visible to :meth:`query` at once (exact journal merge),
        and fold into the base at the next :meth:`compact`. Cached engines
        are invalidated.
        """
        self._require_writable()
        source = _as_source(data, chunk_size)
        if source.num_series <= 0:
            raise ValueError("append needs at least one row")
        config = self.config
        n = source.series_len
        expect = self.series_len
        if expect is not None and n != expect:
            raise ValueError(f"appended series length {n} != store series "
                             f"length {expect}")
        if n % config.sax_segments:
            raise ValueError(f"series length {n} must be divisible by "
                             f"{config.sax_segments} iSAX segments")

        journal = self.journal
        seg_id = len(journal["segments"])
        lrd_rel, lsd_rel = segment_file_names(seg_id)
        os.makedirs(os.path.join(self.path, JOURNAL_DIR), exist_ok=True)
        t0 = time.perf_counter()
        lrd = np.lib.format.open_memmap(
            os.path.join(self.path, lrd_rel), mode="w+", dtype=np.float32,
            shape=(source.num_series, n))
        lsd = np.lib.format.open_memmap(
            os.path.join(self.path, lsd_rel), mode="w+", dtype=np.uint8,
            shape=(source.num_series, config.sax_segments))
        for start, chunk in iter_chunks(source):
            lrd[start:start + chunk.shape[0]] = chunk
            lsd[start:start + chunk.shape[0]] = S.isax(
                _owned_copy(chunk, self.device), config.sax_segments).cpu().numpy()
        lrd.flush()
        lsd.flush()
        del lrd, lsd

        segment = {
            "name": f"seg-{seg_id:05d}",
            "rows": int(source.num_series),
            "series_len": int(n),
            "files": {
                lrd_rel: _file_entry(os.path.join(self.path, lrd_rel)),
                lsd_rel: _file_entry(os.path.join(self.path, lsd_rel)),
            },
        }
        journal["segments"].append(segment)
        journal["rows"] += segment["rows"]
        extra = self._extra_with_provenance(provenance)
        extra["append"] = {
            "last_rows": segment["rows"],
            "seconds": round(time.perf_counter() - t0, 4),
        }
        self.manifest = write_manifest(
            self.path, config, int(self.manifest.get("max_depth", 0)),
            self.manifest.get("layout_static", _EMPTY_STATICS), extra=extra,
            entries=self.manifest.get("files", {}), journal=journal,
            generation=self.generation, base=has_base(self.manifest),
            codec=self.codec)
        self._invalidate_engines()
        return segment

    def compact(self, chunk_size: int = 8192,
                prefetch: str | None = None,
                codec: str | None = None) -> dict:
        """Fold every journal segment into a new base-file generation.

        Replays base rows (original id order) followed by journal rows
        through the chunked build on the handle's device, so the compacted
        index is **bit-identical** to building once over the concatenated
        collection. The old generation stays valid until the atomic
        manifest commit; its files and the journal segments are swept
        afterwards. No-op when the journal is empty (unless ``codec`` asks
        for a migration). Returns the manifest.

        ``codec`` re-encodes the new generation under another leaf codec
        (``None`` keeps the store's current one).
        """
        self._require_writable()
        if codec is not None:
            get_codec(codec)  # validate before any I/O
        journal = self.journal
        target_codec = self.codec if codec is None else codec
        if not journal["segments"] and (target_codec == self.codec
                                        or self.saved is None):
            return self.manifest
        config = self.config
        gen = self.generation + 1
        t0 = time.perf_counter()
        staged_path = os.path.join(self.path, _STAGED_BASE_FILE)
        base = None
        try:
            parts: list = []
            if self.saved is not None:
                base = _BaseRows(self.saved, staged_path)
                parts.append(base)
            parts.extend(self._journal_rows())
            source = _ChunkedBase(_ConcatRows(parts), chunk_size)
            names, statics, max_depth, timings = stream_base_files(
                source, self.path, config, generation=gen, prefetch=prefetch,
                codec=target_codec, device=self.device)
        finally:
            if base is not None:
                base.close()
            parts = source = None
            if os.path.exists(staged_path):
                os.remove(staged_path)
        extra = self._extra_with_provenance(None)
        extra["build"] = timings
        extra["compact"] = {
            "generation": gen,
            "journal_rows": journal["rows"],
            "segments": len(journal["segments"]),
            "codec": target_codec,
            "stage_seconds": round(base.stage_seconds, 4) if base else 0.0,
            "seconds": round(time.perf_counter() - t0, 4),
        }
        extra.pop("append", None)
        manifest = write_manifest(
            self.path, config, max_depth, statics, extra=extra, files=names,
            journal=None, generation=gen, base=True,      # <- commit point
            codec=target_codec)

        old = self.saved
        self.manifest = manifest
        if old is not None:
            # loud staleness: anything still holding the pre-compact handle
            # raises instead of serving the old collection. Closed before
            # the sweep, so no map of a deleted file stays open
            old.close()
        self.recovered = self._sweep_orphans()   # old generation + journal
        self.saved = open_saved(self.path, manifest)
        self._invalidate_engines()
        return manifest

    def _extra_with_provenance(self, provenance: dict | None) -> dict:
        extra = dict(self.manifest.get("extra", {}))
        if provenance is not None:
            old = extra.get("data")
            if old is None:
                extra["data"] = provenance
            elif old.get("kind") == "concat":
                extra["data"] = {"kind": "concat",
                                 "parts": [*old["parts"], provenance]}
            else:
                extra["data"] = {"kind": "concat", "parts": [old, provenance]}
        return extra

    # -- serving ------------------------------------------------------------

    def engine(self, backend: str = "local", *,
               search: SearchConfig | None = None,
               memory_budget_mb: float = 64.0,
               engine_config=None,
               prefetch: str | None = None,
               shards: int | None = None) -> QueryEngine:
        """A :class:`QueryEngine` over the base index on the handle's
        device, cached per configuration. Serves the **base** only: use
        :meth:`query` to also see journal rows pending compaction.
        ``append``/``compact`` invalidate every cached engine, and the next
        call builds a fresh one over the new store state. ``prefetch``
        overrides ``SearchConfig.prefetch`` for the out-of-core backends
        (answers bit-identical either way). ``shards`` picks the shard
        count of ``backend="dist-ooc"`` (default: one a visible card, one
        on the CPU; the budget then applies per shard)."""
        self._require_open()
        if self.saved is None:
            raise IndexFormatError(
                f"{self.path!r}: store has no base index yet; append then "
                f"compact() before serving")
        # validate the name before it enters the cache key, so an unknown
        # name fails with the registry's message
        spec = resolve_backend_name(backend, kind="disk")
        if prefetch is not None:
            search = dataclasses.replace(search or self.config.search,
                                         prefetch=prefetch)
        # the budget only parameterizes the streaming backends: kept out of
        # the key otherwise, so budget variants do not duplicate an already
        # materialized local/scan backend
        budget = float(memory_budget_mb) if "ooc" in spec.name else None
        key = (backend, search, budget, engine_config,
               shards if backend == "dist-ooc" else None)
        eng = self._engines.get(key)
        if eng is None:
            be = make_disk_backend(backend, self, search=search,
                                   memory_budget_mb=memory_budget_mb,
                                   shards=shards, device=self.device)
            eng = QueryEngine(be, engine_config)
            self._engines[key] = eng
        return eng

    def query(self, queries, k: int | None = None, *,
              backend: str = "local", search: SearchConfig | None = None,
              memory_budget_mb: float = 64.0, shards: int | None = None,
              **overrides: Any) -> KnnResult:
        """Exact kNN over the *whole* store: the base index through the
        named backend plus an exact merge of any journal rows still pending
        compaction (the same difference-form arithmetic, ids continuing the
        collection, positions -1). ``shards`` as in :meth:`engine`."""
        self._require_open()
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if q.ndim == 1:
            q = q[None, :]
        if self.saved is None:
            return self._journal_only_knn(q, k, search, overrides)
        eng = self.engine(backend, search=search,
                          memory_budget_mb=memory_budget_mb, shards=shards)
        res = eng.knn(q, k=k, **overrides)
        if self.pending_rows:
            res = self._merge_journal(res, q, res.dists.shape[1])
        return res

    def _journal_rows(self) -> list[np.ndarray]:
        """Each journal segment's LRD rows, memory-mapped read-only."""
        parts = []
        for seg in self.journal["segments"]:
            lrd_rel = next(f for f in seg["files"] if f.endswith(".lrd.npy"))
            parts.append(np.load(os.path.join(self.path, lrd_rel),
                                 mmap_mode="r"))
        return parts

    def _resolve_k(self, k: int | None, search: SearchConfig | None,
                   overrides: dict) -> int:
        if k is not None:
            return k
        if "k" in overrides:
            return overrides["k"]
        return (search or self.config.search).k

    def _journal_only_knn(self, q: torch.Tensor, k: int | None,
                          search: SearchConfig | None,
                          overrides: dict) -> KnnResult:
        if not self.pending_rows:
            raise IndexFormatError(
                f"{self.path!r}: store is empty; nothing to query")
        kk = self._resolve_k(k, search, overrides)
        qn, dev = q.shape[0], q.device
        p0 = torch.full((qn, kk), -1, dtype=_I32, device=dev)
        zeros_i = torch.zeros((qn,), dtype=_I32, device=dev)
        base = KnnResult(
            dists=torch.full((qn, kk), INF, device=dev), positions=p0, ids=p0,
            path=torch.full((qn,), 3, dtype=_I32, device=dev),
            eapca_pr=torch.zeros((qn,), device=dev),
            sax_pr=torch.zeros((qn,), device=dev),
            accessed=zeros_i, visited_leaves=zeros_i)
        return self._merge_journal(base, q, kk)

    def _merge_journal(self, res: KnnResult, q: torch.Tensor, k: int,
                       block: int = 4096) -> KnnResult:
        """Fold journal rows into a base result: a blocked difference-form
        scan, positions -1 (journal rows have no layout position yet)."""
        d, p, i = res.dists, res.positions, res.ids
        offset = self.base_rows
        accessed = res.accessed
        for seg_rows in self._journal_rows():
            for lo in range(0, seg_rows.shape[0], block):
                # seg_rows maps the segment file: the block is copied out of
                # the map, so closing the store never pulls bytes from under
                # a computation in flight
                blk = torch.from_numpy(np.array(seg_rows[lo:lo + block])).to(q.device)
                db = _diff_dists(blk, q)                       # (Q, B)
                ib = (offset + lo + torch.arange(
                    blk.shape[0], dtype=i.dtype, device=q.device)).expand(db.shape)
                pb = torch.full(db.shape, -1, dtype=p.dtype, device=q.device)
                d, p, i = _merge_triplet(d, p, i, db, pb, ib, k)
            offset += seg_rows.shape[0]
            accessed = accessed + seg_rows.shape[0]
        return res._replace(dists=d, positions=p, ids=i, accessed=accessed)

    def _invalidate_engines(self) -> None:
        self._data_version += 1
        for eng in self._engines.values():
            eng.invalidate()
        self._engines.clear()
