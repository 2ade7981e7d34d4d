"""Versioned on-disk Hercules index format (the paper's persisted artifacts).

Port of ``repro/storage/format.py``: the same directory, the same manifest
and the same files, so an index written by either package opens in the
other. An index directory holds

    <dir>/
      manifest.json   format name + version, build/search config, statics,
                      per-file byte sizes and CRC32 checksums, journal
                      segment list, codec and partition sections. Written
                      last (fsync'd temp file + ``os.replace``): its
                      presence commits every other file.
      tree.npz        every HerculesTree array (small, compressed).
      layout.npz      the small layout arrays (perm, leaf extents, pruning
                      tables).
      lrd.npy         LRDFile: raw series, leaf in-order, (n_pad, n) float32,
                      served memory-mapped.
      lsd.npy         LSDFile: position-aligned iSAX codes, (n_pad, m) uint8.
      enc.npy         format v3, lossy codecs only: codec-encoded rows,
                      position-aligned with lrd.npy, (n_pad, row_bytes)
                      uint8 (see ``storage/codecs.py``).
      journal/        append segments of the store (``storage/store.py``):
                      raw rows in append order and their iSAX codes.

Versions 1 and 2 load unchanged (no codec section: ``raw``). Loading
validates the manifest and, with ``verify=True``, re-checksums every file,
so truncation or corruption raises :class:`IndexFormatError`.

:func:`open_index` returns a :class:`SavedIndex` whose tree and small arrays
are resident on the host and whose LRD/LSD/encoded files stay memory-mapped;
:func:`load_index` materializes a :class:`HerculesIndex` on a device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import zlib

import numpy as np
import torch

from repro_torch.analysis import sanitize
from repro_torch.core.index import IndexConfig, reference_search_config
from repro_torch.core.layout import HerculesLayout
from repro_torch.core.search import SearchConfig
from repro_torch.core.tree import BuildConfig, HerculesTree
from repro_torch.device import resolve_device
from repro_torch.storage.codecs import get_codec
from repro_torch.storage.partition import partition_section

FORMAT_NAME = "hercules-index"
FORMAT_VERSION = 3

MANIFEST_FILE = "manifest.json"
TREE_FILE = "tree.npz"
LAYOUT_FILE = "layout.npz"
LRD_FILE = "lrd.npy"
LSD_FILE = "lsd.npy"
ENC_FILE = "enc.npy"
_ARRAY_FILES = (TREE_FILE, LAYOUT_FILE, LRD_FILE, LSD_FILE)

JOURNAL_DIR = "journal"

# HerculesLayout fields persisted in layout.npz (everything but lrd/lsd and
# the static ints, which live in the manifest)
SMALL_LAYOUT_FIELDS = (
    "perm", "inv_perm", "leaf_rank", "leaf_node", "leaf_start", "leaf_count",
    "leaf_synopsis", "leaf_endpoints", "leaf_seg_lens", "series_leaf_rank")
LAYOUT_STATIC_FIELDS = ("series_len", "max_leaf", "num_leaves", "num_series")


class IndexFormatError(RuntimeError):
    """A saved index is missing, truncated, corrupted, or from an
    unsupported format version."""


# ---------------------------------------------------------------------------
# checksums
# ---------------------------------------------------------------------------

def _crc32_file(path: str, blocksize: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(blocksize)
            if not block:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(block, crc)


def _file_entry(path: str) -> dict:
    return {"bytes": os.path.getsize(path), "crc32": _crc32_file(path)}


# ---------------------------------------------------------------------------
# manifest helpers (base files, journal section, generation naming)
# ---------------------------------------------------------------------------

def _config_meta(config: IndexConfig) -> dict:
    return {"build": dataclasses.asdict(config.build),
            "search": dataclasses.asdict(config.search),
            "sax_segments": config.sax_segments}


def array_path(manifest: dict, name: str) -> str:
    """Directory-relative path of a logical base file (``tree.npz`` ...):
    its plain name, or the current generation's file after a compaction."""
    entry = manifest.get("files", {}).get(name, {})
    return entry.get("path", name)


def generation_of(manifest: dict) -> int:
    return int(manifest.get("generation", 0))


def generation_name(name: str, generation: int) -> str:
    """``lrd.npy`` at generation 3 -> ``lrd-00003.npy`` (generation 0 keeps
    the plain name)."""
    if generation == 0:
        return name
    stem, ext = os.path.splitext(name)
    return f"{stem}-{generation:05d}{ext}"


def journal_of(manifest: dict) -> dict:
    """The journal section, normalized (version-1 manifests have none)."""
    j = manifest.get("journal") or {}
    return {"segments": list(j.get("segments", [])),
            "rows": int(j.get("rows", 0))}


def codec_of(manifest: dict) -> str:
    """Name of the leaf codec the base files were written with; version-1/2
    manifests have no ``codec`` section and are raw."""
    return str((manifest.get("codec") or {}).get("name", "raw"))


def has_base(manifest: dict) -> bool:
    """Whether the directory holds a committed base index (an empty store
    has only a manifest and a journal)."""
    return bool(manifest.get("files"))


def segment_file_names(seg_id: int) -> tuple[str, str]:
    """(lrd, lsd) file names of journal segment ``seg_id``, relative to the
    index directory."""
    return (f"{JOURNAL_DIR}/seg-{seg_id:05d}.lrd.npy",
            f"{JOURNAL_DIR}/seg-{seg_id:05d}.lsd.npy")


def partition_of(manifest: dict) -> dict:
    """The shard-plan section, normalized. Manifests written before shard
    plans were recorded have none; plans then derive on open
    (``repro_torch.storage.partition.shard_plan``)."""
    p = manifest.get("partition") or {}
    return {"version": int(p.get("version", 0)),
            "balanced_by": str(p.get("balanced_by", "rows")),
            "plans": dict(p.get("plans", {}))}


def _load_npz(path: str, rel: str) -> dict[str, np.ndarray]:
    try:
        with np.load(os.path.join(path, rel), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, zlib.error) as e:
        raise IndexFormatError(f"{path!r}: cannot read {rel}: {e}") from e


def _partition_meta(path: str, entries: dict) -> dict | None:
    """One shard plan per recorded shard count, from the just-written leaf
    tables (``layout.npz``)."""
    entry = entries.get(LAYOUT_FILE)
    if entry is None:
        return None
    small = _load_npz(path, entry.get("path", LAYOUT_FILE))
    return partition_section(small["leaf_start"], small["leaf_count"])


def write_manifest(path: str, config: IndexConfig, max_depth: int,
                   statics: dict, extra: dict | None = None, *,
                   files: dict[str, str] | None = None,
                   entries: dict[str, dict] | None = None,
                   journal: dict | None = None,
                   generation: int = 0,
                   base: bool = True,
                   codec: str = "raw") -> dict:
    """Checksum the base array files already under ``path`` and commit them,
    with the journal segment list, by atomically publishing the manifest:
    the ``os.replace`` here is the single commit point.

    ``files`` maps logical names to their directory-relative actual paths
    (identity by default); ``entries`` supplies checksum entries verbatim;
    ``base=False`` commits a manifest with no base index. A non-``raw``
    ``codec`` adds ``enc.npy`` to the committed file set.
    """
    codec_impl = get_codec(codec)  # validates the name
    if entries is None:
        entries = {}
        if base:
            names = files or {}
            required = _ARRAY_FILES if codec == "raw" \
                else _ARRAY_FILES + (ENC_FILE,)
            for name in required:
                actual = names.get(name, name)
                fp = os.path.join(path, actual)
                if not os.path.exists(fp):
                    raise IndexFormatError(
                        f"cannot commit {path}: missing {actual}")
                entry = _file_entry(fp)
                if actual != name:
                    entry["path"] = actual
                entries[name] = entry
    else:
        entries = {name: dict(entry) for name, entry in entries.items()}
    series_len = int(statics.get("series_len", 0))
    manifest = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "created_unix": time.time(),
        "config": _config_meta(config),
        "max_depth": int(max_depth),
        "layout_static": {k: int(v) for k, v in statics.items()},
        "files": entries,
        "generation": int(generation),
        "journal": journal_of({"journal": journal} if journal else {}),
        "codec": {"name": codec,
                  "row_bytes": codec_impl.row_bytes(series_len)
                  if series_len else 0,
                  "exact": bool(codec_impl.exact)},
        "partition": _partition_meta(path, entries),
        "extra": dict(extra or {}),
    }
    tmp = os.path.join(path, MANIFEST_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, MANIFEST_FILE))
    return manifest


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_index(index, path: str, extra_meta: dict | None = None) -> dict:
    """Persist an in-memory :class:`HerculesIndex` as an index directory
    and return the manifest. A stale manifest is removed first, so a failed
    overwrite never half-validates."""
    os.makedirs(path, exist_ok=True)
    stale = os.path.join(path, MANIFEST_FILE)
    if os.path.exists(stale):
        os.remove(stale)
    lay = index.layout
    np.savez_compressed(
        os.path.join(path, TREE_FILE),
        **{name: _np(val) for name, val in index.tree._asdict().items()})
    np.savez_compressed(
        os.path.join(path, LAYOUT_FILE),
        **{name: _np(getattr(lay, name)) for name in SMALL_LAYOUT_FIELDS})
    np.save(os.path.join(path, LRD_FILE), _np(lay.lrd))
    np.save(os.path.join(path, LSD_FILE), _np(lay.lsd))
    statics = {k: getattr(lay, k) for k in LAYOUT_STATIC_FIELDS}
    return write_manifest(path, index.config, index.max_depth, statics,
                          extra=extra_meta)


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def read_manifest(path: str) -> dict:
    mf = os.path.join(path, MANIFEST_FILE)
    if not os.path.isdir(path) or not os.path.exists(mf):
        raise IndexFormatError(
            f"{path!r} is not an index directory (no {MANIFEST_FILE})")
    try:
        with open(mf) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise IndexFormatError(f"unreadable manifest in {path!r}: {e}") from e
    if manifest.get("format") != FORMAT_NAME:
        raise IndexFormatError(
            f"{path!r}: format {manifest.get('format')!r} is not "
            f"{FORMAT_NAME!r}")
    version = manifest.get("version")
    if not isinstance(version, int) or version > FORMAT_VERSION or version < 1:
        raise IndexFormatError(
            f"{path!r}: format version {version!r} not supported "
            f"(this build reads versions 1..{FORMAT_VERSION})")
    return manifest


def _verify_one(path: str, rel: str, entry: dict) -> None:
    fp = os.path.join(path, rel)
    if not os.path.exists(fp):
        raise IndexFormatError(f"{path!r}: missing file {rel}")
    size = os.path.getsize(fp)
    if size != entry["bytes"]:
        raise IndexFormatError(
            f"{path!r}: {rel} is {size} bytes, manifest says "
            f"{entry['bytes']} (truncated or overwritten)")
    crc = _crc32_file(fp)
    if crc != entry["crc32"]:
        raise IndexFormatError(
            f"{path!r}: {rel} checksum mismatch "
            f"(crc32 {crc:#010x} != {entry['crc32']:#010x}; corrupted)")


def verify_files(path: str, manifest: dict) -> None:
    """Check every manifest-listed file's size and CRC32 (base files and
    journal segments); raise :class:`IndexFormatError` on the first bad one."""
    for name, entry in manifest.get("files", {}).items():
        _verify_one(path, entry.get("path", name), entry)
    for seg in journal_of(manifest)["segments"]:
        for rel, entry in seg.get("files", {}).items():
            _verify_one(path, rel, entry)


def _restore_config(manifest: dict) -> IndexConfig:
    cfg = manifest["config"]
    try:
        return IndexConfig(build=BuildConfig(**cfg["build"]),
                           search=SearchConfig(**reference_search_config(
                               cfg["search"])),
                           sax_segments=cfg["sax_segments"])
    except (KeyError, TypeError) as e:
        raise IndexFormatError(f"manifest config does not match this build's "
                               f"schema: {e}") from e


@dataclasses.dataclass
class SavedIndex:
    """An opened on-disk index: small state resident on the host, big files
    memory-mapped.

    ``tree`` (CPU tensors) and the ``small`` layout arrays are loaded;
    ``lrd``, ``lsd`` and ``enc`` stay read-only memory maps until rows are
    sliced out of them (under ``REPRO_SANITIZE=1`` each is an
    ``analysis.sanitize.MmapGuard``: slice it or ``np.asarray`` it, never
    hand it to ``torch.from_numpy``). :meth:`close` (or leaving the
    ``with`` block) releases the maps; a backend still holding the handle
    then fails loudly instead of reading a dead map.
    """
    path: str
    manifest: dict
    config: IndexConfig
    max_depth: int
    tree: HerculesTree
    small: dict[str, np.ndarray]
    lrd: np.ndarray | None   # (n_pad, n) float32 memmap
    lsd: np.ndarray | None   # (n_pad, m_sax) uint8 memmap
    series_len: int
    max_leaf: int
    num_leaves: int
    num_series: int
    codec: str = "raw"
    enc: np.ndarray | None = None  # (n_pad, row_bytes) uint8 memmap (lossy)

    @property
    def n_pad(self) -> int:
        return int(self._mapped("lrd").shape[0])

    @property
    def closed(self) -> bool:
        return self.lrd is None

    def _mapped(self, name: str) -> np.ndarray:
        arr = getattr(self, name)
        if arr is None:
            if name == "enc" and self.codec == "raw" and self.lrd is not None:
                raise IndexFormatError(
                    f"{self.path!r}: index has no encoded sidecar (codec is "
                    f"'raw'); stream lrd instead")
            raise IndexFormatError(
                f"{self.path!r}: SavedIndex is closed (its memory maps were "
                f"released); reopen the index to read {name}")
        return arr

    def close(self) -> None:
        """Release the LRD/LSD (and encoded) memory maps. Idempotent. Under
        ``REPRO_SANITIZE=1`` a view that escaped raises
        ``UseAfterCloseError`` from then on."""
        for name in ("lrd", "lsd", "enc"):
            arr = getattr(self, name)
            setattr(self, name, None)
            if isinstance(arr, sanitize.MmapGuard):
                arr.release()
                continue
            mm = getattr(arr, "_mmap", None)
            if mm is not None:
                try:
                    mm.close()
                except BufferError:
                    # live views (a backend mid-stream) still export the
                    # buffer; dropping our reference lets GC finish the job
                    pass

    def __enter__(self) -> "SavedIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def to_layout(self, device: str | torch.device | None = None) -> HerculesLayout:
        """The full layout on ``device`` (default: the CUDA device). The big
        arrays are copied out of the maps, so the layout outlives
        :meth:`close`."""
        dev = resolve_device(device)
        kw = {name: torch.from_numpy(np.array(arr, copy=True)).to(dev)
              for name, arr in self.small.items()}
        return HerculesLayout(
            lrd=torch.from_numpy(np.array(self._mapped("lrd"), copy=True)).to(dev),
            lsd=torch.from_numpy(np.array(self._mapped("lsd"), copy=True)).to(dev),
            series_len=self.series_len, max_leaf=self.max_leaf,
            num_leaves=self.num_leaves, num_series=self.num_series, **kw)

    def to_index(self, device: str | torch.device | None = None):
        """Materialize the full in-memory index on ``device`` (default: the
        CUDA device)."""
        from repro_torch.core.index import HerculesIndex

        dev = resolve_device(device)
        tree = HerculesTree(*[t.to(dev) for t in self.tree])
        return HerculesIndex(tree, self.to_layout(dev), self.config,
                             self.max_depth)

    def original_data(self) -> np.ndarray:
        """The collection in original id order, (num_series, n) host float32
        (reads the whole LRD file: for verification, not for serving)."""
        return self._mapped("lrd")[self.small["inv_perm"]]


def open_saved(path: str, manifest: dict) -> SavedIndex:
    """Open the committed base index described by an already-read (and, if
    wanted, already-verified) manifest."""
    if not has_base(manifest):
        raise IndexFormatError(
            f"{path!r}: store has no base index yet (journal only)")
    config = _restore_config(manifest)
    tree_arrays = _load_npz(path, array_path(manifest, TREE_FILE))
    try:
        tree = HerculesTree(**{name: torch.from_numpy(tree_arrays[name])
                               for name in HerculesTree._fields})
    except KeyError as e:
        raise IndexFormatError(f"{path!r}: {TREE_FILE} is missing tree "
                               f"array {e}") from e
    small = _load_npz(path, array_path(manifest, LAYOUT_FILE))
    missing = set(SMALL_LAYOUT_FIELDS) - set(small)
    if missing:
        raise IndexFormatError(
            f"{path!r}: {LAYOUT_FILE} is missing {sorted(missing)}")
    try:
        lrd = np.load(os.path.join(path, array_path(manifest, LRD_FILE)),
                      mmap_mode="r", allow_pickle=False)
        lsd = np.load(os.path.join(path, array_path(manifest, LSD_FILE)),
                      mmap_mode="r", allow_pickle=False)
    except (OSError, ValueError) as e:
        raise IndexFormatError(f"{path!r}: cannot map raw arrays: {e}") from e
    statics = manifest["layout_static"]
    if (lrd.ndim != 2 or lrd.shape[1] != int(statics["series_len"])
            or lrd.shape[0] < int(statics["num_series"])):
        raise IndexFormatError(
            f"{path!r}: {LRD_FILE} shape {tuple(lrd.shape)} does not match "
            f"manifest statics {statics}")
    codec = codec_of(manifest)
    enc = None
    if codec != "raw":
        try:
            enc = np.load(os.path.join(path, array_path(manifest, ENC_FILE)),
                          mmap_mode="r", allow_pickle=False)
        except (OSError, ValueError) as e:
            raise IndexFormatError(
                f"{path!r}: cannot map encoded sidecar: {e}") from e
        row_bytes = int(manifest["codec"].get("row_bytes", 0))
        if (enc.ndim != 2 or enc.dtype != np.uint8
                or enc.shape != (lrd.shape[0], row_bytes)):
            raise IndexFormatError(
                f"{path!r}: {ENC_FILE} shape {tuple(enc.shape)}/{enc.dtype} "
                f"does not match manifest codec section {manifest['codec']}")
    # REPRO_SANITIZE=1 wraps the maps in use-after-close guards (they pass
    # through otherwise)
    lrd = sanitize.guard_mmap(lrd, f"{path}:lrd")
    lsd = sanitize.guard_mmap(lsd, f"{path}:lsd")
    enc = sanitize.guard_mmap(enc, f"{path}:enc")
    return SavedIndex(
        path=path, manifest=manifest, config=config,
        max_depth=int(manifest["max_depth"]), tree=tree, small=small,
        lrd=lrd, lsd=lsd, codec=codec, enc=enc,
        **{k: int(statics[k]) for k in LAYOUT_STATIC_FIELDS})


def open_index(path: str, verify: bool = True) -> SavedIndex:
    """Open an index directory without materializing the big files (the
    committed base index; journal rows are served by the store,
    ``storage/store.py``)."""
    manifest = read_manifest(path)
    if verify:
        verify_files(path, manifest)
    return open_saved(path, manifest)


def load_index(path: str, verify: bool = True,
               device: str | torch.device | None = None):
    """Load a saved index fully onto ``device`` (default: the CUDA device):
    bit-identical arrays to the index that was saved."""
    with open_index(path, verify=verify) as saved:
        return saved.to_index(device)
