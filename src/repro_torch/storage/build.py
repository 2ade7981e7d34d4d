"""Chunked streaming index construction (build-side out-of-core).

Port of ``repro/storage/build.py``. Two entry points over the same
machinery:

* :func:`build_index_streaming` -- chunked build to an in-memory index;
  device residency during the tree build is two chunks plus tree state.
  Bit-identical to ``HerculesIndex.build`` on the same data.
* :func:`build_index_to_disk` -- chunked build straight to an index
  directory: ``lrd.npy``, ``lsd.npy`` (and ``enc.npy`` under a lossy codec)
  are created as on-disk memory maps and each chunk is scattered to its
  layout positions on the host, so the collection is never materialized in
  host or device memory. The tree, the iSAX codes and the chunk statistics
  are computed on ``device`` (default: the CUDA device); the codec encodes
  on the host, as in the reference. The result loads bit-identically to a
  save of the in-memory build.

``prefetch`` (``None`` -> ``config.search.prefetch``) picks the chunk
reader: ``"thread"`` overlaps the reads with the tree statistics and the
scatter, and builds the same bits as ``"sync"``.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from repro_torch.core import summaries as S
from repro_torch.core.index import HerculesIndex, IndexConfig
from repro_torch.core.layout import (LayoutGeometry, assemble_layout,
                                     compute_layout_geometry, leaf_tables)
from repro_torch.core.tree import HerculesTree, build_tree_chunked, tree_stats
from repro_torch.data.pipeline import (ChunkSource, iter_device_chunks,
                                       iter_host_chunks)
from repro_torch.device import resolve_device
from repro_torch.storage.codecs import get_codec
from repro_torch.storage.format import (ENC_FILE, LAYOUT_FILE,
                                        LAYOUT_STATIC_FIELDS, LRD_FILE,
                                        LSD_FILE, MANIFEST_FILE,
                                        SMALL_LAYOUT_FIELDS, TREE_FILE,
                                        generation_name, write_manifest)


def _check_series_len(source: ChunkSource, config: IndexConfig) -> None:
    if source.series_len % config.sax_segments:
        raise ValueError(
            f"series length {source.series_len} must be divisible by "
            f"{config.sax_segments} iSAX segments")


def _resolve_prefetch(config: IndexConfig, prefetch: str | None) -> str:
    return config.search.prefetch if prefetch is None else prefetch


def _chunked_tree_and_geometry(source: ChunkSource, config: IndexConfig,
                               prefetch: str, device: torch.device):
    tree, node_of = build_tree_chunked(source, config.build, prefetch=prefetch,
                                       device=device)
    geo = compute_layout_geometry(
        tree, node_of, source.num_series, source.series_len,
        pad_series_to_multiple=config.search.pad_multiple())
    return tree, geo


def build_index_streaming(source: ChunkSource,
                          config: IndexConfig | None = None,
                          prefetch: str | None = None,
                          device: str | torch.device | None = None
                          ) -> HerculesIndex:
    """Chunk-streamed build of an in-memory index on ``device`` (default:
    the CUDA device)."""
    dev = resolve_device(device)
    config = config or IndexConfig()
    prefetch = _resolve_prefetch(config, prefetch)
    _check_series_len(source, config)
    tree, geo = _chunked_tree_and_geometry(source, config, prefetch, dev)

    n = source.series_len
    lrd = np.zeros((geo.n_pad, n), np.float32)
    lsd = np.zeros((geo.n_pad, config.sax_segments), np.uint8)
    for start, chunk in iter_device_chunks(source, dev, prefetch=prefetch):
        pos = geo.inv_perm[start:start + chunk.shape[0]]
        lrd[pos] = chunk.cpu().numpy()
        lsd[pos] = S.isax(chunk, config.sax_segments).cpu().numpy()

    layout = assemble_layout(tree, geo, lrd, lsd)
    return HerculesIndex(tree, layout, config, tree_stats(tree)["max_depth"])


def _write_small_arrays(path: str, tree: HerculesTree, geo: LayoutGeometry,
                        names: dict[str, str]) -> None:
    """tree.npz + layout.npz from a built tree and its placement plan: the
    bytes ``save_index`` writes for the same index."""
    np.savez_compressed(
        os.path.join(path, names[TREE_FILE]),
        **{name: val.cpu().numpy() for name, val in tree._asdict().items()})
    syn, ep, seg_lens = leaf_tables(tree, geo)
    small = {
        "perm": geo.perm, "inv_perm": geo.inv_perm,
        "leaf_rank": geo.leaf_rank, "leaf_node": geo.leaf_node,
        "leaf_start": geo.leaf_start, "leaf_count": geo.leaf_count,
        "leaf_synopsis": syn.cpu().numpy(), "leaf_endpoints": ep.cpu().numpy(),
        "leaf_seg_lens": seg_lens.cpu().numpy(),
        "series_leaf_rank": geo.series_leaf_rank,
    }
    if set(small) != set(SMALL_LAYOUT_FIELDS):
        raise AssertionError(f"layout.npz fields {sorted(small)} drifted from "
                             f"{SMALL_LAYOUT_FIELDS}")
    np.savez_compressed(os.path.join(path, names[LAYOUT_FILE]), **small)


def stream_base_files(source: ChunkSource, path: str, config: IndexConfig,
                      generation: int = 0, prefetch: str | None = None,
                      codec: str = "raw",
                      device: str | torch.device | None = None):
    """Chunk-streamed build of one base-file generation under ``path``.

    Writes ``tree.npz``/``layout.npz``/``lrd.npy``/``lsd.npy`` (suffixed by
    ``generation`` when nonzero), and ``enc.npy`` under a non-``raw``
    ``codec`` (each chunk is encoded as it streams past), WITHOUT committing
    a manifest: the caller publishes it as its own atomic commit. Returns
    ``(names, statics, max_depth, timings)``.
    """
    dev = resolve_device(device)
    codec_impl = get_codec(codec)
    _check_series_len(source, config)
    prefetch = _resolve_prefetch(config, prefetch)
    read_stats: dict = {}
    t0 = time.perf_counter()
    tree, geo = _chunked_tree_and_geometry(source, config, prefetch, dev)
    t_tree = time.perf_counter() - t0

    os.makedirs(path, exist_ok=True)
    logical = [TREE_FILE, LAYOUT_FILE, LRD_FILE, LSD_FILE]
    if codec != "raw":
        logical.append(ENC_FILE)
    names = {name: generation_name(name, generation) for name in logical}

    # LRD/LSD as on-disk memory maps, scattered chunk by chunk; pad rows past
    # num_series stay zero (the file is created zero-filled), the bytes the
    # in-memory layout pads with
    t0 = time.perf_counter()
    n = source.series_len
    lrd = np.lib.format.open_memmap(
        os.path.join(path, names[LRD_FILE]), mode="w+", dtype=np.float32,
        shape=(geo.n_pad, n))
    lsd = np.lib.format.open_memmap(
        os.path.join(path, names[LSD_FILE]), mode="w+", dtype=np.uint8,
        shape=(geo.n_pad, config.sax_segments))
    enc = None
    if codec != "raw":
        enc = np.lib.format.open_memmap(
            os.path.join(path, names[ENC_FILE]), mode="w+", dtype=np.uint8,
            shape=(geo.n_pad, codec_impl.row_bytes(n)))
    for start, chunk in iter_host_chunks(source, prefetch=prefetch,
                                         telemetry=read_stats):
        # the chunk may be a reusable reader-slot view: the device tensor is
        # a copy, and the host scatters below copy the bytes out within this
        # iteration
        rows = torch.tensor(chunk, device=dev)
        pos = geo.inv_perm[start:start + chunk.shape[0]]
        lrd[pos] = chunk
        lsd[pos] = S.isax(rows, config.sax_segments).cpu().numpy()
        if enc is not None:
            enc[pos] = codec_impl.encode(chunk)
    lrd.flush()
    lsd.flush()
    if enc is not None:
        enc.flush()
        del enc
    del lrd, lsd
    t_write = time.perf_counter() - t0

    _write_small_arrays(path, tree, geo, names)
    statics = {k: getattr(geo, k) for k in LAYOUT_STATIC_FIELDS}
    timings = {
        "streaming": True,
        "codec": codec,
        "chunk_size": source.chunk_size,
        "num_chunks": source.num_chunks,
        "prefetch": prefetch,
        "tree_seconds": round(t_tree, 3),
        "write_seconds": round(t_write, 3),
        "write_read_wait_seconds": round(
            read_stats.get("read_wait_seconds", 0.0), 3),
        "write_overlap_blocks": int(read_stats.get("overlap_blocks", 0)),
        "series_per_second": round(source.num_series / max(t_tree + t_write,
                                                           1e-9), 1),
    }
    return names, statics, tree_stats(tree)["max_depth"], timings


def build_index_to_disk(source: ChunkSource, path: str,
                        config: IndexConfig | None = None,
                        extra_meta: dict | None = None,
                        prefetch: str | None = None,
                        codec: str = "raw",
                        device: str | torch.device | None = None) -> dict:
    """Chunk-streamed build straight to an index directory, with the tree
    and the iSAX codes computed on ``device`` (default: the CUDA device).
    Returns the manifest, with the build's timings under
    ``extra["build"]``."""
    dev = resolve_device(device)
    config = config or IndexConfig()
    os.makedirs(path, exist_ok=True)
    stale = os.path.join(path, MANIFEST_FILE)
    if os.path.exists(stale):
        os.remove(stale)

    names, statics, max_depth, timings = stream_base_files(
        source, path, config, generation=0, prefetch=prefetch, codec=codec,
        device=dev)
    extra = dict(extra_meta or {})
    extra["build"] = timings
    return write_manifest(path, config, max_depth, statics, extra=extra,
                          files=names, codec=codec)
