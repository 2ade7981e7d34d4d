"""Index lifecycle CLI on PyTorch: build -> append -> compact -> query, one store.

Port of ``repro/launch/build_index.py``. Each step may run in a fresh
process: ``build`` streams a collection to disk in chunks, ``append`` lands
a journal segment, ``compact`` folds the journal into a new base
generation, and ``query`` loads the index and, with ``--verify parity``,
asserts that the disk backends answer bit-identically to in-memory ones
built over the whole (appended) collection, or with ``--verify exact``
holds the answers against a float64 difference-form brute force (ids
equal, dists within 1e-5). Everything runs on the CUDA
device unless ``--device cpu`` is given.

    # build (chunked, streamed to disk) + one-shot equality check
    PYTHONPATH=src python -m repro_torch.launch.build_index build \\
        --out idx --num 8192 --length 64 --seed 7 --chunk-size 1024 \\
        --verify-one-shot --json build.json

    # fresh process: append a journal segment (atomic manifest commit)
    PYTHONPATH=src python -m repro_torch.launch.build_index append \\
        --index idx --num 2048 --length 64 --seed 11 --json append.json

    # fresh process: fold the journal into a new base generation
    PYTHONPATH=src python -m repro_torch.launch.build_index compact --index idx

    # fresh process: load + bit-identical parity vs in-memory backends
    PYTHONPATH=src python -m repro_torch.launch.build_index query \\
        --index idx --verify parity --json parity.json

    # out-of-core scan, collection >= 4x the budget
    PYTHONPATH=src python -m repro_torch.launch.build_index query \\
        --index idx --backend ooc-scan --memory-budget-mb 0.5 --verify exact

    # sharded out-of-core serving: 4 shards, each streaming its own rows
    PYTHONPATH=src python -m repro_torch.launch.build_index query \\
        --index idx --backend dist-ooc --shards 4 --verify parity

Synthetic data is recorded as ``{"kind": "synthetic-torch", "seed", "num",
"length"}`` and regenerated from it by ``repro_torch.data.random_walks``
(the same bits on the CPU and the card). Any other provenance, such as the
reference's ``jax.random`` kind ``synthetic``, is not regenerated: the
collection is read back from the index's LRD file instead.
"""
from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch

from repro_torch.api import (ArrayChunkSource, AsyncChunkReader, BuildConfig,
                             Hercules, HerculesIndex, IndexConfig,
                             LocalBackend, NpyChunkSource, QueryEngine,
                             ScanBackend, SearchConfig, backend_names,
                             build_index_to_disk,
                             list_codecs, make_backend, make_disk_backend,
                             open_index)
from repro_torch.core.engine import _OutOfCoreBase
from repro_torch.data.synthetic import make_query_workload, random_walks
from repro_torch.device import resolve_device, shard_devices
from repro_torch.storage.format import journal_of

SYNTHETIC_KIND = "synthetic-torch"


def _write_json(path: str | None, payload: dict) -> None:
    if not path:
        return
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    print(f"# wrote {path}")


def _index_config(args) -> IndexConfig:
    return IndexConfig(
        build=BuildConfig(leaf_capacity=args.leaf_size),
        search=SearchConfig(k=args.k, l_max=args.l_max,
                            chunk=min(1024, args.num),
                            scan_block=min(4096, args.num),
                            prefetch=getattr(args, "prefetch", "sync")))


def _synthetic(num: int, length: int, seed: int) -> np.ndarray:
    # drawn on the host: the draw is the same on every device
    return random_walks(num, length, seed=seed, device="cpu").numpy()


def _synthetic_provenance(args) -> dict:
    return {"kind": SYNTHETIC_KIND, "seed": args.seed, "num": args.num,
            "length": args.length}


def cmd_build(args) -> None:
    dev = resolve_device(args.device)
    if args.input:
        source = NpyChunkSource(args.input, args.chunk_size)
        args.num, args.length = source.num_series, source.series_len
        provenance = {"kind": "npy", "path": args.input}
    else:
        data = _synthetic(args.num, args.length, args.seed)
        source = ArrayChunkSource(data, args.chunk_size)
        provenance = _synthetic_provenance(args)

    cfg = _index_config(args)
    t0 = time.perf_counter()
    manifest = build_index_to_disk(source, args.out, cfg,
                                   extra_meta={"data": provenance},
                                   codec=args.codec, device=dev)
    build_s = time.perf_counter() - t0
    thr = source.num_series / max(build_s, 1e-9)
    print(f"built + saved {source.num_series} x {source.series_len} on {dev} "
          f"in {build_s:.2f}s ({thr:.0f} series/s, chunks of {args.chunk_size}, "
          f"codec {args.codec}) -> {args.out}")

    rows = {"num_series": source.num_series, "series_len": source.series_len,
            "chunk_size": args.chunk_size, "build_seconds": round(build_s, 3),
            "series_per_second": round(thr, 1), "codec": args.codec,
            "device": str(dev), "manifest_build": manifest["extra"]["build"]}

    if args.verify_one_shot:
        if args.input:
            raise SystemExit("--verify-one-shot needs a synthetic build "
                             "(regenerates the data in memory)")
        t0 = time.perf_counter()
        mem = HerculesIndex.build(data, cfg, device=dev)
        rows["oneshot_build_seconds"] = round(time.perf_counter() - t0, 3)
        loaded = make_disk_backend("local", args.out, device=dev).index
        for name in mem.tree._fields:
            if not torch.equal(getattr(mem.tree, name), getattr(loaded.tree, name)):
                raise SystemExit(f"chunked tree differs from one-shot: {name}")
        for name in ("lrd", "lsd", "perm", "leaf_start", "leaf_count",
                     "leaf_synopsis"):
            if not torch.equal(getattr(mem.layout, name),
                               getattr(loaded.layout, name)):
                raise SystemExit(f"chunked layout differs from one-shot: {name}")
        print("chunked streamed build == one-shot in-memory build "
              "(tree + layout bit-identical)")
        rows["oneshot_equal"] = True
    _write_json(args.json, rows)


def _regenerate(saved) -> np.ndarray:
    prov = saved.manifest["extra"].get("data", {})
    parts = prov["parts"] if prov.get("kind") == "concat" else [prov]
    if all(p.get("kind") == SYNTHETIC_KIND for p in parts):
        return np.concatenate(
            [_synthetic(p["num"], p["length"], p["seed"]) for p in parts])
    # any other kind: the collection recorded in the LRD file itself
    return saved.original_data()


def cmd_append(args) -> None:
    if args.input:
        data = np.load(args.input).astype(np.float32)
        provenance = {"kind": "npy", "path": args.input}
    else:
        data = _synthetic(args.num, args.length, args.seed)
        provenance = _synthetic_provenance(args)
    with Hercules.open(args.index, "a", device=args.device) as hx:
        t0 = time.perf_counter()
        seg = hx.append(data, chunk_size=args.chunk_size,
                        provenance=provenance)
        dt = time.perf_counter() - t0
        thr = seg["rows"] / max(dt, 1e-9)
        print(f"appended segment {seg['name']} ({seg['rows']} x "
              f"{seg['series_len']}) in {dt:.2f}s ({thr:.0f} series/s); "
              f"{hx.pending_rows} rows pending compaction")
        _write_json(args.json, {
            "index": args.index, "segment": seg["name"], "rows": seg["rows"],
            "append_seconds": round(dt, 3),
            "series_per_second": round(thr, 1),
            "pending_rows": hx.pending_rows,
            "base_rows": hx.base_rows})


def cmd_compact(args) -> None:
    with Hercules.open(args.index, "a", device=args.device) as hx:
        pending, segs = hx.pending_rows, len(hx.journal["segments"])
        t0 = time.perf_counter()
        manifest = hx.compact(chunk_size=args.chunk_size, codec=args.codec)
        dt = time.perf_counter() - t0
        thr = hx.num_series / max(dt, 1e-9)
        print(f"compacted {pending} journal rows ({segs} segments) into "
              f"generation {hx.generation} in {dt:.2f}s "
              f"({thr:.0f} series/s replayed); base now {hx.base_rows} rows, "
              f"codec {hx.codec}")
        _write_json(args.json, {
            "index": args.index, "journal_rows": pending,
            "segments": segs, "generation": hx.generation,
            "codec": hx.codec,
            "compact_seconds": round(dt, 3),
            "series_per_second": round(thr, 1),
            "base_rows": hx.base_rows,
            "manifest_compact": manifest["extra"].get("compact", {})})


def _assert_readers_joined() -> None:
    """No chunk-reader thread may outlive its stream: ``close()`` joins
    them, and a survivor here is a leak."""
    leaked = [t.name for t in threading.enumerate()
              if t.name == AsyncChunkReader.THREAD_NAME and t.is_alive()]
    if leaked:
        raise SystemExit(f"leaked chunk-reader threads after close(): "
                         f"{leaked}")
    print("reader threads joined after close(): none leaked")


def _assert_same(name: str, a, b) -> None:
    for field, x, y in (("dists", a.dists, b.dists), ("ids", a.ids, b.ids)):
        if not torch.equal(x, y):
            raise SystemExit(f"{name}: {field} differ between disk-fed and "
                             f"in-memory backends")
    print(f"{name}: bit-identical")


_ORACLE_BLOCK_ELEMS = 1 << 24   # float64 elements of one difference block


def _exact_oracle(data: np.ndarray, queries: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``--verify exact``'s oracle: a difference-form brute force in float64
    on the queries' device, in row blocks, and a stable top-k (ties to the
    lower id). Returns ((Q, k) float64 squared distances, (Q, k) int64 ids).
    Unlike the matmul identity it has no cancellation to lose digits to, so
    the 1e-5 tolerance judges the answer, not the oracle."""
    dev = queries.device
    q = queries.to(torch.float64)
    qn, n = q.shape
    d_top = torch.empty((qn, 0), dtype=torch.float64, device=dev)
    i_top = torch.empty((qn, 0), dtype=torch.long, device=dev)
    step = max(1, _ORACLE_BLOCK_ELEMS // max(1, qn * n))
    for lo in range(0, data.shape[0], step):
        blk = torch.from_numpy(data[lo:lo + step]).to(device=dev, dtype=torch.float64)
        d = ((q[:, None, :] - blk[None, :, :]) ** 2).sum(-1)
        ids = torch.arange(lo, lo + blk.shape[0], device=dev).expand(qn, -1)
        d_top, order = torch.sort(torch.cat([d_top, d], dim=1), dim=1, stable=True)
        i_top = torch.gather(torch.cat([i_top, ids], dim=1), 1, order)
        d_top, i_top = d_top[:, :k], i_top[:, :k]
    return d_top, i_top


def cmd_query(args) -> None:
    dev = resolve_device(args.device)
    with open_index(args.index) as saved:
        pending = journal_of(saved.manifest)["rows"]
        data = _regenerate(saved)
        num_series, series_len = saved.num_series, saved.series_len
        codec, cfg = saved.codec, saved.config
        # the collection as the index file holds it, for the sharded parity leg
        stored = saved.original_data() if args.verify == "parity" else None
    if pending:
        # the disk backends serve the committed base; _regenerate (and the
        # in-memory reference backends) would cover base + journal
        if args.verify != "none":
            raise SystemExit(
                f"{args.index}: {pending} journal rows pending compaction; "
                f"verification compares the committed base only: run "
                f"`build_index compact --index {args.index}` first")
        print(f"# note: {pending} journal rows pending compaction are not "
              f"served by backend {args.backend!r}")
    k = args.k
    queries = make_query_workload(torch.from_numpy(data), args.queries,
                                  args.difficulty, seed=args.query_seed)

    rows: dict = {"index": args.index, "backend": args.backend, "k": k,
                  "num_series": num_series, "codec": codec,
                  "device": str(dev),
                  "memory_budget_mb": args.memory_budget_mb,
                  "prefetch": args.prefetch or cfg.search.prefetch}

    streams = "ooc" in args.backend   # ooc-scan | ooc-local | dist-ooc
    if streams:
        rows["stream_rows"] = _OutOfCoreBase.budget_stream_rows(
            args.memory_budget_mb, series_len)

    t0 = time.perf_counter()
    backend = make_disk_backend(args.backend, args.index,
                                memory_budget_mb=args.memory_budget_mb,
                                prefetch=args.prefetch, shards=args.shards,
                                device=dev)
    rows["load_seconds"] = round(time.perf_counter() - t0, 3)
    if args.backend == "ooc-scan":
        # a scan_block too large for the budget is shrunk by the backend
        base_block = cfg.search.scan_block
        eff_block = backend.base_config.scan_block
        if eff_block != base_block:
            print(f"scan_block {base_block} -> {eff_block} "
                  f"(fit to the {args.memory_budget_mb} MiB budget)")
        rows["scan_block"] = eff_block

    eng = QueryEngine(backend)
    t0 = time.perf_counter()
    res = eng.knn(queries, k=k)
    rows["query_seconds"] = round(time.perf_counter() - t0, 3)
    print(f"{args.backend}: loaded in {rows['load_seconds']}s, answered "
          f"{len(queries)} queries in {rows['query_seconds']}s on {dev}")

    if streams:
        st = backend.stats()
        rows["read_wait_seconds"] = round(st["read_wait_seconds"], 4)
        rows["overlap_blocks"] = st["overlap_blocks"]
        rows["bytes_streamed"] = st["bytes_streamed"]
        rows["codec_fallbacks"] = st["codec_fallbacks"]
        if codec != "raw":
            print(f"codec {codec}: streamed {st['bytes_streamed']} bytes "
                  f"({st['codec_refine_rows']} candidate rows re-checked at "
                  f"float32, {st['codec_fallbacks']} fallbacks)")
        if args.backend == "dist-ooc":
            ds = st["dist"]
            rows["dist"] = ds
            print(f"dist-ooc: {ds['shards']} shards streamed "
                  f"{ds['rows_streamed']} rows (imbalance "
                  f"{ds['imbalance']:.2f}, plan {ds['plan_imbalance']:.2f})")
            for rng_, touched in zip(ds["row_range"], ds["rows_touched"]):
                if touched is not None and not (
                        rng_[0] <= touched[0] and touched[1] <= rng_[1]):
                    raise SystemExit(
                        f"dist-ooc: shard reader touched rows {touched} "
                        f"outside its assigned range {rng_}")
            print("dist-ooc: every shard reader stayed inside its row range")
        if args.prefetch == "thread" and args.verify != "none":
            # the threaded reader's answers equal the synchronous reader's
            # on the same backend and budget
            sync_be = make_disk_backend(
                args.backend, args.index,
                memory_budget_mb=args.memory_budget_mb, prefetch="sync",
                shards=args.shards, device=dev)
            _assert_same(f"{args.backend} prefetch thread==sync",
                         res, sync_be.knn(queries, k=k))
    _assert_readers_joined()

    if args.verify == "parity":
        # disk-fed vs in-memory, bit-identical
        mem_local = LocalBackend(HerculesIndex.build(data, cfg, device=dev))
        _assert_same("local", make_disk_backend("local", args.index, device=dev)
                     .knn(queries, k=k), mem_local.knn(queries, k=k))
        mem_scan = ScanBackend(torch.from_numpy(data).to(dev), cfg.search)
        disk_scan = make_disk_backend("scan", args.index, device=dev)
        _assert_same("scan", disk_scan.knn(queries, k=k),
                     mem_scan.knn(queries, k=k))
        shards = args.shards or len(shard_devices(device=dev))
        if num_series % shards == 0:
            mem_sh, disk_sh = (make_backend("sharded", x, index_config=cfg,
                                            num_shards=shards, device=dev)
                               for x in (data, stored))
            _assert_same(f"sharded (shards={shards})", disk_sh.knn(queries, k=k),
                         mem_sh.knn(queries, k=k))
        rows["parity"] = "bit-identical"
    elif args.verify == "exact":
        bf_d, bf_i = _exact_oracle(data, queries.to(dev), k)
        if not torch.equal(res.ids.long(), bf_i):
            raise SystemExit(f"{args.backend}: answers not exact vs brute "
                             f"force (ids differ)")
        if not torch.allclose(res.dists.double(), bf_d, rtol=1e-5, atol=1e-5):
            raise SystemExit(f"{args.backend}: answers not exact vs brute "
                             f"force (dists)")
        budget_bytes = args.memory_budget_mb * (1 << 20)
        coll_bytes = num_series * series_len * 4
        print(f"exact vs brute force: OK (collection {coll_bytes / 2**20:.2f}"
              f" MiB = {coll_bytes / budget_bytes:.1f}x the "
              f"{args.memory_budget_mb} MiB budget)")
        rows["exact"] = True
        rows["collection_over_budget"] = round(coll_bytes / budget_bytes, 2)
        rows["backend_stats"] = backend.stats()
    _write_json(args.json, rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default=None, help="cuda (default) or cpu")

    b = sub.add_parser("build", parents=[device],
                       help="chunked build -> save to disk")
    b.add_argument("--out", required=True)
    b.add_argument("--input", default=None,
                   help=".npy collection (memory-mapped); else synthetic")
    b.add_argument("--num", type=int, default=8192)
    b.add_argument("--length", type=int, default=64)
    b.add_argument("--seed", type=int, default=7)
    b.add_argument("--chunk-size", type=int, default=4096)
    b.add_argument("--leaf-size", type=int, default=128)
    b.add_argument("--k", type=int, default=1)
    b.add_argument("--l-max", type=int, default=8)
    b.add_argument("--verify-one-shot", action="store_true",
                   help="assert chunked build == one-shot build bit-for-bit")
    b.add_argument("--prefetch", choices=("sync", "thread"), default="sync",
                   help="chunk-read scheduling for the build (thread = "
                        "reader thread + two-slot host buffer; identical "
                        "bits either way)")
    b.add_argument("--codec", choices=list_codecs(), default="raw",
                   help="leaf codec for the base files (format v3); lossy "
                        "codecs stream fewer bytes, answers stay exact")
    b.add_argument("--json", default=None)
    b.set_defaults(fn=cmd_build)

    a = sub.add_parser("append", parents=[device],
                       help="append rows to a store as a journal segment")
    a.add_argument("--index", required=True)
    a.add_argument("--input", default=None,
                   help=".npy collection to append; else synthetic")
    a.add_argument("--num", type=int, default=2048)
    a.add_argument("--length", type=int, default=64)
    a.add_argument("--seed", type=int, default=11)
    a.add_argument("--chunk-size", type=int, default=4096)
    a.add_argument("--json", default=None)
    a.set_defaults(fn=cmd_append)

    c = sub.add_parser("compact", parents=[device],
                       help="fold journal segments into a new base "
                            "generation (bit-identical to a from-scratch "
                            "build over the whole collection)")
    c.add_argument("--index", required=True)
    c.add_argument("--chunk-size", type=int, default=4096)
    c.add_argument("--codec", choices=list_codecs(), default=None,
                   help="re-encode the new generation under this leaf codec "
                        "(default: keep the store's current codec)")
    c.add_argument("--json", default=None)
    c.set_defaults(fn=cmd_compact)

    q = sub.add_parser("query", parents=[device],
                       help="load a saved index and answer queries")
    q.add_argument("--index", required=True)
    q.add_argument("--backend", choices=backend_names("disk"), default="local")
    q.add_argument("--memory-budget-mb", type=float, default=64.0)
    q.add_argument("--queries", type=int, default=16)
    q.add_argument("--difficulty", default="5%")
    q.add_argument("--query-seed", type=int, default=1)
    q.add_argument("--k", type=int, default=1)
    q.add_argument("--prefetch", choices=("sync", "thread"), default=None,
                   help="ooc read scheduling override (default: the saved "
                        "config's). thread also asserts bit-parity against "
                        "the sync reader when --verify is set")
    q.add_argument("--shards", type=int, default=None,
                   help="shard count of --backend dist-ooc and of the sharded "
                        "--verify parity leg (default: one a visible card, "
                        "one on the CPU; several shards may share a card)")
    q.add_argument("--verify", choices=("none", "parity", "exact"),
                   default="none")
    q.add_argument("--json", default=None)
    q.set_defaults(fn=cmd_query)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
