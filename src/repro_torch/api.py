"""``repro_torch.api`` -- the port's one import for the index lifecycle.

Port of ``repro/api.py``, re-exporting what the port has so far. The
central object is the :class:`Hercules` store: one handle that owns an
index directory from creation through incremental ingest, compaction and
query serving, on one device (``device=``; ``None`` means the CUDA
device)::

    from repro_torch import api

    with api.Hercules.create("idx/", api.IndexConfig(), data=chunks_a) as hx:
        hx.append(chunks_b)            # journal segment; atomic commit
        res = hx.query(queries, k=5)   # exact: base index + journal merge
        hx.compact()                   # fold the journal into the base,
                                       # bit-identical to a from-scratch
                                       # build over A concat B
        engine = hx.engine("ooc-local", memory_budget_mb=64)
        engine.knn(queries)
        engine.telemetry().plan_cache  # hits/misses/invalidations

    hx = api.Hercules.open("idx/", mode="a")   # reopen later; "r" = serve only

The directory is the reference's format: a store either package wrote
opens, appends, serves and compacts in the other.

In-memory serving goes through :func:`make_backend` + :class:`QueryEngine`
(``local`` | ``scan`` | ``scan-mxu`` | ``sharded``); the disk backends
through :meth:`Hercules.engine` or :func:`make_disk_backend` (``local`` |
``scan`` | ``ooc-scan`` | ``ooc-local`` | ``dist-ooc``). Every servable
name lives in the one :data:`BACKENDS` registry. ``engine.knn(queries, wave=True)`` answers a
batch through the backend's wave plan (:func:`wave_knn` for ``local``),
bit for bit the per-query answers, and :class:`KnnServeEngine` serves a
stream of submitted queries in waves over any engine::

    serve = api.KnnServeEngine(engine, api.KnnServeConfig(batch_slots=32,
                                                          wave=True))
    rid = serve.submit(query)          # QueueFull past max_queue
    answers = serve.drain()            # {rid: KnnAnswer | KnnFailure}
    serve.telemetry().serving          # waves, rejected, failed, ...

**Sharding.** ``make_backend("sharded", data, num_shards=4)`` builds one
index a contiguous shard (:func:`build_distributed_index`, a
:class:`StackedIndex`); ``hx.engine("dist-ooc", shards=4)`` serves one
saved index from four shards, each streaming only its own leaf-run row
range (:class:`DistOutOfCoreBackend`; per-shard counters in
``telemetry().dist``, a :class:`DistTelemetry`). A shard runs on its entry
of ``devices`` (one a shard, repeats allowed: ``["cuda:0"] * 4`` puts four
shards on one card); by default shards go round-robin over the visible
cards. Answers equal ``local``'s bit for bit.
"""
from repro_torch.core.engine import (  # noqa: F401
    BACKENDS, BackendSpec, DistTelemetry, EngineConfig, LatencyTelemetry,
    LocalBackend, OocTelemetry, OutOfCoreLocalBackend, OutOfCoreScanBackend,
    PathsTelemetry, PlanCacheTelemetry, PruningTelemetry, QueryEngine,
    ScanBackend, SearchBackend, ShardedBackend, Telemetry, backend_names,
    dense_scan_knn, kernel_scan_knn, make_backend, make_disk_backend,
    resolve_backend_name,
)
from repro_torch.distributed import (  # noqa: F401
    DistOutOfCoreBackend, StackedIndex, build_distributed_index,
    distributed_knn,
)
from repro_torch.kernels.compat import KERNEL_MODES, resolve_kernel_mode  # noqa: F401
from repro_torch.core.index import HerculesIndex, IndexConfig  # noqa: F401
from repro_torch.core.search import (  # noqa: F401
    KnnResult, SearchConfig, brute_force_knn, pscan_knn, wave_knn,
)
from repro_torch.core.tree import BuildConfig, build_tree_chunked  # noqa: F401
from repro_torch.data.pipeline import (  # noqa: F401
    ArrayChunkSource, AsyncChunkReader, ChunkSource, NpyChunkSource,
    PREFETCH_MODES, SyncChunkReader, iter_device_chunks, iter_host_chunks,
    iter_scheduled_chunks, make_chunk_reader,
)
from repro_torch.serve.engine import (  # noqa: F401
    KnnAnswer, KnnFailure, KnnServeConfig, KnnServeEngine, QueueFull,
)
from repro_torch.storage import (  # noqa: F401
    BALANCE_WARN_RATIO, CODEC_CHOICES, Codec, FORMAT_VERSION, Hercules,
    IndexFormatError, SavedIndex, ShardPlan, build_index_streaming,
    build_index_to_disk, get_codec, list_codecs, load_index, open_index,
    partition_plan, register_codec, save_index, shard_plan,
)
