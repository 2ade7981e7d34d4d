"""Unified query engine -- one search surface over every backend (part 1).

Port of the in-memory half of ``repro/core/engine.py``:

* :class:`LocalBackend` -- the in-process :class:`HerculesIndex` (the paper);
* :class:`ScanBackend` -- the dense exact scan (PSCAN). With ``kernel_mode``
  resolving to ``cuda`` (``auto`` on a CUDA device) it selects candidates
  with the hand-written ED kernels (:func:`kernel_scan_knn`) and reports
  difference-form distances; otherwise it runs :func:`dense_scan_knn`,
  whose arithmetic is the index's own, so answers are bit-identical to
  :class:`LocalBackend`. ``mxu=True`` (``scan-mxu``) is the matmul-identity
  scan :func:`~repro_torch.core.search.pscan_knn`;
* :class:`QueryEngine` -- a serving session over one backend: pads each
  query batch to a bucket size, keeps an LRU cache of plans keyed by the
  whole ``SearchConfig``, and reports telemetry. A plan here is a bound
  callable (PyTorch runs eagerly), so building one costs next to nothing.

The out-of-core, sharded and wave-fused paths come with later slices.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import lower_bounds as LB
from repro_torch.core.index import HerculesIndex, IndexConfig
from repro_torch.core.search import (INF, KnnResult, SearchConfig, _merge_topk,
                                     _stable_smallest, exact_knn, pscan_knn,
                                     validate_runtime_config)
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import ops as kops
from repro_torch.kernels.compat import resolve_kernel_mode

_F32 = torch.float32
_I32 = torch.int32
_BLOCK_ELEMS = 1 << 26


@runtime_checkable
class SearchBackend(Protocol):
    """What the engine may assume about an answering path."""

    name: str

    def resolve(self, k: int | None = None,
                overrides: dict[str, Any] | None = None) -> SearchConfig: ...

    def make_plan(self, cfg: SearchConfig, bucket: int
                  ) -> Callable[[torch.Tensor], KnnResult]: ...

    def knn(self, queries, k: int | None = None, **overrides: Any) -> KnnResult: ...

    def stats(self) -> dict: ...

    def describe(self) -> dict: ...


class BackendBase:
    """Shared resolve/describe plumbing; subclasses supply the compute."""

    name = "backend"

    @property
    def series_len(self) -> int | None:
        return None

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    @property
    def base_config(self) -> SearchConfig:
        raise NotImplementedError

    def _validate(self, cfg: SearchConfig) -> None:
        pass

    def resolve(self, k: int | None = None,
                overrides: dict[str, Any] | None = None) -> SearchConfig:
        cfg = self.base_config
        upd = dict(overrides or {})
        if k is not None:
            upd["k"] = k
        if upd:
            cfg = dataclasses.replace(cfg, **upd)
        self._validate(cfg)
        return cfg

    def make_plan(self, cfg: SearchConfig, bucket: int):
        """A callable answering a (bucket, n) float32 query batch under
        ``cfg``."""
        return self._bind(cfg)

    def knn(self, queries, k: int | None = None, **overrides: Any) -> KnnResult:
        """Direct (non-engine) call; serving code goes through
        :class:`QueryEngine`."""
        cfg = self.resolve(k, overrides)
        q = torch.as_tensor(queries, dtype=_F32).to(self.device)
        return self._bind(cfg)(q)

    def _bind(self, cfg: SearchConfig) -> Callable[[torch.Tensor], KnnResult]:
        raise NotImplementedError

    @staticmethod
    def _fill_result(dists, positions, ids, *, path: int = -1,
                     accessed: int = 0) -> KnnResult:
        """KnnResult from (dists, positions, ids), with the per-query fields
        the backend does not track filled by one convention: path ``-1`` =
        unknown, pruning ratios 0, ``accessed`` broadcast."""
        qn = dists.shape[0]
        dev = dists.device
        zeros_f = torch.zeros((qn,), dtype=_F32, device=dev)
        return KnnResult(
            dists=dists, positions=positions, ids=ids,
            path=torch.full((qn,), path, dtype=_I32, device=dev),
            eapca_pr=zeros_f, sax_pr=zeros_f.clone(),
            accessed=torch.full((qn,), accessed, dtype=_I32, device=dev),
            visited_leaves=torch.zeros((qn,), dtype=_I32, device=dev))

    def stats(self) -> dict:
        return {}

    def describe(self) -> dict:
        return {"backend": self.name, "device": str(self.device),
                "config": dataclasses.asdict(self.base_config)}


# ---------------------------------------------------------------------------
# Local backend -- the paper's single-node Hercules index
# ---------------------------------------------------------------------------

class LocalBackend(BackendBase):
    """In-process :class:`HerculesIndex` (tree + LRD/LSD layout)."""

    name = "local"

    def __init__(self, index: HerculesIndex):
        self.index = index

    @property
    def series_len(self) -> int:
        return self.index.layout.series_len

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def base_config(self) -> SearchConfig:
        return self.index.config.search

    def _validate(self, cfg: SearchConfig) -> None:
        validate_runtime_config(cfg, self.index.layout.lrd.shape[0])

    def _bind(self, cfg):
        idx = self.index
        return lambda q: exact_knn(idx.tree, idx.layout, q, cfg, idx.max_depth)

    def stats(self) -> dict:
        return self.index.stats()

    def describe(self) -> dict:
        d = super().describe()
        d["num_series"] = self.index.layout.num_series
        d["series_len"] = self.index.layout.series_len
        return d


# ---------------------------------------------------------------------------
# Scan backend -- PSCAN as a first-class backend
# ---------------------------------------------------------------------------

def dense_scan_knn(data: torch.Tensor, queries: torch.Tensor, k: int = 1,
                   block: int = 4096):
    """Exact scan in difference form (``sum((s - q)^2)`` per row -- the
    arithmetic of the index's leaf and refinement paths, hence bit-identical
    answers). Returns (Q, k) dists and positions.

    The reference folds ``block``-row blocks into a running top-k; the
    stable top-k over all rows at once is the same answer (see
    ``core/search.py``), so ``block`` only bounds the working set here.
    """
    num = data.shape[0]
    qn = queries.shape[0]
    dev = queries.device
    d = torch.empty((qn, num), dtype=_F32, device=dev)
    step = max(1, min(block, _BLOCK_ELEMS // max(1, qn * queries.shape[1])))
    for lo in range(0, num, step):
        rows = data[lo:lo + step]
        d[:, lo:lo + rows.shape[0]] = LB.squared_ed(rows[None, :, :],
                                                    queries[:, None, :])
    d0 = torch.full((qn, k), INF, device=dev)
    vals, idx = _stable_smallest(torch.cat([d0, d], dim=1), k)
    return vals, torch.where(idx < k, -1, idx - k).to(_I32)


def kernel_scan_knn(data: torch.Tensor, queries: torch.Tensor, k: int = 1,
                    block: int = 4096, mode: str = "auto"):
    """Exact scan whose candidate selection runs on the ED kernels.

    ``k == 1``: the fused :func:`ops.ed_min` 1-NN scan over the whole
    collection. ``k > 1``: one :func:`ops.ed_matrix` launch per ``block``
    rows and a per-block top-k. The reported distances of the selected rows
    are recomputed in difference form, and for ``k > 1`` merged across
    blocks through the shared :func:`_merge_topk`, so kernel arithmetic
    influences only the within-block candidate choice. Returns (Q, k)
    dists and positions.
    """
    num = data.shape[0]
    qn = queries.shape[0]
    dev = queries.device

    def exact_d(p):
        """Difference-form distances for selected positions (-1 -> inf)."""
        rows = data[p.long().clamp(0, num - 1)]                  # (Q, k, n)
        d = LB.squared_ed(rows, queries[:, None, :])
        return torch.where((p >= 0) & (p < num), d, INF)

    if k == 1:
        _, amin = kops.ed_min(queries, data, valid_n=num, mode=mode)
        p_top = amin[:, None].to(_I32)
        return exact_d(p_top), p_top

    d_top = torch.full((qn, k), INF, device=dev)
    p_top = torch.full((qn, k), -1, dtype=_I32, device=dev)
    for base in range(0, num, block):
        d_blk = kops.ed_matrix(queries, data[base:base + block], mode=mode)
        if d_blk.shape[1] < block:   # ragged tail: masked like the padded rows
            d_blk = torch.cat(
                [d_blk, d_blk.new_full((qn, block - d_blk.shape[1]), INF)], dim=1)
        vals, idx = _stable_smallest(d_blk, k)
        cand = torch.where(vals < INF, base + idx, -1).to(_I32)
        d_top, p_top = _merge_topk(d_top, p_top, exact_d(cand), cand, k)
    return d_top, p_top


class ScanBackend(BackendBase):
    """Dense scan over the raw collection (the PSCAN baseline).

    Arithmetic selection, in priority order:

    * ``cfg.kernel_mode`` resolving to ``cuda`` (explicitly, or ``auto`` on a
      CUDA device with ``mxu=False``): :func:`kernel_scan_knn`;
    * ``mxu=True``: matmul-identity distances (:func:`pscan_knn`); wins over
      the implicit ``auto`` resolution, never over an explicit ``cuda``;
    * otherwise the difference-form :func:`dense_scan_knn`.
    """

    name = "scan"

    def __init__(self, data: torch.Tensor, config: SearchConfig | None = None,
                 mxu: bool = False):
        self.data = data
        self._config = dataclasses.replace(config or SearchConfig(),
                                           force_scan=True)
        self.mxu = mxu

    @property
    def series_len(self) -> int:
        return int(self.data.shape[1])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def base_config(self) -> SearchConfig:
        return self._config

    def _result(self, d, p) -> KnnResult:
        # identity layout (pos == id); path 3 = forced scan, everything read
        return self._fill_result(d, p, p, path=3, accessed=self.data.shape[0])

    def _bind(self, cfg):
        mode = resolve_kernel_mode(cfg.kernel_mode, self.data.device)
        data, k, block = self.data, cfg.k, cfg.scan_block
        if mode == "cuda" and not (self.mxu and cfg.kernel_mode == "auto"):
            return lambda q: self._result(
                *kernel_scan_knn(data, q, k, block, cfg.kernel_mode))
        fn = pscan_knn if self.mxu else dense_scan_knn
        return lambda q: self._result(*fn(data, q, k, block))

    def stats(self) -> dict:
        return {"num_series": int(self.data.shape[0]),
                "series_len": int(self.data.shape[1])}

    def describe(self) -> dict:
        d = super().describe()
        d.update(self.stats(), mxu=self.mxu)
        return d


# ---------------------------------------------------------------------------
# The engine: bucketed batching + plan LRU + telemetry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlanCacheTelemetry:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    size: int = 0
    capacity: int = 0
    compiles: int = 0
    compile_s: float = 0.0


@dataclasses.dataclass
class LatencyTelemetry:
    total: float = 0.0
    last: float = 0.0
    mean_per_call: float = 0.0
    mean_per_query: float = 0.0


@dataclasses.dataclass
class PathsTelemetry:
    scan_eapca: int = 0
    scan_sax: int = 0
    pruned: int = 0
    forced_scan: int = 0
    unknown: int = 0


@dataclasses.dataclass
class PruningTelemetry:
    eapca_mean: float = 0.0
    sax_mean: float = 0.0


@dataclasses.dataclass
class Telemetry:
    """The serving-telemetry report. ``ooc`` and ``dist`` stay ``None``: the
    out-of-core and sharded backends that fill them are not ported yet."""
    backend: str = ""
    calls: int = 0
    queries: int = 0
    plan_cache: PlanCacheTelemetry = dataclasses.field(
        default_factory=PlanCacheTelemetry)
    latency: LatencyTelemetry = dataclasses.field(default_factory=LatencyTelemetry)
    paths: PathsTelemetry = dataclasses.field(default_factory=PathsTelemetry)
    pruning: PruningTelemetry = dataclasses.field(default_factory=PruningTelemetry)
    ooc: None = None
    dist: None = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    plan_cache_size: int = 32
    # explicit batch buckets (ascending); empty -> next power of two
    bucket_sizes: tuple[int, ...] = ()
    # pull per-query path/pruning stats to host after each call
    collect_result_stats: bool = True


class QueryEngine:
    """A serving session over one :class:`SearchBackend`.

    Every call pads the query batch up to a bucket size and runs the cached
    plan for (SearchConfig, bucket); ``telemetry().plan_cache`` counts hits,
    misses and evictions.
    """

    def __init__(self, backend: SearchBackend, config: EngineConfig | None = None):
        self.backend = backend
        self.config = config or EngineConfig()
        self._plans: collections.OrderedDict = collections.OrderedDict()
        self._t = {
            "calls": 0, "queries": 0,
            "hits": 0, "misses": 0, "evictions": 0,
            "compile_s": 0.0, "exec_s": 0.0, "last_exec_s": 0.0,
            "paths": np.zeros(4, np.int64), "path_unknown": 0,
            "eapca_pr_sum": 0.0, "sax_pr_sum": 0.0, "stat_queries": 0,
        }

    def _bucket(self, qn: int) -> int:
        for b in sorted(self.config.bucket_sizes):
            if qn <= b:
                return b
        return max(1, 1 << (qn - 1).bit_length())

    def knn(self, queries, k: int | None = None, valid_rows: int | None = None,
            **overrides: Any) -> KnnResult:
        """Answer a batch of queries (Q, n) or one query (n,).

        ``valid_rows``: when the caller already padded the batch, the number
        of leading real queries -- results are sliced and telemetry counted
        on those only."""
        dev = self.backend.device
        q = torch.as_tensor(queries, dtype=_F32).to(dev)
        if q.ndim == 1:
            q = q[None, :]
        n = getattr(self.backend, "series_len", None)
        if n and q.shape[1] != n:
            raise ValueError(f"query length {q.shape[1]} != collection "
                             f"series length {n}")
        cfg = self.backend.resolve(k, overrides)
        qn = q.shape[0] if valid_rows is None else valid_rows
        if not 0 < qn <= q.shape[0]:
            raise ValueError(f"valid_rows={valid_rows} out of range for "
                             f"batch of {q.shape[0]}")
        bucket = self._bucket(q.shape[0])
        if bucket != q.shape[0]:
            q = torch.cat([q, q.new_zeros((bucket - q.shape[0], q.shape[1]))])

        # plan_signature folds backend identity the SearchConfig cannot see
        # into the key (none of the ported backends has one yet)
        key = (cfg, bucket, q.shape[1], str(q.dtype),
               getattr(self.backend, "plan_signature", None))
        plan = self._plans.get(key)
        if plan is None:
            t0 = time.perf_counter()
            plan = self.backend.make_plan(cfg, bucket)
            self._t["compile_s"] += time.perf_counter() - t0
            self._t["misses"] += 1
            self._plans[key] = plan
            while len(self._plans) > self.config.plan_cache_size:
                self._plans.popitem(last=False)
                self._t["evictions"] += 1
        else:
            self._t["hits"] += 1
            self._plans.move_to_end(key)

        t0 = time.perf_counter()
        res = plan(q)
        synchronize(dev)
        dt = time.perf_counter() - t0
        self._t["exec_s"] += dt
        self._t["last_exec_s"] = dt
        self._t["calls"] += 1
        self._t["queries"] += qn

        if bucket != qn:
            res = KnnResult(*[a[:qn] for a in res])
        if self.config.collect_result_stats:
            self._record(res)
        return res

    def _record(self, res: KnnResult) -> None:
        path = res.path.cpu().numpy()
        known = path >= 0
        self._t["paths"] += np.bincount(path[known], minlength=4)[:4]
        self._t["path_unknown"] += int((~known).sum())
        if known.any():
            self._t["eapca_pr_sum"] += float(res.eapca_pr.cpu().numpy()[known].sum())
            self._t["sax_pr_sum"] += float(res.sax_pr.cpu().numpy()[known].sum())
            self._t["stat_queries"] += int(known.sum())

    def telemetry(self) -> Telemetry:
        t = self._t
        n_stat = max(t["stat_queries"], 1)
        return Telemetry(
            backend=self.backend.name,
            calls=t["calls"],
            queries=t["queries"],
            plan_cache=PlanCacheTelemetry(
                hits=t["hits"], misses=t["misses"],
                evictions=t["evictions"], size=len(self._plans),
                capacity=self.config.plan_cache_size,
                compiles=t["misses"], compile_s=t["compile_s"]),
            latency=LatencyTelemetry(
                total=t["exec_s"], last=t["last_exec_s"],
                mean_per_call=t["exec_s"] / max(t["calls"], 1),
                mean_per_query=t["exec_s"] / max(t["queries"], 1)),
            paths=PathsTelemetry(
                scan_eapca=int(t["paths"][0]), scan_sax=int(t["paths"][1]),
                pruned=int(t["paths"][2]), forced_scan=int(t["paths"][3]),
                unknown=t["path_unknown"]),
            pruning=PruningTelemetry(
                eapca_mean=t["eapca_pr_sum"] / n_stat,
                sax_mean=t["sax_pr_sum"] / n_stat))

    def describe(self) -> dict:
        return {
            "engine": {
                "plan_cache_size": self.config.plan_cache_size,
                "bucket_sizes": list(self.config.bucket_sizes) or "pow2",
                "cached_plans": [{"k": key[0].k, "bucket": key[1],
                                  "series_len": key[2]} for key in self._plans],
            },
            "backend": self.backend.describe(),
        }


# ---------------------------------------------------------------------------
# Name-based construction
# ---------------------------------------------------------------------------

#: The registry of servable backend names (the in-memory ones ported so
#: far), each with a one-line description.
BACKENDS: dict[str, str] = {
    "local": "Hercules index on the device: tree routing + EAPCA/SAX pruning "
             "+ exact refine",
    "scan": "exact dense scan of the full collection (ED kernels on CUDA)",
    "scan-mxu": "dense scan in matmul-identity form",
}


def backend_names() -> tuple[str, ...]:
    return tuple(BACKENDS)


def make_backend(name: str, data, *, index_config: IndexConfig | None = None,
                 search: SearchConfig | None = None,
                 device: str | torch.device | None = None) -> SearchBackend:
    """Build a backend over ``data`` (N, n) by name on ``device`` (default:
    the CUDA device; ``"cpu"`` to serve from the host).

    ``local`` builds the Hercules index; ``scan``/``scan-mxu`` serve the raw
    collection directly."""
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; expected one of "
                         f"{backend_names()}")
    dev = resolve_device(device)
    if name == "local":
        cfg = index_config or IndexConfig(search=search or SearchConfig())
        return LocalBackend(HerculesIndex.build(data, cfg, device=dev))
    scfg = search or (index_config.search if index_config else SearchConfig())
    tensor = data if isinstance(data, torch.Tensor) else \
        torch.from_numpy(np.array(data, dtype=np.float32, copy=True))
    return ScanBackend(tensor.to(device=dev, dtype=_F32).contiguous(), scfg,
                       mxu=name == "scan-mxu")
