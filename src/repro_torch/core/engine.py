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
* :class:`OutOfCoreScanBackend` (``ooc-scan``) and
  :class:`OutOfCoreLocalBackend` (``ooc-local``) -- exact kNN over a
  memory-mapped on-disk index (``repro_torch.storage.open_index``) under a
  memory budget: the raw rows stream host-to-device in budget-bounded
  blocks, or under a lossy codec the encoded rows stream and only feed
  sound bounds, with every reported distance re-checked on float32 rows;
* :class:`QueryEngine` -- a serving session over one backend: pads each
  query batch to a bucket size, keeps an LRU cache of plans keyed by the
  whole ``SearchConfig``, and reports telemetry. A plan here is a bound
  callable (PyTorch runs eagerly), so building one costs next to nothing.

The sharded backends, the wave-fused plans and ``dist-ooc`` come with later
slices.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import os
import time
from typing import Any, Callable, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import lower_bounds as LB
from repro_torch.core import summaries as S
from repro_torch.core.index import HerculesIndex, IndexConfig
from repro_torch.core.search import (INF, KnnResult, SearchConfig, _merge_topk,
                                     _query_seg_stats, _stable_smallest,
                                     exact_knn, pscan_knn,
                                     validate_runtime_config)
from repro_torch.core.tree import HerculesTree, route_to_leaf
from repro_torch.data.pipeline import (READ_STAT_KEYS, ArrayChunkSource,
                                       iter_device_chunks, make_chunk_reader)
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import ops as kops
from repro_torch.kernels.compat import resolve_kernel_mode

logger = logging.getLogger(__name__)

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

def _diff_dists(data: torch.Tensor, queries: torch.Tensor,
                block: int | None = None) -> torch.Tensor:
    """(Q, N) difference-form squared ED (``sum((s - q)^2)`` per row, the
    arithmetic of every exact answer), in row blocks that bound the
    (Q, rows, n) working set."""
    num = data.shape[0]
    qn = queries.shape[0]
    d = torch.empty((qn, num), dtype=_F32, device=queries.device)
    step = max(1, _BLOCK_ELEMS // max(1, qn * queries.shape[1]))
    if block is not None:
        step = min(block, step)
    for lo in range(0, num, step):
        rows = data[lo:lo + step]
        d[:, lo:lo + rows.shape[0]] = LB.squared_ed(rows[None, :, :],
                                                    queries[:, None, :])
    return d


def dense_scan_knn(data: torch.Tensor, queries: torch.Tensor, k: int = 1,
                   block: int = 4096):
    """Exact scan in difference form (``sum((s - q)^2)`` per row -- the
    arithmetic of the index's leaf and refinement paths, hence bit-identical
    answers). Returns (Q, k) dists and positions.

    The reference folds ``block``-row blocks into a running top-k; the
    stable top-k over all rows at once is the same answer (see
    ``core/search.py``), so ``block`` only bounds the working set here.
    """
    qn = queries.shape[0]
    dev = queries.device
    d = _diff_dists(data, queries, block)
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
# Out-of-core backends -- serving a memory-mapped on-disk index under a budget
# ---------------------------------------------------------------------------

def _ooc_scan_block(rows: torch.Tensor, queries: torch.Tensor, base: int, *,
                    k: int, block: int, mode: str):
    """Top-k of one streamed row block through the in-memory scan hot path;
    positions shifted to global layout coordinates."""
    if mode == "ref":
        d, p = dense_scan_knn(rows, queries, k=k, block=block)
    else:
        d, p = kernel_scan_knn(rows, queries, k=k, block=block, mode=mode)
    return d, torch.where(p >= 0, p + base, -1)


def _ooc_refine_block(rows: torch.Tensor, base: int, valid: int,
                      queries: torch.Tensor, d0, p0, *, k: int):
    """Merge exact difference-form distances of one padded row block into
    each query's running top-k (rows at or past ``valid`` are masked)."""
    r = rows.shape[0]
    dev = queries.device
    pos = base + torch.arange(r, dtype=_I32, device=dev)
    d = _diff_dists(rows, queries)
    d[:, valid:] = INF
    return _merge_topk(d0, p0, d, pos.expand(queries.shape[0], r), k)


# -- codec-aware streaming (format v3 encoded leaves) -----------------------
#
# With a lossy codec the streamed bytes are approximations, so decoded
# distances can only *select* candidates, never answer. Per block each
# decoded distance d^ becomes a sound interval around the true distance
# through the per-row reconstruction bound e embedded at encode time
# (||s - s^|| <= e, storage/codecs.py):
#
#     sqrt(d_true) in [sqrt(d^) - e, sqrt(d^) + e]
#
# and two running sets are carried per query: the k smallest *upper* bounds
# (the kth provably upper-bounds the true kth distance) and the _CAND
# smallest *lower* bounds (the candidate pool). After the stream the
# candidates are re-checked against the float32 rows with the exact
# difference-form arithmetic -- distances bit-identical to LocalBackend --
# and a guard certifies completeness: every row left out of the pool had
# LB >= the kth UB, so it cannot beat the top-k. When the guard cannot
# certify a batch, the raw float32 stream answers it instead (counted in
# ``codec_fallbacks``, never wrong).

_CAND_MARGIN = 32   # candidate pool size = k + margin (see _codec_cand)

# slack for the float32 evaluation error of the decoded distances
# themselves (identity form, ||q||^2 + ||s^||^2 - 2 q.s^): additive in the
# squared domain, scaled by the norms. The stored per-row ``e`` covers only
# the reconstruction error.
_BOUND_REL = 1e-5
_BOUND_ABS = 1e-6


def _codec_cand(k: int, num: int) -> int:
    return min(num, k + _CAND_MARGIN)


def _merge_topc(d0, p0, d1, p1, c: int):
    """Per query (leading dims batch): merge (value, position) pairs and keep
    the ``c`` smallest, ties in merge order. No duplicate suppression: a
    codec stream visits each position once."""
    vals, idx = _stable_smallest(torch.cat([d0, d1], dim=-1), c)
    return vals, torch.gather(torch.cat([p0, p1], dim=-1), -1, idx)


def _codec_bounds_block(enc: torch.Tensor, queries: torch.Tensor, base: int,
                        valid: int, ub_d, ub_p, lb_d, lb_p, *, codec,
                        series_len: int, k: int, cand: int, mode: str):
    """Fold one encoded row block (B, W) uint8 into the UB/LB carries (see
    above); rows at or past ``valid`` are padding.

    For the bf16 codec on the CUDA path the decode is fused into the ED
    kernel (``kops.decode_bf16_ed_matrix``), which reads the payload in
    place inside ``enc`` and also returns the decoded rows' squared norms,
    so decoded float32 rows never reach device memory. Otherwise the block
    is decoded and the distances take the identity form in ``torch.matmul``
    (float32, TF32 off), as the reference's plain branch does."""
    num = enc.shape[0]
    dev = queries.device
    qn2 = S.fixed_order_sum(queries * queries)
    if codec.name == "bf16" and mode != "ref":
        payload, err = codec.split(enc)
        d_dec, sn2 = kops.decode_bf16_ed_matrix(queries, payload, mode=mode)
    else:
        rows, err = codec.decode(enc, series_len)
        sn2 = S.fixed_order_sum(rows * rows)
        d_dec = qn2[:, None] + sn2[None, :] - 2.0 * (queries @ rows.T)
    # additive slack in the squared domain, then a sound sqrt-scale interval
    delta = _BOUND_REL * (qn2[:, None] + sn2[None, :]) + _BOUND_ABS
    r_lo = S.sqrt_rn((d_dec - delta).clamp_min(0.0))
    r_hi = S.sqrt_rn(d_dec.clamp_min(0.0) + delta)
    lb = (r_lo - err[None, :]).clamp_min(0.0).square()
    ub = (r_hi + err[None, :]).square()
    live = torch.arange(num, device=dev) < valid
    pos = torch.where(live, base + torch.arange(num, dtype=_I32, device=dev), -1)
    lb = torch.where(live[None, :], lb, INF)
    ub = torch.where(live[None, :], ub, INF)
    pos_b = pos.expand(lb.shape)
    ub_d, ub_p = _merge_topc(ub_d, ub_p, ub, pos_b, k)
    lb_d, lb_p = _merge_topc(lb_d, lb_p, lb, pos_b, cand)
    return ub_d, ub_p, lb_d, lb_p


def _codec_exact_topk(rows: torch.Tensor, p: torch.Tensor,
                      queries: torch.Tensor, *, k: int):
    """Exact top-k over the gathered candidate rows (Q, C, n) at positions
    ``p`` (-1 = padding), in the difference form of ``_ooc_refine_block``:
    distances bit-identical to LocalBackend's."""
    d = LB.squared_ed(rows, queries[:, None, :])
    d = torch.where(p >= 0, d, INF)
    vals, idx = _stable_smallest(d, k)
    return vals, torch.gather(p, 1, idx)


def _alive_runs(alive: np.ndarray, base: int) -> list[tuple[int, int]]:
    """Contiguous True runs of a row-survival mask as absolute
    (start, count) pairs: the sub-extents the SAX filter could not prune."""
    idx = np.flatnonzero(alive)
    if idx.size == 0:
        return []
    breaks = np.flatnonzero(np.diff(idx) > 1)
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [idx.size - 1]])
    return [(base + int(idx[s]), int(idx[e] - idx[s] + 1))
            for s, e in zip(starts, ends)]


class _OutOfCoreBase(BackendBase):
    """Shared plumbing for backends that stream a ``SavedIndex``
    (``repro_torch.storage.open_index``): memory-mapped rows move
    host-to-device in blocks bounded by ``memory_budget_mb``; only small
    state (tree, leaf tables, permutation) is resident on ``device``
    (default: the CUDA device)."""

    def __init__(self, saved, config: SearchConfig | None = None,
                 memory_budget_mb: float = 64.0,
                 device: str | torch.device | None = None):
        if memory_budget_mb <= 0:
            raise ValueError("memory_budget_mb must be positive")
        self.saved = saved
        self.memory_budget_mb = float(memory_budget_mb)
        self._device = resolve_device(device)
        self._config = config or saved.config.search
        self._perm = torch.from_numpy(saved.small["perm"]).to(self._device)
        self._t = {"calls": 0, "blocks": 0, "rows_streamed": 0,
                   "bytes_streamed": 0, "sax_rows_read": 0,
                   "read_seconds": 0.0, "read_wait_seconds": 0.0,
                   "overlap_blocks": 0,
                   # wave-fused serving (a later slice of the port)
                   "wave_calls": 0, "wave_rows_shared": 0,
                   "runs_deduped": 0, "runs_skipped_bsf": 0,
                   # codec streaming (format v3): candidate rows re-checked
                   # against float32 rows, and batches the bounds guard
                   # could not certify
                   "codec_refine_rows": 0, "codec_fallbacks": 0}

    @property
    def device(self) -> torch.device:
        return self._device

    def _lrd(self) -> np.ndarray:
        """The LRD memmap; fails loudly if the SavedIndex was closed."""
        return self.saved._mapped("lrd")

    def _lsd(self) -> np.ndarray:
        return self.saved._mapped("lsd")

    def _enc(self) -> np.ndarray:
        return self.saved._mapped("enc")

    def _active_codec(self, cfg: SearchConfig):
        """The codec this call streams under, or ``None`` for the raw
        float32 path. ``"auto"`` follows the opened index; ``"raw"`` forces
        the float32 stream; any other name must match the index's codec."""
        from repro_torch.storage.codecs import get_codec

        name = cfg.codec
        saved_codec = self.saved.codec
        if name == "auto":
            name = saved_codec
        if name == "raw":
            return None
        if name != saved_codec:
            raise ValueError(
                f"codec={name!r} but the index at {self.saved.path!r} was "
                f"encoded with {saved_codec!r}; use codec='auto' or 'raw'")
        return get_codec(name)

    @property
    def series_len(self) -> int:
        return self.saved.series_len

    @property
    def base_config(self) -> SearchConfig:
        return self._config

    @classmethod
    def budget_stream_rows(cls, memory_budget_mb: float,
                           series_len: int) -> int:
        """Rows per streamed block under ``memory_budget_mb``: half the
        budget's float32 rows, since the stream keeps two blocks in flight
        (one being consumed, one being read and copied)."""
        budget_rows = int(memory_budget_mb * (1 << 20)) // (4 * series_len)
        return max(budget_rows // 2, 1)

    def stream_rows(self) -> int:
        """Cap on rows per streamed block (see :meth:`budget_stream_rows`)."""
        return self.budget_stream_rows(self.memory_budget_mb,
                                       self.saved.series_len)

    def _reader(self, rows, capacity: int, width: int, dtype, cfg: SearchConfig):
        return make_chunk_reader(rows, capacity, width, dtype,
                                 prefetch=cfg.prefetch, device=self._device)

    def _reap_reader(self, reader) -> None:
        """Close a chunk reader and fold its stats into the backend's."""
        reader.close()
        for key in READ_STAT_KEYS:
            self._t[key] += reader.stats[key]

    def _ids_of(self, p: torch.Tensor) -> torch.Tensor:
        safe = p.long().clamp(0, self._perm.shape[0] - 1)
        return torch.where(p >= 0, self._perm[safe], -1)

    def _count(self, rows: int, row_bytes: int | None = None) -> None:
        """Account one streamed block; codec streams pass their encoded row
        width so ``bytes_streamed`` is the real disk traffic."""
        self._t["blocks"] += 1
        self._t["rows_streamed"] += rows
        self._t["bytes_streamed"] += rows * (
            4 * self.saved.series_len if row_bytes is None else row_bytes)

    def _empty_carries(self, qn: int, width: int):
        return (torch.full((qn, width), INF, device=self._device),
                torch.full((qn, width), -1, dtype=_I32, device=self._device))

    def stats(self) -> dict:
        return {"num_series": self.saved.num_series,
                "series_len": self.saved.series_len,
                "memory_budget_mb": self.memory_budget_mb,
                "codec": self.saved.codec,
                **self._t}

    def _codec_finalize(self, q, cfg: SearchConfig, ub_d, ub_p, lb_d, lb_p,
                        valid_rows: int | None = None):
        """Certify, then re-check the codec carries exactly. Returns
        ``(d, p, uncertified)``: exact top-k distances and positions, and
        how many of the leading ``valid_rows`` queries (bucket padding is
        sliced away by the caller) the guard could not certify (0 = the
        answer is complete and exact)."""
        k = cfg.k
        theta = ub_d[:, k - 1]
        # every row left out of the LB pool had LB >= the pool's largest
        # kept LB; if that is >= theta (>= the true kth distance), dropped
        # and pruned rows can at most tie the kth answer
        certified = (lb_d[:, -1] >= theta).cpu().numpy()
        if valid_rows is not None:
            certified = certified[:valid_rows]
        bad = int(certified.size - int(certified.sum()))
        if bad:
            return None, None, bad
        cand_p = lb_p.cpu().numpy()
        safe = np.clip(cand_p, 0, max(self.saved.n_pad - 1, 0))
        # np.take gathers into a fresh array, never a view of the map
        rows = torch.from_numpy(np.take(self._lrd(), safe, axis=0)).to(self._device)
        self._t["codec_refine_rows"] += int(cand_p.size)
        self._t["bytes_streamed"] += int(cand_p.size) * 4 * self.saved.series_len
        d, p = _codec_exact_topk(rows, lb_p, q, k=k)
        return d, p, 0

    def describe(self) -> dict:
        d = super().describe()
        d.update(self.stats(), path=self.saved.path)
        return d


class OutOfCoreScanBackend(_OutOfCoreBase):
    """Exact kNN over an on-disk collection via a streamed blocked scan.

    The memory-mapped LRD file is read in row blocks sized to half of
    ``memory_budget_mb`` (two blocks in flight). ``cfg.prefetch`` picks the
    reader: ``"sync"`` reads inline, ``"thread"`` reads ahead on the reader
    thread into pinned slots; answers are bit-identical either way. A base
    ``scan_block`` too large for the budget's blocks is shrunk (logged) at
    construction. Each block runs the in-memory scan hot path
    (:func:`kernel_scan_knn` on the CUDA path, else :func:`dense_scan_knn`)
    and the running top-k merges through :func:`_merge_topk` in file order.
    Distances are bit-identical to :class:`ScanBackend`; ``ids`` are the
    original ids and equal the in-memory scan's except where distinct rows
    tie exactly at the top-k boundary (file order is leaf order).
    ``positions`` are layout (LRD) positions.
    """

    name = "ooc-scan"

    def __init__(self, saved, config: SearchConfig | None = None,
                 memory_budget_mb: float = 64.0,
                 device: str | torch.device | None = None):
        super().__init__(saved, config, memory_budget_mb, device)
        self._config = dataclasses.replace(self._config, force_scan=True)
        rows = self.stream_rows()
        if rows < self._config.scan_block:
            logger.warning(
                "ooc-scan: scan_block=%d exceeds the %g MiB budget's "
                "%d-row streamed blocks; shrinking scan_block to %d",
                self._config.scan_block, self.memory_budget_mb, rows, rows)
            self._config = dataclasses.replace(self._config, scan_block=rows)

    def _validate(self, cfg: SearchConfig) -> None:
        if self.stream_rows() < cfg.scan_block:
            raise ValueError(
                f"memory_budget_mb={self.memory_budget_mb} streams "
                f"{self.stream_rows()} rows per block (two blocks in "
                f"flight), less than one scan_block={cfg.scan_block}; "
                f"lower scan_block or raise the budget")

    def _block_rows(self, cfg: SearchConfig) -> int:
        return (self.stream_rows() // cfg.scan_block) * cfg.scan_block

    def _bind(self, cfg):
        mode = resolve_kernel_mode(cfg.kernel_mode, self._device)
        codec = self._active_codec(cfg)
        if codec is not None:
            def run(q, valid_rows=None):
                return self._stream_codec_knn(q, cfg, mode, codec,
                                              valid_rows=valid_rows)
            run.valid_aware = True
            return run
        return lambda q: self._stream_knn(q, cfg, mode)

    def _stream_knn(self, q: torch.Tensor, cfg: SearchConfig,
                    mode: str) -> KnnResult:
        num = self.saved.num_series
        k = cfg.k
        d, p = self._empty_carries(q.shape[0], k)
        blocks = ArrayChunkSource(self._lrd()[:num], self._block_rows(cfg))
        for start, rows in iter_device_chunks(blocks, self._device,
                                              prefetch=cfg.prefetch,
                                              telemetry=self._t):
            d_b, p_b = _ooc_scan_block(rows, q, start, k=k,
                                       block=cfg.scan_block, mode=mode)
            d, p = _merge_topk(d, p, d_b, p_b, k)
            self._count(rows.shape[0])
        self._t["calls"] += 1
        return self._fill_result(d, p, self._ids_of(p), path=3, accessed=num)

    def _stream_codec_knn(self, q: torch.Tensor, cfg: SearchConfig, mode: str,
                          codec, valid_rows: int | None = None) -> KnnResult:
        """Streamed scan over the encoded sidecar: decoded distances feed
        the UB/LB carries, then the candidates are re-checked on float32
        rows. Bit-identical distances to the raw stream, which answers
        instead when the guard cannot certify."""
        num = self.saved.num_series
        n = self.saved.series_len
        width = codec.row_bytes(n)
        k = cfg.k
        cand = _codec_cand(k, num)
        ub_d, ub_p = self._empty_carries(q.shape[0], k)
        lb_d, lb_p = self._empty_carries(q.shape[0], cand)
        blocks = ArrayChunkSource(self._enc()[:num], self.stream_rows(),
                                  dtype=np.uint8)
        for start, enc in iter_device_chunks(blocks, self._device,
                                             prefetch=cfg.prefetch,
                                             telemetry=self._t):
            ub_d, ub_p, lb_d, lb_p = _codec_bounds_block(
                enc, q, start, enc.shape[0], ub_d, ub_p, lb_d, lb_p,
                codec=codec, series_len=n, k=k, cand=cand, mode=mode)
            self._count(enc.shape[0], row_bytes=width)
        d, p, bad = self._codec_finalize(q, cfg, ub_d, ub_p, lb_d, lb_p,
                                         valid_rows=valid_rows)
        if bad:
            self._t["codec_fallbacks"] += bad
            return self._stream_knn(q, cfg, mode)
        self._t["calls"] += 1
        return self._fill_result(d, p, self._ids_of(p), path=3, accessed=num)


class OutOfCoreLocalBackend(_OutOfCoreBase):
    """Index-pruned out-of-core answering: touch only the leaves, and the
    series, the bounds cannot exclude.

    Resident state is the tree plus the per-leaf pruning tables; raw series
    stay on disk. Per batch: (1) seed BSF_k from each query's home leaf
    and its ``l_max`` best leaves by LB_EAPCA; (2) one LB_EAPCA pass over
    all leaf synopses; (3) for the leaves some query cannot prune, stream
    the LSD sidecar (m bytes per series) through the LB_SAX kernel, then
    fetch only the surviving rows as contiguous LRD runs cut into
    budget-bounded pieces and refine them with exact difference-form
    distances (the paper's phase-3 LSDFile pass). ``use_sax=False`` prunes
    at leaf granularity only. Exact by the no-false-dismissal argument: a
    leaf or series is skipped only if ``lb * (1 - lb_slack)`` >= the
    running BSF_k. Distances and ids are bit-identical to
    :class:`LocalBackend`'s.
    """

    name = "ooc-local"

    def __init__(self, saved, config: SearchConfig | None = None,
                 memory_budget_mb: float = 64.0,
                 device: str | torch.device | None = None):
        super().__init__(saved, config, memory_budget_mb, device)
        s = saved.small
        dev = self._device
        self._leaf_start = s["leaf_start"]
        self._leaf_count = s["leaf_count"]
        self._leaf_rank = s["leaf_rank"]
        self._srank = s["series_leaf_rank"]
        self._tree = HerculesTree(*[t.to(dev) for t in saved.tree])
        self._leaf_endpoints = torch.from_numpy(s["leaf_endpoints"]).long().to(dev)
        self._leaf_synopsis = torch.from_numpy(s["leaf_synopsis"]).to(dev)
        self._leaf_seg_lens = torch.from_numpy(s["leaf_seg_lens"]).to(dev)
        self._leaf_dead = torch.from_numpy(s["leaf_count"] <= 0).to(dev)

    def _validate(self, cfg: SearchConfig) -> None:
        if self.stream_rows() < self.saved.max_leaf:
            raise ValueError(
                f"memory_budget_mb={self.memory_budget_mb} streams "
                f"{self.stream_rows()} rows per block, less than one leaf "
                f"extent (max_leaf={self.saved.max_leaf}); raise the budget "
                f"or rebuild with a smaller leaf_capacity")

    def _bind(self, cfg):
        codec = self._active_codec(cfg)
        if codec is not None:
            def run(q, valid_rows=None):
                return self._stream_codec_knn(q, cfg, codec,
                                              valid_rows=valid_rows)
            run.valid_aware = True
            return run
        return lambda q: self._stream_knn(q, cfg)

    def _pad_bucket(self, count: int, cap: int) -> int:
        """Pad a piece to a power of two between max_leaf and the streaming
        cap, so tiny pieces don't pay a full-budget zero-fill and copy."""
        b = max(self.saved.max_leaf, 1)
        while b < count:
            b <<= 1
        return min(max(b, 1), max(cap, count))

    def _leaf_lbs(self, q: torch.Tensor) -> torch.Tensor:
        """(Q, L) squared LB_EAPCA of every query to every leaf synopsis
        (+inf for empty leaves): ``search._leaf_lbs`` batched, elementwise
        the same arithmetic, so the bounds equal LocalBackend's."""
        qp, qp2 = S.prefix_sums(q)                       # (Q, n+1)
        qm, qs = _query_seg_stats(qp, qp2, self._leaf_endpoints)   # (Q, L, M)
        lbs = LB.lb_eapca_node(qm, qs, self._leaf_synopsis, self._leaf_seg_lens)
        return torch.where(self._leaf_dead[None, :], INF, lbs)

    def _runs(self, needed: np.ndarray, max_rows: int):
        """Merge the needed leaves' extents into contiguous row intervals
        (leaf in-order is file order), then cut them into <= max_rows
        pieces."""
        intervals: list[list[int]] = []
        for r in np.flatnonzero(needed):
            lo = int(self._leaf_start[r])
            hi = lo + int(self._leaf_count[r])
            if hi <= lo:
                continue
            if intervals and intervals[-1][1] == lo:
                intervals[-1][1] = hi
            else:
                intervals.append([lo, hi])
        return [(s, min(max_rows, hi - s))
                for lo, hi in intervals for s in range(lo, hi, max_rows)]

    def _seed(self, q: torch.Tensor, cfg: SearchConfig, lbs: torch.Tensor):
        """Phase 1 (Alg. 11): the union over the batch of each query's home
        leaf and its ``l_max`` best leaves by LB_EAPCA -- the in-memory
        pipeline's visit set. Returns (sorted leaf ranks, (start, count,
        pad_to) extents of the non-empty ones)."""
        home = route_to_leaf(self._tree, q, self.saved.max_depth).cpu().numpy()
        home_ranks = self._leaf_rank[home]
        l_max = min(cfg.l_max, self.saved.num_leaves)
        _, best = _stable_smallest(lbs, l_max)           # (Q, l_max)
        seeded = sorted(set(int(r) for r in home_ranks if r >= 0)
                        | set(int(r) for r in best.cpu().numpy().ravel()))
        seeds = [(int(self._leaf_start[r]), int(self._leaf_count[r]),
                  self.saved.max_leaf) for r in seeded
                 if int(self._leaf_count[r]) > 0]
        return seeded, seeds

    def _prune_leaves(self, lbs, bsf, seeded, cfg: SearchConfig):
        """Phase 2: the leaves some query cannot prune against ``bsf``
        (seeded leaves excluded) and the per-query leaf pruning ratio."""
        slack = torch.tensor(1.0 - cfg.lb_slack, dtype=_F32, device=lbs.device)
        cand = lbs * slack < bsf[:, None]                # (Q, L)
        needed = cand.any(dim=0).cpu().numpy().copy()
        needed[seeded] = False
        n_alive = max(int((self._leaf_count > 0).sum()), 1)
        eapca_pr = 1.0 - S.div_rn(cand.sum(dim=1).to(_F32), n_alive)
        return needed, eapca_pr

    def _sax_filter(self, lsd_reader, q_paa, lbs, bsf, start: int, cnt: int,
                    cfg: SearchConfig, kmode: str):
        """Phase 3 for one piece: LB_SAX over its streamed codes (the
        ``lb_sax_matrix`` kernel on the CUDA path), maxed with the rows'
        leaf bounds. Returns ((Q,) alive counts, (cnt,) host alive mask)."""
        pad_to = self._pad_bucket(cnt, self.stream_rows())
        codes = lsd_reader.stage(lsd_reader.get())
        ranks = np.zeros((pad_to,), np.int64)
        ranks[:cnt] = self._srank[start:start + cnt]
        self._t["sax_rows_read"] += cnt
        dev = q_paa.device
        lb_row = torch.maximum(
            kops.lb_sax(q_paa, codes, self.saved.series_len, mode=kmode),
            lbs[:, torch.from_numpy(ranks).to(dev)])     # (Q, pad_to)
        slack = torch.tensor(1.0 - cfg.lb_slack, dtype=_F32, device=dev)
        live = ((lb_row * slack < bsf[:, None])
                & (torch.arange(pad_to, device=dev) < cnt)[None, :])
        return (live.sum(dim=1, dtype=_I32),
                live.any(dim=0).cpu().numpy()[:cnt])

    def _finish(self, d, p, cfg, rows_before, alive_counts, eapca_pr,
                visited: int) -> KnnResult:
        qn = d.shape[0]
        res = self._fill_result(
            d, p, self._ids_of(p), path=2,
            accessed=self._t["rows_streamed"] - rows_before)
        if cfg.use_sax:
            sax_pr = 1.0 - S.div_rn(alive_counts.to(_F32),
                                    max(self.saved.num_series, 1))
        else:
            sax_pr = torch.zeros((qn,), dtype=_F32, device=d.device)
        return res._replace(
            eapca_pr=eapca_pr, sax_pr=sax_pr,
            visited_leaves=torch.full((qn,), visited, dtype=_I32,
                                      device=d.device))

    def _drive_phases(self, q: torch.Tensor, cfg: SearchConfig, reader,
                      carries, fold, kth):
        """Phases 1-3 of :meth:`_stream_knn` and :meth:`_stream_codec_knn`.

        ``reader`` streams the row file (LRD, or the encoded sidecar); every
        extent either path fetches is submitted to it ahead of consumption,
        so with prefetch="thread" the next extent is read while this one is
        folded. ``fold(carries, start, cnt, rows)`` folds one staged extent
        into the carries, and ``kth(carries)`` is the (Q,) bound both
        filters prune against. Both readers are reaped here. Returns
        (carries, alive counts, eapca_pr, visited leaves)."""
        qn = q.shape[0]
        R = self.stream_rows()
        lsd_reader = None

        def fold_all(carries, extents):
            for start, cnt, pad_to in extents:
                reader.submit(start, cnt, pad_to)
            for start, cnt, _ in extents:
                carries = fold(carries, start, cnt, reader.stage(reader.get()))
            return carries

        try:
            lbs = self._leaf_lbs(q)                      # (Q, L)
            seeded, seeds = self._seed(q, cfg, lbs)
            seed_rows = sum(cnt for _, cnt, _ in seeds)
            carries = fold_all(carries, seeds)
            needed, eapca_pr = self._prune_leaves(lbs, kth(carries), seeded, cfg)
            pieces = self._runs(needed, R)
            # seeded rows were folded for every query: they count as alive
            alive_counts = torch.full((qn,), seed_rows, dtype=_I32, device=q.device)
            if not cfg.use_sax:
                carries = fold_all(carries, [(s, c, self._pad_bucket(c, R))
                                             for s, c in pieces])
            else:
                m_sax = int(self._lsd().shape[1])
                q_paa = S.paa(q, m_sax)
                kmode = resolve_kernel_mode(cfg.kernel_mode, self._device)
                lsd_reader = self._reader(self._lsd(), R, m_sax, np.uint8, cfg)
                # the sidecar stream is submitted up front: piece j+1's codes
                # are read while piece j filters and folds
                for start, cnt in pieces:
                    lsd_reader.submit(start, cnt, self._pad_bucket(cnt, R))
                for start, cnt in pieces:
                    alive_q, alive = self._sax_filter(
                        lsd_reader, q_paa, lbs, kth(carries), start, cnt, cfg, kmode)
                    alive_counts = alive_counts + alive_q
                    carries = fold_all(carries,
                                       [(s0, c0, self._pad_bucket(c0, R))
                                        for s0, c0 in _alive_runs(alive, start)])
        finally:
            self._reap_reader(reader)
            if lsd_reader is not None:
                self._reap_reader(lsd_reader)
        return carries, alive_counts, eapca_pr, len(seeded) + int(needed.sum())

    def _stream_knn(self, q: torch.Tensor, cfg: SearchConfig) -> KnnResult:
        k = cfg.k
        rows_before = self._t["rows_streamed"]

        def fold(carries, start, cnt, rows):
            self._count(cnt)
            return _ooc_refine_block(rows, start, cnt, q, *carries, k=k)

        reader = self._reader(self._lrd(), self.stream_rows(),
                              self.saved.series_len, np.float32, cfg)
        (d, p), alive_counts, eapca_pr, visited = self._drive_phases(
            q, cfg, reader, self._empty_carries(q.shape[0], k), fold,
            lambda c: c[0][:, k - 1])
        self._t["calls"] += 1
        return self._finish(d, p, cfg, rows_before, alive_counts, eapca_pr, visited)

    def _stream_codec_knn(self, q: torch.Tensor, cfg: SearchConfig, codec,
                          valid_rows: int | None = None) -> KnnResult:
        """Index-pruned streaming over the encoded sidecar: the phases of
        :meth:`_stream_knn` with the exact running top-k replaced by the
        UB/LB carries over decoded distances. The kth upper bound plays the
        BSF in both filters (it upper-bounds the true kth distance, so
        pruning stays exact), and the candidate pool is re-checked on
        float32 rows at the end; the raw stream answers a batch the guard
        cannot certify."""
        k = cfg.k
        n = self.saved.series_len
        width = codec.row_bytes(n)
        kmode = resolve_kernel_mode(cfg.kernel_mode, self._device)
        rows_before = self._t["rows_streamed"]
        cand = _codec_cand(k, self.saved.num_series)

        def fold(carries, start, cnt, enc):
            self._count(cnt, row_bytes=width)
            return _codec_bounds_block(enc, q, start, cnt, *carries, codec=codec,
                                       series_len=n, k=k, cand=cand, mode=kmode)

        reader = self._reader(self._enc(), self.stream_rows(), width, np.uint8, cfg)
        carries = (*self._empty_carries(q.shape[0], k),
                   *self._empty_carries(q.shape[0], cand))
        carries, alive_counts, eapca_pr, visited = self._drive_phases(
            q, cfg, reader, carries, fold, lambda c: c[0][:, k - 1])
        d, p, bad = self._codec_finalize(q, cfg, *carries, valid_rows=valid_rows)
        if bad:
            self._t["codec_fallbacks"] += bad
            return self._stream_knn(q, cfg)
        self._t["calls"] += 1
        return self._finish(d, p, cfg, rows_before, alive_counts, eapca_pr, visited)


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
class OocTelemetry:
    """Streaming counters of the out-of-core backends (``None`` for
    resident backends). ``bytes_streamed`` counts the bytes actually
    fetched (the encoded width under a codec, plus the float32 re-check
    rows); ``codec_refine_rows``/``codec_fallbacks`` account the exactness
    machinery of encoded streams. The wave counters stay 0 until the
    wave-fused plans are ported."""
    calls: int = 0
    blocks: int = 0
    rows_streamed: int = 0
    bytes_streamed: int = 0
    sax_rows_read: int = 0
    read_seconds: float = 0.0
    read_wait_seconds: float = 0.0
    overlap_blocks: int = 0
    wave_calls: int = 0
    wave_rows_shared: int = 0
    runs_deduped: int = 0
    runs_skipped_bsf: int = 0
    codec_refine_rows: int = 0
    codec_fallbacks: int = 0


@dataclasses.dataclass
class Telemetry:
    """The serving-telemetry report. ``ooc`` is filled for the out-of-core
    backends; ``dist`` stays ``None`` until the sharded backends are
    ported."""
    backend: str = ""
    calls: int = 0
    queries: int = 0
    plan_cache: PlanCacheTelemetry = dataclasses.field(
        default_factory=PlanCacheTelemetry)
    latency: LatencyTelemetry = dataclasses.field(default_factory=LatencyTelemetry)
    paths: PathsTelemetry = dataclasses.field(default_factory=PathsTelemetry)
    pruning: PruningTelemetry = dataclasses.field(default_factory=PruningTelemetry)
    ooc: OocTelemetry | None = None
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
        if getattr(plan, "valid_aware", False):
            # codec plans certify per query; bucket-padding rows (sliced
            # away below) must not trip the certify guard
            res = plan(q, valid_rows=qn)
        else:
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
        bstats = self.backend.stats()
        ooc = None
        if "rows_streamed" in bstats:
            ooc = OocTelemetry(**{f.name: bstats[f.name]
                                  for f in dataclasses.fields(OocTelemetry)
                                  if f.name in bstats})
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
                sax_mean=t["sax_pr_sum"] / n_stat),
            ooc=ooc)

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

@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One registered backend name: which construction paths serve it
    (``"memory"`` = :func:`make_backend` over a collection in memory,
    ``"disk"`` = :func:`make_disk_backend` over a saved index) and a
    one-line description."""
    name: str
    kinds: tuple[str, ...]
    description: str


#: The registry of servable backend names ported so far. Every name-based
#: entry point resolves through :func:`resolve_backend_name`.
BACKENDS: dict[str, BackendSpec] = {s.name: s for s in (
    BackendSpec("local", ("memory", "disk"),
                "Hercules index on the device: tree routing + EAPCA/SAX "
                "pruning + exact refine"),
    BackendSpec("scan", ("memory", "disk"),
                "exact dense scan of the full collection (ED kernels on CUDA)"),
    BackendSpec("scan-mxu", ("memory",), "dense scan in matmul-identity form"),
    BackendSpec("ooc-scan", ("disk",),
                "streamed blocked scan of the on-disk collection under a "
                "memory budget"),
    BackendSpec("ooc-local", ("disk",),
                "index-pruned out-of-core answering (stream only unprunable "
                "leaves/series)"),
)}


def backend_names(kind: str | None = None) -> tuple[str, ...]:
    """Registered backend names in registration order; ``kind`` filters to
    one construction path (``"memory"`` or ``"disk"``)."""
    return tuple(n for n, spec in BACKENDS.items()
                 if kind is None or kind in spec.kinds)


def resolve_backend_name(name: str, *, kind: str) -> BackendSpec:
    """The one place backend names are validated: the spec, or the one
    error message."""
    spec = BACKENDS.get(name)
    if spec is not None and kind in spec.kinds:
        return spec
    raise ValueError(f"unknown backend {name!r} for kind {kind!r}; expected "
                     f"one of {backend_names(kind)}")


def make_backend(name: str, data, *, index_config: IndexConfig | None = None,
                 search: SearchConfig | None = None,
                 device: str | torch.device | None = None) -> SearchBackend:
    """Build a backend over ``data`` (N, n) by name on ``device`` (default:
    the CUDA device; ``"cpu"`` to serve from the host).

    ``local`` builds the Hercules index; ``scan``/``scan-mxu`` serve the raw
    collection directly."""
    resolve_backend_name(name, kind="memory")
    dev = resolve_device(device)
    if name == "local":
        cfg = index_config or IndexConfig(search=search or SearchConfig())
        return LocalBackend(HerculesIndex.build(data, cfg, device=dev))
    scfg = search or (index_config.search if index_config else SearchConfig())
    tensor = data if isinstance(data, torch.Tensor) else \
        torch.from_numpy(np.array(data, dtype=np.float32, copy=True))
    return ScanBackend(tensor.to(device=dev, dtype=_F32).contiguous(), scfg,
                       mxu=name == "scan-mxu")


def make_disk_backend(name: str, path_or_saved, *,
                      search: SearchConfig | None = None,
                      memory_budget_mb: float = 64.0,
                      verify: bool = True,
                      prefetch: str | None = None,
                      device: str | torch.device | None = None) -> SearchBackend:
    """Serve a saved index by backend name on ``device`` (default: the CUDA
    device).

    ``path_or_saved`` is an index directory or an open ``SavedIndex``.
    ``local``/``scan`` materialize the saved arrays into the in-memory
    backends (bit-identical to the ones built from the original data);
    ``ooc-scan``/``ooc-local`` keep the big files memory-mapped and stream
    them under ``memory_budget_mb``. ``prefetch`` overrides
    ``SearchConfig.prefetch`` (``"thread"``: reader thread + pinned host
    slots; answers bit-identical to ``"sync"``).
    """
    from repro_torch.storage.format import open_index

    resolve_backend_name(name, kind="disk")
    dev = resolve_device(device)
    saved = open_index(os.fspath(path_or_saved), verify=verify) \
        if isinstance(path_or_saved, (str, os.PathLike)) else path_or_saved
    if prefetch is not None:
        search = dataclasses.replace(search or saved.config.search,
                                     prefetch=prefetch)
    if name == "local":
        idx = saved.to_index(dev)
        if search is not None:
            idx.config = dataclasses.replace(idx.config, search=search)
        return LocalBackend(idx)
    if name == "scan":
        data = torch.from_numpy(saved.original_data()).to(dev)
        return ScanBackend(data, search or saved.config.search)
    if name == "ooc-scan":
        return OutOfCoreScanBackend(saved, search, memory_budget_mb, dev)
    return OutOfCoreLocalBackend(saved, search, memory_budget_mb, dev)
