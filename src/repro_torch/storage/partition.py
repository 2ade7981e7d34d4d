"""Shard plans for serving one on-disk index from a mesh of readers.

Port of ``repro/storage/partition.py`` (numpy only, re-implemented so the
port imports nothing of the reference). The port writes the same
``partition`` manifest section as the reference; the sharded backend that
serves by these plans comes with a later slice.

A *shard plan* cuts the committed base generation into ``num_shards``
contiguous **leaf runs** (leaf in-order == file order, so a leaf range is a
row range) balanced by row count. The plan is what makes distributed
out-of-core serving safe and cheap:

* contiguity at leaf boundaries means every shard streams its rows through
  the same sequential-run machinery as the single-host backends — no leaf
  is ever split across two readers;
* balancing by *rows* (not leaves) bounds the worst shard's disk traffic,
  which is what the per-query latency of the merged answer waits on;
* determinism (pure function of the leaf tables) means a plan recorded in
  the manifest at commit time and a plan derived on open from an old
  manifest are the same plan — old indexes shard without a rewrite.

``write_manifest`` records one :func:`partition_section` per base
generation (shard counts :data:`RECORDED_SHARD_COUNTS`); :func:`shard_plan`
prefers the recorded plan and derives it from ``layout.npz`` leaf tables
when the manifest predates this section (format v1–v3 without it).

Guardrail: a plan whose ``max/min`` shard row ratio exceeds
:data:`BALANCE_WARN_RATIO` warns at construction — a skewed tree can
starve all but one reader, and the caller should know before benchmarking
a mesh against it.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np

#: max/min shard row ratio above which a plan is flagged as imbalanced.
BALANCE_WARN_RATIO = 2.0

#: Shard counts whose plans are precomputed into the manifest at commit
#: time. Any other count is derived on demand (same deterministic cut).
RECORDED_SHARD_COUNTS = (2, 4, 8)

PARTITION_SECTION_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """``num_shards`` contiguous leaf/row ranges over one base generation.

    ``leaf_bounds``/``row_bounds`` are ascending fence posts of length
    ``num_shards + 1``: shard ``i`` owns leaves
    ``[leaf_bounds[i], leaf_bounds[i+1])`` and file rows
    ``[row_bounds[i], row_bounds[i+1])``.
    """
    num_shards: int
    leaf_bounds: tuple[int, ...]
    row_bounds: tuple[int, ...]

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"num_shards={self.num_shards}; expected >= 1")
        for name in ("leaf_bounds", "row_bounds"):
            b = getattr(self, name)
            if len(b) != self.num_shards + 1:
                raise ValueError(f"{name} has {len(b)} fence posts; expected "
                                 f"{self.num_shards + 1}")
            if any(b[i] > b[i + 1] for i in range(len(b) - 1)):
                raise ValueError(f"{name} must be ascending: {b}")

    def leaf_range(self, shard: int) -> tuple[int, int]:
        return self.leaf_bounds[shard], self.leaf_bounds[shard + 1]

    def row_range(self, shard: int) -> tuple[int, int]:
        return self.row_bounds[shard], self.row_bounds[shard + 1]

    @property
    def shard_rows(self) -> tuple[int, ...]:
        return tuple(self.row_bounds[i + 1] - self.row_bounds[i]
                     for i in range(self.num_shards))

    @property
    def total_rows(self) -> int:
        return self.row_bounds[-1] - self.row_bounds[0]

    @property
    def imbalance(self) -> float:
        """max/min shard row count; ``inf`` when a shard is empty while
        another is not, ``1.0`` for a trivially empty plan."""
        rows = self.shard_rows
        if max(rows, default=0) == 0:
            return 1.0
        if min(rows) == 0:
            return float("inf")
        return max(rows) / min(rows)

    @property
    def balanced(self) -> bool:
        return self.imbalance <= BALANCE_WARN_RATIO

    def to_manifest(self) -> dict:
        return {"leaf_bounds": list(self.leaf_bounds),
                "row_bounds": list(self.row_bounds)}

    @classmethod
    def from_manifest(cls, num_shards: int, entry: dict) -> "ShardPlan":
        return cls(num_shards=int(num_shards),
                   leaf_bounds=tuple(int(b) for b in entry["leaf_bounds"]),
                   row_bounds=tuple(int(b) for b in entry["row_bounds"]))


def _warn_imbalance(plan: ShardPlan, origin: str) -> None:
    if not plan.balanced:
        warnings.warn(
            f"shard plan ({origin}) is imbalanced: per-shard rows "
            f"{plan.shard_rows} (max/min ratio "
            f"{plan.imbalance:.2f} > {BALANCE_WARN_RATIO}); a skewed tree "
            f"starves all but the largest shard's reader — consider fewer "
            f"shards or rebuilding with a smaller leaf_capacity",
            RuntimeWarning, stacklevel=3)


def partition_plan(leaf_start, leaf_count, num_shards: int, *,
                   warn: bool = True) -> ShardPlan:
    """Cut the leaf tables into ``num_shards`` contiguous runs balanced by
    row count: fence post ``i`` is the first leaf whose cumulative rows
    reach ``i/num_shards`` of the total (quantile cuts snapped to leaf
    boundaries). Pure and deterministic — the recorded and the derived
    plan for the same generation are identical.

    Every shard gets at least one leaf when there are enough leaves;
    otherwise trailing shards are empty (and the plan warns, since an
    empty shard next to a populated one is infinitely imbalanced).
    """
    if num_shards < 1:
        raise ValueError(f"num_shards={num_shards}; expected >= 1")
    starts = np.asarray(leaf_start, np.int64)
    counts = np.asarray(leaf_count, np.int64)
    if starts.shape != counts.shape or starts.ndim != 1:
        raise ValueError(
            f"leaf_start/leaf_count must be matching 1-D tables; got "
            f"{starts.shape} vs {counts.shape}")
    num_leaves = int(starts.shape[0])
    cum = np.cumsum(counts)
    total = int(cum[-1]) if num_leaves else 0
    row_end = int(starts[-1] + counts[-1]) if num_leaves else 0

    leaf_bounds = [0]
    for i in range(1, num_shards):
        target = total * i / num_shards
        m = int(np.searchsorted(cum, target, side="left")) + 1 \
            if num_leaves else 0
        if num_leaves >= num_shards:
            # leave room so every remaining shard still gets >= 1 leaf
            m = min(max(m, leaf_bounds[-1] + 1), num_leaves - (num_shards - i))
        else:
            m = min(max(m, leaf_bounds[-1]), num_leaves)
        leaf_bounds.append(m)
    leaf_bounds.append(num_leaves)

    row_bounds = [int(starts[m]) if m < num_leaves else row_end
                  for m in leaf_bounds]
    row_bounds[0] = 0
    plan = ShardPlan(num_shards=num_shards,
                     leaf_bounds=tuple(leaf_bounds),
                     row_bounds=tuple(row_bounds))
    if warn:
        _warn_imbalance(plan, origin="derived")
    return plan


def partition_section(leaf_start, leaf_count,
                      counts: tuple[int, ...] = RECORDED_SHARD_COUNTS) -> dict:
    """The manifest ``partition`` section for one base generation: one
    precomputed plan per shard count in ``counts`` (plans for other counts
    derive on open from the same leaf tables)."""
    plans = {}
    for n in counts:
        plans[str(int(n))] = partition_plan(
            leaf_start, leaf_count, int(n), warn=False).to_manifest()
    return {"version": PARTITION_SECTION_VERSION,
            "balanced_by": "rows",
            "plans": plans}


def shard_plan(saved, num_shards: int, *, warn: bool = True) -> ShardPlan:
    """The shard plan an opened index serves under: the manifest-recorded
    plan for this generation when present (format >= this PR), else derived
    from the resident leaf tables (old indexes shard without a rewrite —
    the cut is the same either way)."""
    section = (saved.manifest or {}).get("partition") or {}
    entry = section.get("plans", {}).get(str(int(num_shards)))
    if entry is not None:
        plan = ShardPlan.from_manifest(num_shards, entry)
        if warn:
            _warn_imbalance(plan, origin="recorded")
        return plan
    return partition_plan(saved.small["leaf_start"],
                          saved.small["leaf_count"], num_shards, warn=warn)
