"""The comparison that decides ``correct``.

Every answer that the window's serving engine handed out is held to the
plain reference (``reference.py``) on the same collection and query. Two
numbers are compared:

* ``gap``: the larger of two relative gaps, over every answer and rank:
  ``dist_gap``, a reported distance against the reference's distance at
  the same rank, and ``id_gap``, the true (float64) distance of a reported
  id against the reference's distance at that rank, so a wrong id fails
  even where its reported distance is right, and two ids at a tie pass
  either way. An id outside the collection, or one reported twice in an
  answer, reads infinite;
* ``unanswered``: requests of the window that got no answer or a failure
  (an exact comparison: limit 0).

``LIMITS`` holds each number's limit; ``PERF.md`` gives the readings that
the limit of ``gap`` was set from (the program's over a dozen seeds and
more, below; the TF32 control's, above).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from hbench import reference

LIMITS = {"gap": 1e-4, "unanswered": 0}
_ANSWER_BLOCK = 4096


def _worst(a: float, b: float) -> float:
    """The larger gap, NaN winning (``max`` would drop it)."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def gaps(data: torch.Tensor, queries: torch.Tensor, dists: torch.Tensor,
         ids: torch.Tensor, ref_d: torch.Tensor) -> tuple[float, float]:
    """(dist_gap, id_gap) of answers (A, k) to ``queries`` (A, n) against
    the reference's distances ``ref_d`` (A, k) float64."""
    if dists.shape[0] == 0:
        return 0.0, 0.0
    scale = ref_d.clamp_min(1e-30)
    dist_gap = float(((dists.double() - ref_d).abs() / scale).max())
    ids = ids.long()
    bad = ((ids < 0) | (ids >= data.shape[0])).any(dim=1)
    srt = ids.sort(dim=1).values
    bad |= (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    id_gap = math.inf if bool(bad.any()) else 0.0
    for lo in range(0, ids.shape[0], _ANSWER_BLOCK):
        sl = slice(lo, lo + _ANSWER_BLOCK)
        true_d = reference.exact_distances(
            data, queries[sl], ids[sl].clamp(0, data.shape[0] - 1))
        gap = float(((true_d - ref_d[sl]).abs() / scale[sl]).max())
        id_gap = _worst(id_gap, gap)
    return dist_gap, id_gap


def judge_served(data: torch.Tensor, pool: torch.Tensor, served: list,
                 attempted: int) -> tuple[dict, dict]:
    """The numbers of the window's answers. ``served`` holds (pool index,
    k, dists, ids) per answered request, ``attempted`` counts every request
    of the window. Returns the compared numbers, and ``dist_gap``,
    ``id_gap`` and ``scans`` (queries the reference answered by a full
    scan) apart."""
    dev = data.device
    by_k: dict[int, list] = {}
    for rec in served:
        by_k.setdefault(rec[1], []).append(rec)
    wrong_shape = sum(1 for rec in served
                      if np.shape(rec[2]) != (rec[1],) or np.shape(rec[3]) != (rec[1],))
    detail = {"dist_gap": 0.0, "id_gap": math.inf if wrong_shape else 0.0, "scans": 0}
    numbers = {"gap": detail["id_gap"], "unanswered": attempted - len(served)}
    if not served:
        return numbers, detail
    uniq = sorted({rec[0] for rec in served})
    where = {p: i for i, p in enumerate(uniq)}
    kmax = max(by_k)
    ref_d, _, detail["scans"] = reference.knn(data, pool[torch.tensor(uniq, device=dev)],
                                              kmax)
    for k, recs in by_k.items():
        recs = [r for r in recs if np.shape(r[2]) == (k,) and np.shape(r[3]) == (k,)]
        if not recs:
            continue
        rows = torch.tensor([where[r[0]] for r in recs], device=dev)
        pidx = torch.tensor([r[0] for r in recs], device=dev)
        d = torch.from_numpy(np.stack([r[2] for r in recs]).astype(np.float32)).to(dev)
        i = torch.from_numpy(np.stack([r[3] for r in recs]).astype(np.int64)).to(dev)
        dg, ig = gaps(data, pool[pidx], d, i, ref_d[rows, :k])
        detail["dist_gap"] = _worst(detail["dist_gap"], dg)
        detail["id_gap"] = _worst(detail["id_gap"], ig)
    numbers["gap"] = _worst(detail["dist_gap"], detail["id_gap"])
    return numbers, detail


def passes(numbers: dict, limits: dict = LIMITS) -> bool:
    """Every number at or under its limit (NaN fails)."""
    return all(numbers[name] <= limit for name, limit in limits.items())
