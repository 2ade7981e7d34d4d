"""The plain reference: brute-force exact k-NN under squared Euclidean
distance, in plain PyTorch, in blocks.

It imports torch alone: nothing of the program, whose answers it judges.
Given the collection and the queries that the benchmark made, it works the
answers out again from them.

1. Candidates: the matmul identity ``|q|^2 + |s|^2 - 2 q.s`` in float32 with
   TF32 off, over blocks of rows, keeping the ``CANDIDATES`` smallest a
   query.
2. Answers: the candidates' distances again in float64 difference form
   ``sum((s - q)^2)``, ordered by (distance, row).
3. Proof that step 1 lost no answer: every row left out has a float32
   distance at least that of the last candidate, and a float32 distance is
   off by at most ``err = 2 n u (|q|^2 + max |s|^2)`` (a dot product of
   length n in float32, unit roundoff u, with the norms' own error). Where
   the last candidate's distance less ``err`` does not clear the k-th
   answer, the query is answered by the float64 difference form over every
   row instead.

:func:`control_knn` is the same step 1 in TF32, reporting its own
distances: the reference computed in the precision just below the
configuration's (float32 with TF32 off).
"""
from __future__ import annotations

import contextlib

import torch

CANDIDATES = 32
QUERY_BLOCK = 512
ROW_BLOCK = 1 << 20
_U32 = 2.0 ** -24


@contextlib.contextmanager
def _tf32(on: bool):
    """Turn TF32 matrix products on or off for the block, then restore."""
    matmul = torch.backends.cuda.matmul
    prev = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")
    try:
        yield
    finally:
        matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[0], prev[1]
        torch.set_float32_matmul_precision(prev[2])


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties to
    even): what a tensor core reads of a float32 operand. Used where no
    card does it (the CPU)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def _candidates(data, queries, c, *, tf32: bool, emulate_tf32: bool,
                row_block: int):
    """(Q, c) smallest matmul-identity float32 distances, their rows, and
    the largest squared norm of a row."""
    qn = queries.shape[0]
    dev = queries.device
    q = round_to_tf32(queries) if emulate_tf32 else queries
    q_norm = (queries * queries).sum(dim=1)
    best_d = torch.full((qn, 0), float("inf"), device=dev)
    best_i = torch.zeros((qn, 0), dtype=torch.int64, device=dev)
    s_max = torch.zeros((), device=dev)
    with _tf32(tf32):
        for lo in range(0, data.shape[0], row_block):
            s = data[lo:lo + row_block]
            s_norm = (s * s).sum(dim=1)
            s_max = torch.maximum(s_max, s_norm.max())
            prod = q @ (round_to_tf32(s) if emulate_tf32 else s).T
            d = (q_norm[:, None] + s_norm[None, :]).sub_(prod.mul_(2.0))
            del prod
            vals, idx = torch.topk(d, min(c, d.shape[1]), dim=1, largest=False)
            del d
            best_d = torch.cat([best_d, vals], dim=1)
            best_i = torch.cat([best_i, idx + lo], dim=1)
            if best_d.shape[1] > c:
                best_d, keep = torch.topk(best_d, c, dim=1, largest=False)
                best_i = torch.gather(best_i, 1, keep)
    order = torch.argsort(best_d, dim=1, stable=True)
    return torch.gather(best_d, 1, order), torch.gather(best_i, 1, order), s_max


def _ordered(d: torch.Tensor, rows: torch.Tensor, k: int):
    """The k smallest by (distance, row)."""
    by_row = torch.argsort(rows, dim=1, stable=True)
    d, rows = torch.gather(d, 1, by_row), torch.gather(rows, 1, by_row)
    by_d = torch.argsort(d, dim=1, stable=True)[:, :k]
    return torch.gather(d, 1, by_d), torch.gather(rows, 1, by_d)


def exact_distances(data: torch.Tensor, queries: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    """float64 difference-form squared distance of query i to each of
    ``data[rows[i]]`` (rows (Q, r) int64)."""
    s = data[rows.reshape(-1)].reshape(*rows.shape, data.shape[1]).double()
    diff = s - queries.double()[:, None, :]
    return (diff * diff).sum(dim=-1)


def _scan_exact(data: torch.Tensor, q: torch.Tensor, k: int,
                row_block: int = 1 << 18):
    """One query against every row in float64 difference form."""
    d = torch.cat([((data[lo:lo + row_block].double() - q.double()) ** 2).sum(dim=1)
                   for lo in range(0, data.shape[0], row_block)])
    rows = torch.arange(data.shape[0], device=q.device)
    return _ordered(d[None], rows[None], k)


def knn(data: torch.Tensor, queries: torch.Tensor, k: int, *,
        query_block: int = QUERY_BLOCK, row_block: int = ROW_BLOCK):
    """Exact k-NN of ``queries`` (Q, n) in ``data`` (N, n), both float32 on
    one device. Returns float64 distances (Q, k), int64 rows (Q, k) and
    the number of queries that needed the full scan."""
    n = data.shape[1]
    c = min(max(CANDIDATES, k + 1), data.shape[0])
    out_d, out_i, scans = [], [], 0
    for lo in range(0, queries.shape[0], query_block):
        q = queries[lo:lo + query_block]
        approx, rows, s_max = _candidates(data, q, c, tf32=False, emulate_tf32=False,
                                          row_block=row_block)
        d, rows_k = _ordered(exact_distances(data, q, rows), rows, k)
        if c < data.shape[0]:
            err = 2.0 * n * _U32 * ((q.double() ** 2).sum(dim=1) + float(s_max))
            unsure = (approx[:, -1].double() - err <= d[:, -1]).nonzero().flatten()
            for i in unsure.tolist():
                d[i], rows_k[i] = (t[0] for t in _scan_exact(data, q[i], k))
            scans += unsure.numel()
        out_d.append(d)
        out_i.append(rows_k)
    return torch.cat(out_d), torch.cat(out_i), scans


def control_knn(data: torch.Tensor, queries: torch.Tensor, k: int, *,
                emulate_tf32: bool = False, query_block: int = QUERY_BLOCK,
                row_block: int = ROW_BLOCK):
    """The reference computed in TF32: the matmul identity with TF32 on,
    its own distances reported (clamped at 0). ``emulate_tf32`` rounds the
    operands to TF32 by hand instead, for a device without tensor cores."""
    out_d, out_i = [], []
    for lo in range(0, queries.shape[0], query_block):
        q = queries[lo:lo + query_block]
        d, rows, _ = _candidates(data, q, k, tf32=not emulate_tf32,
                                 emulate_tf32=emulate_tf32, row_block=row_block)
        out_d.append(d.clamp_min(0.0).double())
        out_i.append(rows)
    return torch.cat(out_d), torch.cat(out_i)
