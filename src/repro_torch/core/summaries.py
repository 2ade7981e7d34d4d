"""Data-series summarizations: PAA, iSAX, EAPCA (paper §2, Fig. 1).

Port of ``repro/core/summaries.py``: plain functions on tensors. A *series
collection* is an ``(N, n)`` float32 tensor. Conventions are the
reference's: squared distances, ``NUM_SAX_SEGMENTS = 16`` segments of
``SAX_ALPHABET = 256`` symbols, population (ddof=0) standard deviations,
and variable-length EAPCA segmentations stored as fixed-width right
endpoints padded by repeating ``n``.

Summation order. Sums over the series axis (:func:`fixed_order_sum`) and
the prefix sums (:func:`prefix_sums`) are written as sequences of
elementwise adds in a fixed order, so they round identically on the CPU and
on the CUDA device and for any batch shape. For the same reason square
roots go through :func:`sqrt_rn` and divisions by a Python number through
:func:`div_rn`. The build, the lower bounds and
every difference-form distance are therefore bit-identical across devices
and across the paths that compute them. Against the reference they agree
within fp32 rounding: XLA accumulates in another order.
"""
from __future__ import annotations

import torch

NUM_SAX_SEGMENTS = 16
SAX_ALPHABET = 256

_CELL_BIG = 3.0e38


# ---------------------------------------------------------------------------
# Fixed-order reductions
# ---------------------------------------------------------------------------

def fixed_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by pairwise halving: element ``i`` of the first
    half is added to element ``i`` of the second half until one column is
    left (an odd width carries its last column). Returns ``x.shape[:-1]``."""
    w = x.shape[-1]
    if w == 0:
        return x.new_zeros(x.shape[:-1])
    while w > 1:
        h = w // 2
        head = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([head, x[..., 2 * h:w]], dim=-1) if w % 2 else head
        w = x.shape[-1]
    return x[..., 0]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root on every device: taken in float64 and
    rounded once, which is exact for a square root (53 >= 2 * 24 + 2).
    PyTorch's float32 CPU square root is not correctly rounded on every
    build, while the CUDA one is."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def div_rn(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` for a Python number ``d``, as a rounded division on every
    device: PyTorch's CUDA path multiplies by the reciprocal of a host
    scalar divisor instead, which rounds differently."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _inclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis by recursive doubling: step
    ``s`` adds the value ``s`` places to the left (Hillis-Steele)."""
    n = x.shape[-1]
    shift = 1
    while shift < n:
        x = torch.cat([x[..., :shift], x[..., shift:] + x[..., :-shift]], dim=-1)
        shift *= 2
    return x


# ---------------------------------------------------------------------------
# z-normalization
# ---------------------------------------------------------------------------

def znormalize(series: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Z-normalize each series (zero mean, unit population variance)."""
    mu = series.mean(dim=-1, keepdim=True)
    sd = series.std(dim=-1, keepdim=True, correction=0)
    return (series - mu) / sd.clamp_min(eps)


# ---------------------------------------------------------------------------
# PAA + iSAX
# ---------------------------------------------------------------------------

def paa(series: torch.Tensor, num_segments: int = NUM_SAX_SEGMENTS) -> torch.Tensor:
    """Piecewise Aggregate Approximation: (..., n) -> (..., num_segments)."""
    n = series.shape[-1]
    if n % num_segments:
        raise ValueError(f"series length {n} not divisible by {num_segments}")
    seg = n // num_segments
    segs = series.reshape(*series.shape[:-1], num_segments, seg).to(torch.float32)
    # left-to-right sum over each segment: the order XLA uses on the CPU, so
    # the PAA values (and the iSAX codes cut from them) round as the
    # reference's do
    total = segs[..., 0]
    for j in range(1, seg):
        total = total + segs[..., j]
    return div_rn(total, seg)


def sax_breakpoints(alphabet: int = SAX_ALPHABET,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """(alphabet-1,) ascending standard-normal quantiles, float32.

    Evaluated in float64 on the CPU and rounded once, so every device gets
    the same table (within 2 ulp of the reference's float32 evaluation)."""
    qs = torch.arange(1, alphabet, dtype=torch.float64) / alphabet
    return torch.special.ndtri(qs).to(torch.float32).to(device)


def isax_from_paa(paa_vals: torch.Tensor, alphabet: int = SAX_ALPHABET) -> torch.Tensor:
    """Discretize PAA values to iSAX symbols (uint8 codes, alphabet <= 256)."""
    bps = sax_breakpoints(alphabet, paa_vals.device)
    codes = torch.searchsorted(bps, paa_vals.contiguous(), right=True)
    return codes.to(torch.uint8)


def isax(series: torch.Tensor, num_segments: int = NUM_SAX_SEGMENTS,
         alphabet: int = SAX_ALPHABET) -> torch.Tensor:
    """iSAX summary of each series: (..., num_segments) uint8 codes."""
    return isax_from_paa(paa(series, num_segments), alphabet)


def isax_cell_bounds(codes: torch.Tensor, alphabet: int = SAX_ALPHABET
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-symbol cell ``[lo, hi]`` bounds (float32, shape of ``codes``).
    Open ends use +-3e38 (not inf) so masked arithmetic stays finite."""
    bps = sax_breakpoints(alphabet, codes.device)
    c = codes.long()
    big = torch.tensor(_CELL_BIG, dtype=torch.float32, device=codes.device)
    lo = torch.where(c == 0, -big, bps[(c - 1).clamp_min(0)])
    hi = torch.where(c == alphabet - 1, big, bps[c.clamp_max(alphabet - 2)])
    return lo, hi


# ---------------------------------------------------------------------------
# Prefix sums + variable-segment (EAPCA) statistics
# ---------------------------------------------------------------------------

def prefix_sums(series: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, n) -> (P, P2), each (N, n+1) float32 with ``P[:, 0] = 0``, so the
    sum over ``[a, b)`` is ``P[:, b] - P[:, a]``."""
    x = series.to(torch.float32)
    z = x.new_zeros((*x.shape[:-1], 1))
    p = torch.cat([z, _inclusive_scan(x)], dim=-1)
    p2 = torch.cat([z, _inclusive_scan(x * x)], dim=-1)
    return p, p2


def _starts(endpoints: torch.Tensor) -> torch.Tensor:
    zero = endpoints.new_zeros((*endpoints.shape[:-1], 1))
    return torch.cat([zero, endpoints[..., :-1]], dim=-1)


def segment_stats_from_prefix(p: torch.Tensor, p2: torch.Tensor,
                              endpoints: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment (mean, std) under a per-row segmentation.

    ``p``/``p2``: (N, n+1); ``endpoints``: (N, M) right endpoints. Returns
    (means, stds), each (N, M); empty segments give 0."""
    ep = endpoints.long()
    st = _starts(ep)
    lens = (ep - st).to(torch.float32)
    safe = lens.clamp_min(1.0)
    s1 = torch.gather(p, -1, ep) - torch.gather(p, -1, st)
    s2 = torch.gather(p2, -1, ep) - torch.gather(p2, -1, st)
    mean = s1 / safe
    var = (s2 / safe - mean * mean).clamp_min(0.0)
    std = sqrt_rn(var)
    empty = lens <= 0
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    return torch.where(empty, zero, mean), torch.where(empty, zero, std)


def eapca(series: torch.Tensor, endpoints: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """EAPCA (per-segment mean, std) of each series; ``endpoints`` is (M,) or
    (N, M). Returns (means, stds), each (N, M)."""
    p, p2 = prefix_sums(series)
    if endpoints.ndim == 1:
        endpoints = endpoints.expand(series.shape[0], endpoints.shape[0])
    return segment_stats_from_prefix(p, p2, endpoints)


def segment_lengths(endpoints: torch.Tensor) -> torch.Tensor:
    """Segment lengths (float32) from right endpoints."""
    return (endpoints - _starts(endpoints)).to(torch.float32)


# ---------------------------------------------------------------------------
# Node synopsis (paper §3.2): per-segment [mu_min, mu_max, sd_min, sd_max]
# ---------------------------------------------------------------------------

def synopsis_from_stats(means: torch.Tensor, stds: torch.Tensor) -> torch.Tensor:
    """(N, M) means/stds of a set of series -> (M, 4) synopsis."""
    return torch.stack([means.amin(0), means.amax(0),
                        stds.amin(0), stds.amax(0)], dim=-1)


def merge_synopses(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two (..., M, 4) synopses over the same segmentation."""
    return torch.stack([
        torch.minimum(a[..., 0], b[..., 0]), torch.maximum(a[..., 1], b[..., 1]),
        torch.minimum(a[..., 2], b[..., 2]), torch.maximum(a[..., 3], b[..., 3]),
    ], dim=-1)
