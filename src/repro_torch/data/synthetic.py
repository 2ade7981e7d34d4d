"""Synthetic data-series generation (paper §4.1 Datasets/Queries).

Port of ``repro/data/synthetic.py``:

* :func:`random_walks` -- the paper's *Synth* generator: cumulative sums of
  i.i.d. Gaussian(0, 1) steps, z-normalized;
* :func:`make_query_workload` -- the paper's query hardness protocol: pick
  dataset series and add Gaussian noise of variance sigma^2 in
  {0.01 .. 0.10} ("1%".."10%"), or draw fresh walks ("ood").

Draws come from a CPU ``torch.Generator``, and the walks are summed and
z-normalized on the CPU in fixed chunks of ``CHUNK_ROWS`` rows, each copied
into the result on the target device: so one seed gives the same data bit
for bit on every device, and host memory stays at one chunk. They are not
the reference's ``jax.random`` numbers; comparisons between the two
packages feed both the same numpy arrays instead.
"""
from __future__ import annotations

import torch

from repro_torch.core import summaries as S
from repro_torch.device import resolve_device

DIFFICULTY_LEVELS = ("1%", "2%", "5%", "10%", "ood")


CHUNK_ROWS = 1 << 16        # rows drawn, summed and normalized at a time


def _generator(seed: int) -> torch.Generator:
    return torch.Generator(device="cpu").manual_seed(seed)


def random_walks(num: int, length: int, *, seed: int = 0, znorm: bool = True,
                 device: str | torch.device | None = None) -> torch.Tensor:
    """(num, length) float32 random-walk series on ``device`` (default: the
    CUDA device); the same bits on every device for one (seed, shape)."""
    dev = resolve_device(device)
    out = torch.empty((num, length), dtype=torch.float32, device=dev)
    g = _generator(seed)
    for lo in range(0, num, CHUNK_ROWS):
        rows = min(CHUNK_ROWS, num - lo)
        walks = torch.cumsum(torch.randn((rows, length), generator=g,
                                         dtype=torch.float32), dim=-1)
        out[lo:lo + rows] = S.znormalize(walks) if znorm else walks
    return out


def make_query_workload(dataset: torch.Tensor, num_queries: int,
                        difficulty: str = "5%", *, seed: int = 1) -> torch.Tensor:
    """Queries of a given hardness from/against ``dataset`` (N, n), on the
    dataset's device: indices and noise drawn on the CPU, so the same
    dataset gives the same queries on every device."""
    if difficulty not in DIFFICULTY_LEVELS:
        raise ValueError(f"difficulty {difficulty!r} not in {DIFFICULTY_LEVELS}")
    dev = dataset.device
    n = dataset.shape[-1]
    if difficulty == "ood":
        return random_walks(num_queries, n, seed=seed, device=dev)
    sigma2 = float(difficulty.rstrip("%")) / 100.0
    g = _generator(seed)
    idx = torch.randint(0, dataset.shape[0], (num_queries,), generator=g)
    noise = torch.randn((num_queries, n), generator=g) * sigma2 ** 0.5
    return dataset[idx.to(dev)] + noise.to(dev)
