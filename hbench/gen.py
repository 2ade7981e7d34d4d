"""Collections and queries from a seed, made on the device.

A frozen copy of the recipe of ``repro_torch/data/synthetic.py``, which is
the paper's (Echihabi et al., PVLDB 15(10), 2022, section 4.1):

* *Synth*: random walks, cumulative sums of Gaussian(0, 1) steps, each
  z-normalized (zero mean, unit population variance);
* query hardness: a collection series plus Gaussian noise of variance
  sigma^2 ("1%" is sigma^2 = 0.01, ... "10%" is 0.10), or a fresh random
  walk ("rand", the paper's Synth-Rand).

Unlike the program's copy, which draws on the host, every draw here is made
by a ``torch.Generator`` on the device in a few large calls. Each stream of
draws has a generator of its own, seeded from (seed, stream name), so the
collection does not depend on the traffic and one seed gives the same
inputs on every run on the same kind of device.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

WALK_CHUNK_ROWS = 1 << 21     # rows drawn, summed and normalized per call


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of draws."""
    digest = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def random_walks(num: int, length: int, gen: torch.Generator,
                 device) -> torch.Tensor:
    """(num, length) float32 z-normalized random walks on ``device``."""
    out = torch.empty((num, length), dtype=torch.float32, device=device)
    for lo in range(0, num, WALK_CHUNK_ROWS):
        rows = min(WALK_CHUNK_ROWS, num - lo)
        w = torch.randn((rows, length), generator=gen, device=device,
                        dtype=torch.float32)
        w.cumsum_(dim=1)
        mu = w.mean(dim=1, keepdim=True)
        sd = w.std(dim=1, keepdim=True, correction=0).clamp_min(1e-8)
        out[lo:lo + rows] = w.sub_(mu).div_(sd)
        del w
    return out


def noise_variance(level: str) -> float | None:
    """sigma^2 of a hardness level ("5%" -> 0.05); None for "rand"."""
    if level == "rand":
        return None
    if not level.endswith("%"):
        raise ValueError(f"hardness level {level!r}: expected 'N%' or 'rand'")
    return float(level[:-1]) / 100.0


def queries(data: torch.Tensor, levels: list[str], seed: int,
            stream: str) -> torch.Tensor:
    """One query a level in ``levels`` (in that order), against ``data``
    (N, n) and on its device. The queries of one level are drawn together,
    from a generator of their own."""
    num, n = data.shape
    dev = data.device
    out = torch.empty((len(levels), n), dtype=torch.float32, device=dev)
    levels_arr = np.asarray(levels)
    for level in sorted(set(levels)):
        rows = torch.from_numpy(np.flatnonzero(levels_arr == level)).to(dev)
        g = generator(seed, f"{stream}/{level}", dev)
        var = noise_variance(level)
        if var is None:
            out[rows] = random_walks(rows.numel(), n, g, dev)
        else:
            idx = torch.randint(0, num, (rows.numel(),), generator=g, device=dev)
            noise = torch.randn((rows.numel(), n), generator=g, device=dev)
            out[rows] = data[idx] + noise * var ** 0.5
    return out


def mix(traffic: dict, count: int, seed: int, stream: str) -> tuple[list[str], np.ndarray]:
    """``count`` (hardness level, k) pairs in the traffic's equal shares.
    Each block of len(levels) x len(k) entries holds every combination
    once, in an order drawn from the seed: every seed gets the same set,
    and every prefix (what a window answers) the same shares to a block,
    in another order."""
    levels, ks = traffic["difficulty"], traffic["k"]
    combos = [(lv, k) for k in ks for lv in levels]
    rng = np.random.default_rng(stream_seed(seed, stream))
    order = [combos[j] for _ in range(-(-count // len(combos)))
             for j in rng.permutation(len(combos))][:count]
    return [lv for lv, _ in order], np.asarray([k for _, k in order], np.int64)
