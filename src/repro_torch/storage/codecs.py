"""Pluggable leaf-compression codecs for the on-disk LRD hot path.

Port of ``repro/storage/codecs.py``. Format v3 indexes may carry, next to
the raw float32 ``lrd.npy``, an *encoded* sidecar (``enc.npy``) holding one
fixed-width ``uint8`` row per series. The out-of-core backends stream the
encoded rows instead of the raw ones (fewer bytes off disk), decode them on
the device, and use the decoded values only to *select* candidates; every
reported answer is re-checked against the full-precision rows, so every
codec, lossy or not, gives answers bit-identical to the raw stream.

A codec is a frozen dataclass registered by name:

``encode(block)``
    host numpy: ``(B, n) float32 -> (B, row_bytes(n)) uint8``. A lossy
    codec embeds in each row a bound ``e >= ||s - decode(encode(s))||_2``
    (computed in float64 and inflated), so the engine can turn approximate
    distances into sound lower and upper bounds. The bytes equal the
    reference's.
``decode(enc, series_len)``
    on ``enc``'s device: ``(B, W) uint8 -> ((B, n) float32 rows, (B,)
    float32 err)``; the rows are a fresh tensor, never a view of ``enc``.
``exact``
    whether ``decode(encode(x)) == x`` bit for bit (then ``err == 0``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import summaries as S
from repro_torch.kernels.ref import decode_bf16_ref

__all__ = [
    "Codec",
    "RawCodec",
    "Bf16Codec",
    "SaxResidualCodec",
    "register_codec",
    "get_codec",
    "list_codecs",
    "CODEC_CHOICES",
    "sax_segments_for",
]

# Error bounds are computed in float64 and inflated by this relative margin
# before being narrowed to float32, so the stored bound stays sound after
# the narrowing and the engine's float32 bound arithmetic.
_ERR_INFLATE = 1.0 + 1e-6


@runtime_checkable
class Codec(Protocol):
    """Protocol for leaf codecs (see the module docstring)."""

    name: str
    exact: bool

    def row_bytes(self, series_len: int) -> int:
        """Encoded bytes per series."""

    def encode(self, block: np.ndarray) -> np.ndarray:
        """Host: ``(B, n) float32 -> (B, row_bytes(n)) uint8``."""

    def decode(self, enc: torch.Tensor, series_len: int):
        """``(B, W) uint8 -> (rows f32, err f32)`` on ``enc``'s device."""


def _err_bound(block: np.ndarray, decoded: np.ndarray) -> np.ndarray:
    """Sound per-row float32 upper bound on ``||row - decoded_row||_2``.

    ``decoded`` is one float32 evaluation of the decode arithmetic; another
    evaluation (a fused multiply-add on another device) may differ by about
    one ulp per element, so an analytic margin proportional to the row
    norms is added to the measured error.
    """
    b64 = block.astype(np.float64)
    d64 = decoded.astype(np.float64)
    diff = b64 - d64
    margin = (np.sqrt(np.sum(d64 * d64, axis=1))
              + np.sqrt(np.sum(b64 * b64, axis=1))) * 2.0 ** -21 + 1e-6
    err = (np.sqrt(np.sum(diff * diff, axis=1)) + margin) * _ERR_INFLATE
    err32 = err.astype(np.float32)
    # the float64 -> float32 narrowing may round down; bump one ulp if so
    return np.where(err32.astype(np.float64) < err,
                    np.nextafter(err32, np.float32(np.inf)), err32)


def _f32_column(enc: torch.Tensor, lo: int) -> torch.Tensor:
    """(B,) float32 from the 4 bytes at byte offset ``lo`` of each row."""
    return enc[:, lo:lo + 4].contiguous().view(torch.float32)[:, 0]


@dataclasses.dataclass(frozen=True)
class RawCodec:
    """Identity codec: rows are the float32 bytes themselves. No ``enc.npy``
    is written for it; the engine streams ``lrd.npy`` directly."""

    name: str = "raw"
    exact: bool = True

    def row_bytes(self, series_len: int) -> int:
        return 4 * series_len

    def encode(self, block: np.ndarray) -> np.ndarray:
        rows = np.ascontiguousarray(block, dtype=np.float32)
        return rows.view(np.uint8).reshape(rows.shape[0], -1)

    def decode(self, enc: torch.Tensor, series_len: int):
        rows = enc.contiguous().view(torch.float32).clone()
        return rows, torch.zeros((enc.shape[0],), dtype=torch.float32,
                                 device=enc.device)


@dataclasses.dataclass(frozen=True)
class Bf16Codec:
    """bfloat16 rows plus an embedded float32 error bound.

    Row layout (``W = 2n + 4`` bytes, about 51% of raw for n >= 32)::

        [ 2n bytes : bfloat16 values ][ 4 bytes : float32 err bound ]

    The narrowing is round-to-nearest-even (``Tensor.to(torch.bfloat16)``
    on the CPU, the same bytes as the reference's ``ml_dtypes`` cast); the
    decode is an exact widening. The payload prefix is what the fused
    ``decode_bf16_ed_matrix`` kernel reads in place.
    """

    name: str = "bf16"
    exact: bool = False

    def row_bytes(self, series_len: int) -> int:
        return 2 * series_len + 4

    def encode(self, block: np.ndarray) -> np.ndarray:
        rows = np.ascontiguousarray(block, dtype=np.float32)
        half = torch.from_numpy(rows).to(torch.bfloat16)
        err = _err_bound(rows, half.to(torch.float32).numpy())
        out = np.empty((rows.shape[0], self.row_bytes(rows.shape[1])),
                       dtype=np.uint8)
        out[:, :-4] = half.view(torch.int16).numpy().view(np.uint8)
        out[:, -4:] = err.view(np.uint8).reshape(-1, 4)
        return out

    @staticmethod
    def split(enc: torch.Tensor):
        """``(B, W) uint8 -> ((B, 2n) payload view, (B,) err)``. The payload
        is a strided view of ``enc`` (row pitch ``W`` bytes), not a copy."""
        return enc[:, :-4], _f32_column(enc, enc.shape[1] - 4)

    def decode(self, enc: torch.Tensor, series_len: int):
        payload, err = self.split(enc)
        return decode_bf16_ref(payload), err


def sax_segments_for(series_len: int) -> int:
    """Segment count for the sax-residual codec: the default when it divides
    ``series_len``, else the largest divisor of ``series_len`` below it."""
    m = min(S.NUM_SAX_SEGMENTS, series_len)
    while series_len % m:
        m -= 1
    return m


@functools.lru_cache(maxsize=1)
def _sax_value_table() -> np.ndarray:
    """Per-code reconstruction values: midpoints of the iSAX breakpoint
    cells, the open outer cells clamped half a unit past the edge. Standard
    normal quantiles in float64, rounded once to float32."""
    qs = torch.arange(1, S.SAX_ALPHABET, dtype=torch.float64) / S.SAX_ALPHABET
    bp = torch.special.ndtri(qs).numpy()
    lo = np.concatenate(([bp[0] - 1.0], bp))
    hi = np.concatenate((bp, [bp[-1] + 1.0]))
    return ((lo + hi) / 2.0).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SaxResidualCodec:
    """iSAX reconstruction + int8 residual + embedded scale and error bound.

    Row layout (``W = m + n + 8`` bytes, about 26% of raw for n >= 32)::

        [ m bytes : uint8 iSAX codes ][ n bytes : int8 residual ]
        [ 4 bytes : float32 residual scale ][ 4 bytes : float32 err bound ]

    ``decode`` rebuilds the PAA step function from the codes through a fixed
    256-entry value table, then adds the dequantized residual.
    """

    name: str = "sax-residual"
    exact: bool = False

    def row_bytes(self, series_len: int) -> int:
        return sax_segments_for(series_len) + series_len + 8

    def encode(self, block: np.ndarray) -> np.ndarray:
        rows = np.ascontiguousarray(block, dtype=np.float32)
        num, n = rows.shape
        m = sax_segments_for(n)
        table = _sax_value_table()
        codes = S.isax(torch.from_numpy(rows), m).numpy()
        recon = np.repeat(table[codes], n // m, axis=1)
        resid = rows - recon
        scale = (np.max(np.abs(resid), axis=1) / 127.0).astype(np.float32)
        scale = np.maximum(scale, np.float32(1e-30))  # no 0-division on decode
        q = np.clip(np.rint(resid / scale[:, None]), -127, 127).astype(np.int8)
        out = np.empty((num, self.row_bytes(n)), dtype=np.uint8)
        out[:, :m] = codes
        out[:, m:m + n] = q.view(np.uint8)
        out[:, m + n:m + n + 4] = scale.view(np.uint8).reshape(-1, 4)
        out[:, m + n + 4:] = 0
        # bound the error against the actual decode output, then patch the
        # bound into the reserved tail bytes
        decoded = self.decode(torch.from_numpy(out), n)[0].numpy()
        err = _err_bound(rows, decoded)
        out[:, m + n + 4:] = err.view(np.uint8).reshape(-1, 4)
        return out

    def decode(self, enc: torch.Tensor, series_len: int):
        n = series_len
        m = sax_segments_for(n)
        codes = enc[:, :m].long()
        q = enc[:, m:m + n].view(torch.int8)
        scale = _f32_column(enc, m + n)
        err = _f32_column(enc, m + n + 4)
        table = torch.from_numpy(_sax_value_table()).to(enc.device)
        recon = torch.repeat_interleave(table[codes], n // m, dim=1)
        rows = recon + q.to(torch.float32) * scale[:, None]
        return rows, err


_REGISTRY: dict[str, Codec] = {}


def register_codec(name: str) -> Callable[[Callable[[], Codec]], Callable[[], Codec]]:
    """Class/factory decorator: ``@register_codec("name")`` registers the
    codec produced by calling the decorated object with no arguments."""

    def deco(factory):
        codec = factory()
        if codec.name != name:
            raise ValueError(
                f"codec name mismatch: registered as {name!r} but "
                f"instance reports {codec.name!r}")
        _REGISTRY[name] = codec
        return factory

    return deco


def list_codecs() -> tuple[str, ...]:
    """Registered codec names, registration order (``raw`` first)."""
    return tuple(_REGISTRY)


def get_codec(name: str) -> Codec:
    """Resolve a codec by name; raises ``ValueError`` on unknown names."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; expected one of {list_codecs()}"
        ) from None


register_codec("raw")(RawCodec)
register_codec("bf16")(Bf16Codec)
register_codec("sax-residual")(SaxResidualCodec)

#: Valid ``codec=`` values for ``SearchConfig`` ("auto" = follow whatever
#: the opened index was encoded with).
CODEC_CHOICES = ("auto",) + tuple(_REGISTRY)
