"""Port vs reference: the leaf codecs and the plain fused bf16 decode + ED.

The same seeded numpy rows go through ``repro.storage.codecs`` (JAX on the
CPU) and ``repro_torch.storage.codecs``.

What must agree, and how closely:

* encoded bytes: equal, for every codec (the bf16 narrowing is
  round-to-nearest-even in both, including ties, subnormals, signed zeros
  and values that round to infinity);
* decoded rows and embedded error bounds: equal (``sax-residual`` decodes
  in float32 multiply-then-add in both packages);
* the plain ``decode_bf16_ed_matrix``: the same squared distances within
  ``rtol=1e-6`` (the two packages sum the n terms in different orders);
  the decoded rows bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.storage import codecs as JC
from repro_torch.core.search import SearchConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.storage import codecs as TC
from _torch_threads import one_torch_thread  # noqa: F401

LEN = 64


def walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=1)
    return ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)).astype(np.float32)


def special_values() -> np.ndarray:
    """bf16 rounding edge cases: exact ties to even and odd, just-off ties,
    subnormals, signed zeros, the largest finite values and values that
    round to infinity, plus random bit patterns (finite only)."""
    one = np.float32(1.0)
    ties = [1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, 1 + 2.0 ** -8 + 2.0 ** -20,
            1 + 2.0 ** -8 - 2.0 ** -20, -(1 + 2.0 ** -8)]
    edge = [0.0, -0.0, 1e-40, -1e-40, 1e-45, 2e-39, 1.17e-38, 3.39e38, -3.39e38,
            3.4028235e38, np.finfo(np.float32).tiny, float(one)]
    bits = np.random.default_rng(3).integers(0, 2**32, 4096, dtype=np.uint64)
    rand = bits.astype(np.uint32).view(np.float32)
    vals = np.concatenate([np.asarray(ties + edge, np.float32), rand])
    vals = vals[np.isfinite(vals)]
    vals = vals[: (vals.size // LEN) * LEN]
    return vals.reshape(-1, LEN)


# the special bit patterns are for the float codecs: their huge values
# overflow the sax-residual codec's PAA (inf - inf) in both packages
@pytest.mark.parametrize("name,rows", [
    (name, rows) for name in ("raw", "bf16", "sax-residual")
    for rows in ("walks", "scaled", "special")
    if not (name == "sax-residual" and rows == "special")])
def test_encoded_bytes_match_reference(name, rows):
    if rows == "walks":
        block = walks(0, 300, LEN)
    elif rows == "scaled":
        block = walks(1, 64, LEN) * np.float32(1e4)
    else:
        block = special_values()
    want = JC.get_codec(name).encode(block)
    got = TC.get_codec(name).encode(block)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["raw", "bf16", "sax-residual"])
def test_decode_matches_reference(name):
    block = walks(2, 200, LEN)
    enc = JC.get_codec(name).encode(block)
    j_rows, j_err = JC.get_codec(name).decode(jnp.asarray(enc), LEN)
    t_rows, t_err = TC.get_codec(name).decode(torch.from_numpy(enc), LEN)
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))
    np.testing.assert_array_equal(t_err.numpy(), np.asarray(j_err))
    # the decoded rows are fresh memory, never a view of the encoded block
    assert not np.shares_memory(t_rows.numpy(), enc)
    if name == "raw":
        np.testing.assert_array_equal(t_rows.numpy(), block)
    else:
        # soundness: the embedded bound covers the reconstruction error
        true = np.linalg.norm(block.astype(np.float64) - t_rows.numpy(), axis=1)
        assert np.all(true <= t_err.numpy())


def test_bf16_split_is_a_strided_view():
    block = walks(3, 50, LEN)
    enc = torch.from_numpy(TC.get_codec("bf16").encode(block))
    payload, err = TC.Bf16Codec.split(enc)
    assert payload.shape == (50, 2 * LEN) and payload.stride() == (2 * LEN + 4, 1)
    assert payload.data_ptr() == enc.data_ptr()
    j_payload, j_err = JC.Bf16Codec.split(jnp.asarray(enc.numpy()))
    np.testing.assert_array_equal(payload.numpy(), np.asarray(j_payload))
    np.testing.assert_array_equal(err.numpy(), np.asarray(j_err))


@pytest.mark.parametrize("q,b,n", [(1, 1, 1), (5, 77, 48), (8, 300, LEN), (3, 20, 33)])
def test_plain_decode_bf16_ed_matrix_matches_reference(q, b, n):
    rng = np.random.default_rng(q * 1000 + b)
    queries = rng.standard_normal((q, n)).astype(np.float32)
    rows = rng.standard_normal((b, n)).astype(np.float32)
    enc = TC.get_codec("bf16").encode(rows)
    payload_np = np.ascontiguousarray(enc[:, :-4])
    want_rows = np.asarray(jref.decode_bf16_ref(jnp.asarray(payload_np)))
    want = np.asarray(jref.decode_bf16_ed_matrix_ref(jnp.asarray(queries),
                                                     jnp.asarray(payload_np)))
    # the port's plain version reads the strided payload inside `enc`
    payload = torch.from_numpy(enc)[:, :-4]
    np.testing.assert_array_equal(tref.decode_bf16_ref(payload).numpy(), want_rows)
    got = tref.decode_bf16_ed_matrix_ref(torch.from_numpy(queries), payload)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    d, sn = tops.decode_bf16_ed_matrix(torch.from_numpy(queries), payload)
    assert torch.equal(d, got)
    np.testing.assert_allclose(sn.numpy(), (want_rows.astype(np.float64) ** 2).sum(1),
                               rtol=1e-6)


def test_registry_matches_reference():
    assert TC.list_codecs() == JC.list_codecs()
    assert TC.CODEC_CHOICES == JC.CODEC_CHOICES
    for name in TC.list_codecs():
        codec = TC.get_codec(name)
        assert isinstance(codec, TC.Codec) and codec.name == name
        assert codec.exact == JC.get_codec(name).exact
        for n in (1, 33, 64, 256):
            assert codec.row_bytes(n) == JC.get_codec(name).row_bytes(n)
            assert TC.sax_segments_for(n) == JC.sax_segments_for(n)
    np.testing.assert_array_equal(TC._sax_value_table(), JC._sax_value_table())
    with pytest.raises(ValueError, match="unknown codec"):
        TC.get_codec("zstd")
    with pytest.raises(ValueError, match="codec"):
        SearchConfig(codec="zstd")
    with pytest.raises(ValueError, match="prefetch"):
        SearchConfig(prefetch="eager")
    assert SearchConfig(codec="bf16", prefetch="thread").codec == "bf16"
