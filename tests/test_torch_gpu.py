"""The port on a CUDA card: each hand-written kernel against its plain
version, the pinned-slot reader, and the card's build and answers
(in memory, out of core, through the wave plans, sharded four ways on one
card, and through the store: append, query with the journal merged,
compact), the banded-DTW kernel and ``dtw_knn``, the sanitized pinned
reader, RWKV-6 logits and tokens against the CPU's, the dense, vlm and MoE
transformers' logits, tokens, train step and AdamW against the CPU's, and
the RG-LRU scan kernel and recurrentgemma against the CPU, the
recurrences' gradient kernels and both recurrent families' train steps
against the CPU, whisper against the CPU, the LM loader's staging, and
GPipe stages and the int8 error-feedback mean on four entries of one card
against the CPU.

Every test here carries the ``gpu`` marker and skips without a CUDA card.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)

Tolerances: float32 ``rtol = atol = 1e-4``, bfloat16 series
``rtol = 5e-2, atol = 2.5e-1`` (``tests/test_kernel_conformance.py:15-31``)
against the direct-form plain versions; argmins exactly equal; the ED
kernels equal the exact fma references (``ed_matrix_fma_ref``,
``ed_min_fma_ref``) in every bit; ``lb_sax_matrix`` equal in every bit (it rounds and
folds as its plain version does). ``decode_bf16_ed_matrix``: distances
within ``rtol = atol = 1e-4`` of the plain version, and within
``1e-5 * (||q||^2 + ||s^||^2)`` of a float64 evaluation -- the slack the
out-of-core bounds allow for it (``core/engine.py`` ``_BOUND_REL``).
``wkv6``: ``rtol = atol = 1e-4`` in float32 (past an overflow, from the
reset on); bf16 r/k/v are widened exactly and the state holds 1e-4, while
the bf16 output, rounded from float32 sums in another order, holds the
bfloat16 tolerance; and bit for bit ``wkv6_fma_ref`` (NaNs compared as one
word: the card's fmaf and the reference's float64 give NaNs other payloads).
``rg_lru_scan``: bit for bit ``rg_lru_scan_ref`` (a rounded multiply, then
a rounded add, a step), on the card and on the CPU, through the variant
(v1, v2) that the plan picks from the case's shape and alignment, and so is
``rg_lru_scan_bwd`` to ``rg_lru_scan_bwd_ref``; ``wkv6_bwd``: float32
gradients within 1e-5 of each tensor's largest magnitude of
``wkv6_bwd_ref`` (sums in another order), bf16 ones within 8e-3 of it (a
bf16 step, 2^-8, rounding sums taken in another order), and two launches
bit-equal (no atomics). ``dtw_band``: every kernel (v1, and v2 by one thread or by lanes a pair)
bit for bit ``dtw_band_ref`` (each DP cell one rounded add of an exact minimum), so ``dtw_knn``
on the card equals the CPU's bit for bit.
Transformers, MoE and Griffin (float32 smoke configs): logits, aux and
metrics within 1e-4, each gradient within 1e-4 of its tensor's largest
magnitude, and AdamW on the same gradients within 1e-6.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import dtw as TD
from repro_torch.core import engine as E
from repro_torch.core import layout as TL
from repro_torch.core import summaries as TS
from repro_torch.core import tree as TT
from repro_torch.core.index import IndexConfig
from repro_torch.core.search import SearchConfig
from repro_torch.data import pipeline as TP
from repro_torch.distributed import pipeline as TPIPE
from repro_torch.configs import get_smoke
from repro_torch.kernels import _build
from repro_torch.kernels import dtw as kdtw
from repro_torch.kernels import ed as ked
from repro_torch.kernels import lb_sax as klb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rg_lru as krg
from repro_torch.kernels import wkv6 as kwkv
from repro_torch.device import resolve_device
from repro_torch.models import common as TMC
from repro_torch.models import get_model
from repro_torch.models import rwkv6 as TR
from repro_torch.train import compression as TCOMP
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.storage import Hercules, build_index_to_disk
from repro_torch.storage import codecs as TC

pytestmark = pytest.mark.gpu

_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=5e-2, atol=2.5e-1)}


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    return torch.device("cuda")


def assert_close(got, want, dtype="float32"):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **_TOL[dtype])


def walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=1)
    return ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)).astype(np.float32)


def randn(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


@pytest.mark.parametrize("q,n,length", [(1, 1, 1), (5, 77, 48), (8, 129, 33),
                                        (130, 4097, 256)])
def test_ed_kernels_match_plain(cuda, q, n, length):
    qa, sa = randn(1, q, length).to(cuda), randn(2, n, length).to(cuda)
    before = ked.ed_matrix.launches
    assert_close(ked.ed_matrix(qa, sa), tref.ed_matrix_ref(qa, sa))
    assert ked.ed_matrix.launches == before + 1
    sb = sa.to(torch.bfloat16)
    assert_close(ked.ed_matrix(qa, sb), tref.ed_matrix_ref(qa, sb), "bfloat16")
    for valid in (n, max(1, n // 2)):
        dmin, amin = ked.ed_min(qa, sa, valid_n=valid)
        want_d, want_a = tref.ed_min_ref(qa, sa, valid_n=valid)
        assert_close(dmin, want_d)
        assert torch.equal(amin.cpu(), want_a.cpu())


# Every edge of ed_matrix v2's tiling: Q around its 128-row query tiles, N
# around its 32- and 128-row series tiles and the grid size that switches
# between them, n around its 32-wide k-step (odd n takes the 4-byte copy
# path for float32 and the 2-byte one for bf16).
_TILE_EDGES = list(itertools.product((1, 127, 129), (1, 31, 4096, 4097, 131073),
                                     (1, 7, 255, 256)))


@pytest.mark.parametrize("q,n,length", _TILE_EDGES)
def test_ed_matrix_tile_edges(cuda, q, n, length):
    """``ed_matrix`` over float32 and bf16 series against the plain version,
    on contiguous tensors and on views whose base is one row in (so only
    4-byte aligned where 4 * length is not a multiple of 16)."""
    qa = randn(q * 7 + n, q + 1, length).to(cuda)
    sa = randn(q + n * 3, n + 1, length).to(cuda)
    sb = sa.to(torch.bfloat16)
    for qv, sv, bv in ((qa[:q], sa[:n], sb[:n]), (qa[1:], sa[1:], sb[1:])):
        before = ked.ed_matrix.launches
        assert_close(ked.ed_matrix(qv, sv), tref.ed_matrix_ref(qv, sv))
        assert ked.ed_matrix.launches == before + 1
        assert_close(ked.ed_matrix(qv, bv), tref.ed_matrix_ref(qv, bv), "bfloat16")


# The shapes chip_smoke.py holds to the witness (its phases 3 and 6).
_WITNESS_SHAPES = [(128, 4096, 256), (128, 131072, 256), (1, 1, 1), (1, 100, 128),
                   (5, 77, 48), (8, 129, 33), (130, 4097, 256), (127, 31, 7),
                   (1, 4097, 256), (129, 131073, 255)]


@pytest.mark.parametrize("kind", ["f32", "bf16", "decode"])
@pytest.mark.parametrize("q,n,length", _WITNESS_SHAPES)
def test_ed_matrix_witness_is_ed_min(cuda, q, n, length, kind):
    """The witness, now a check of ``ed_min``'s fold: ``ed_min`` runs the
    tile core of ``ed_matrix`` with a reduction as its epilogue, so each
    row's minimum of ``ed_matrix`` (float32 or bf16 series) or
    ``decode_bf16_ed_matrix`` equals ``ed_min``'s distance as a value, and
    the lowest index attaining it equals ``ed_min``'s index (the decode
    against ``ed_min`` over the payload's bf16 rows). The core's arithmetic
    is held by ``test_ed_kernels_equal_the_fma_references``."""
    queries, enc = bf16_block(q * 11 + n + length, q, n, length, cuda)
    rows = tref.decode_bf16_ref(enc[:, :-4]) if kind == "bf16" else None
    if kind == "f32":
        series = randn(n * 5 + length, n, length).to(cuda)
        mat = ked.ed_matrix(queries, series)
    elif kind == "bf16":
        series = rows.to(torch.bfloat16)
        mat = ked.ed_matrix(queries, series)
    else:
        payload = enc[:, :-4]
        mat = ked.decode_bf16_ed_matrix(queries, payload)[0]
        series = payload.contiguous().view(torch.bfloat16)
    dmin, amin = ked.ed_min(queries, series)
    low = mat.min(dim=1).values
    first = (mat == low[:, None]).int().argmax(dim=1)
    assert torch.equal(low, dmin)
    assert torch.equal(first, amin.long())


def _words(x):
    return x.contiguous().view(torch.int32)


def _hold_fma(queries, series, payload=None, valid_ns=None):
    """``ed_min`` at each ``valid_n`` and ``ed_matrix`` over ``series`` (and
    ``decode_bf16_ed_matrix`` over ``payload``, the bf16 bits of
    ``series``) equal the fma references in every bit."""
    num = series.shape[0]
    for valid in valid_ns or (num, num // 2):
        before = ked.ed_min.launches
        dmin, amin = ked.ed_min(queries, series, valid_n=valid)
        assert ked.ed_min.launches == before + 1
        want_d, want_a = tref.ed_min_fma_ref(queries, series, valid_n=valid)
        assert torch.equal(_words(dmin), _words(want_d)), valid
        assert torch.equal(amin, want_a), valid
    want = _words(tref.ed_matrix_fma_ref(queries, series))
    assert torch.equal(_words(ked.ed_matrix(queries, series)), want)
    if payload is not None:
        assert torch.equal(_words(ked.decode_bf16_ed_matrix(queries, payload)[0]), want)


@pytest.mark.parametrize("q,n,length", sorted(set(_TILE_EDGES) | set(_WITNESS_SHAPES)))
def test_ed_kernels_equal_the_fma_references(cuda, q, n, length):
    """``ed_min`` (distances as int32 words, and indices; ``valid_n`` N and
    N // 2), ``ed_matrix`` (float32 and bf16 series) and
    ``decode_bf16_ed_matrix`` equal ``ed_min_fma_ref`` and
    ``ed_matrix_fma_ref`` bit for bit, on contiguous tensors and on views
    whose base is one row in."""
    qa = randn(q * 13 + n, q + 1, length).to(cuda)
    sa = randn(q + n * 7 + length, n + 1, length).to(cuda)
    sb = sa.to(torch.bfloat16)
    enc = torch.zeros((n + 1, 2 * length + 4), dtype=torch.uint8, device=cuda)
    enc[:, :2 * length] = sb.view(torch.uint8)
    payload = enc[:, :-4]
    for qv, sv, bv, pv in ((qa[:q], sa[:n], sb[:n], payload[:n]),
                           (qa[1:], sa[1:], sb[1:], payload[1:])):
        _hold_fma(qv, sv)
        _hold_fma(qv, bv, pv)


# ed_min's resident-query state (Q <= 128 on a grid of Big tiles) at the
# edges of its fit: Q = 128 and one past it, n = 320 (float32 series) and
# 384 (bf16), the largest that fit beside the series ring, and one past.
@pytest.mark.parametrize("q", [128, 129])
@pytest.mark.parametrize("length", [320, 321, 384, 385])
def test_ed_min_resident_limits_equal_the_fma_reference(cuda, q, length):
    n = 40000                     # 313 tiles of 128 rows: two waves and more
    qa = randn(q + length, q, length).to(cuda)
    sa = randn(length, n, length).to(cuda)
    for series in (sa, sa.to(torch.bfloat16)):
        for valid in (n, n // 2, 5):
            dmin, amin = ked.ed_min(qa, series, valid_n=valid)
            want_d, want_a = tref.ed_min_fma_ref(qa, series, valid_n=valid)
            assert torch.equal(_words(dmin), _words(want_d)), valid
            assert torch.equal(amin, want_a), valid


def test_random_walks_are_the_same_on_the_card(cuda):
    """One seed draws the same walks and queries on the card as on the CPU,
    bit for bit, across several chunks and a ragged tail."""
    from repro_torch.data import synthetic
    num = 2 * synthetic.CHUNK_ROWS + 77
    card = synthetic.random_walks(num, 64, seed=9, device=cuda)
    host = synthetic.random_walks(num, 64, seed=9, device="cpu")
    assert card.device.type == "cuda" and torch.equal(card.cpu(), host)
    assert torch.equal(synthetic.make_query_workload(card, 20, "5%", seed=3).cpu(),
                       synthetic.make_query_workload(host, 20, "5%", seed=3))


def test_ed_min_ties_and_all_inf_rows(cuda):
    dmin, amin = ked.ed_min(torch.zeros(4, 16, device=cuda), torch.ones(300, 16, device=cuda))
    assert bool((amin == 0).all()) and bool((dmin == 16).all())
    dmin, amin = ked.ed_min(torch.full((2, 16), 2e19, device=cuda),
                            torch.full((300, 16), -2e19, device=cuda))
    assert bool(torch.isinf(dmin).all()) and bool((amin == 0).all())


# Every edge of lb_sax_matrix v2's tiling: Q around its unrolled query
# loop and its 128-query passes, N around its 256-thread blocks of 2 series
# a thread, both segment counts and several alphabets.
_LB_EDGES = list(itertools.product((1, 7, 8, 9, 127, 128, 129), (1, 255, 256, 257, 131073),
                                   (8, 16), (2, 4, 16, 256)))


@pytest.mark.parametrize("q,n,m,alphabet", [(1, 1, 16, 256), (5, 77, 16, 256),
                                            (3, 130, 8, 64), (1, 70001, 16, 256)]
                         + _LB_EDGES)
def test_lb_sax_kernel_matches_plain_bitwise(cuda, q, n, m, alphabet):
    """Equal to the plain version in every bit (int32 words, so -0.0 and
    +0.0 differ), on contiguous inputs, on views one row in and with PAA
    rows at +-1e15; one launch per call. Series scaled by 3 so the codes
    reach the alphabet's outer cells."""
    q_paa = TS.paa(randn(3, q + 1, 4 * m).to(cuda) * 3, m)
    codes = TS.isax(randn(4, n + 1, 4 * m).to(cuda) * 3, m, alphabet)
    big = q_paa[1:].clone()
    big[::2], big[1::2] = 1e15, -1e15
    for qv, cv in ((q_paa[:q], codes[:n]), (q_paa[1:], codes[1:]), (big, codes[:n])):
        before = klb.lb_sax_matrix.launches
        got = klb.lb_sax_matrix(qv, cv, 4 * m, alphabet)
        assert klb.lb_sax_matrix.launches == before + 1
        want = tref.lb_sax_matrix_ref(qv, cv, 4 * m, alphabet)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_build_equals_cpu_build(cuda):
    """Fixed-order arithmetic: the card builds the CPU's tree bit for bit."""
    x = torch.from_numpy(walks(8, 20000, 256))
    cfg = TT.BuildConfig(leaf_capacity=500)
    ct, cn = TT.build_tree(x, cfg)
    gt, gn = TT.build_tree(x.to(cuda), cfg)
    for f in TT.HerculesTree._fields:
        assert torch.equal(getattr(gt, f).cpu(), getattr(ct, f)), f
    assert torch.equal(gn.cpu(), cn)
    cl = TL.build_layout(ct, cn, x)
    gl = TL.build_layout(gt, gn, x.to(cuda))
    assert torch.equal(gl.lsd.cpu(), cl.lsd) and torch.equal(gl.lrd.cpu(), cl.lrd)


def test_engine_equals_cpu_engine(cuda):
    """The card's answers equal the CPU's: bit for bit for ``local`` (same
    fixed-order arithmetic, LB_SAX kernel bit-equal to its plain version),
    by ids and difference-form distances for the kernel-selected scan."""
    data = walks(0, 4096, 64)
    rng = np.random.default_rng(5)
    q = (data[rng.integers(0, 4096, 10)]
         + rng.standard_normal((10, 64)) * np.sqrt(0.05)).astype(np.float32)
    icfg = IndexConfig(build=TT.BuildConfig(leaf_capacity=64),
                       search=SearchConfig(chunk=128, scan_block=256))
    for name in ("local", "scan"):
        gpu = E.QueryEngine(E.make_backend(name, data, index_config=icfg))
        cpu = E.QueryEngine(E.make_backend(name, data, index_config=icfg, device="cpu"))
        for k in (1, 5):
            g, c = gpu.knn(q, k=k), cpu.knn(q, k=k)
            fields = g._fields if name == "local" else ("ids", "dists")
            for f in fields:
                assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), (name, k, f)


def bf16_block(seed, q, b, n, cuda):
    """(queries, enc): float32 queries and a bf16-encoded block on the card,
    whose payload ``enc[:, :-4]`` has a row pitch of 2n + 4 bytes."""
    rng = np.random.default_rng(seed)
    queries = torch.from_numpy(rng.standard_normal((q, n)).astype(np.float32))
    rows = rng.standard_normal((b, n)).astype(np.float32)
    enc = torch.from_numpy(TC.get_codec("bf16").encode(rows))
    return queries.to(cuda), enc.to(cuda)


@pytest.mark.parametrize("q,b,n", [(1, 1, 1), (1, 77, 33), (128, 1000, 256),
                                   (128, 131, 255), (5, 4097, 64), (128, 64, 7)]
                         + _TILE_EDGES)
def test_decode_bf16_ed_matrix_matches_plain(cuda, q, b, n):
    queries, enc = bf16_block(q * 7 + b, q, b, n, cuda)
    payload = enc[:, :-4]
    assert payload.stride() == (2 * n + 4, 1)
    # the plain decode is the exact widening (bits << 16)
    bits = payload.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    assert torch.equal(tref.decode_bf16_ref(payload), (bits << 16).view(torch.float32))
    before = ked.decode_bf16_ed_matrix.launches
    got, sn = ked.decode_bf16_ed_matrix(queries, payload)
    assert ked.decode_bf16_ed_matrix.launches == before + 1
    assert_close(got, tref.decode_bf16_ed_matrix_ref(queries, payload))
    rows = tref.decode_bf16_ref(payload)
    assert_close(sn, TS.fixed_order_sum(rows * rows))
    again, sn_again = ked.decode_bf16_ed_matrix(queries, payload)
    assert torch.equal(again, got) and torch.equal(sn_again, sn)


@pytest.mark.parametrize("n", [1, 7, 255, 256])
def test_decode_bf16_ed_matrix_view_one_row_in(cuda, n):
    """A payload view whose base is one encoded row in (2n + 4 bytes: only
    2-byte aligned for odd n, 4-byte for even n) and a query view one row
    in, at both tile shapes."""
    for b in (4097, 131073):
        queries, enc = bf16_block(n + b, 130, b + 1, n, cuda)
        payload = enc[1:, :-4]
        got, sn = ked.decode_bf16_ed_matrix(queries[1:], payload)
        assert_close(got, tref.decode_bf16_ed_matrix_ref(queries[1:], payload))
        rows = tref.decode_bf16_ref(payload)
        assert_close(sn, TS.fixed_order_sum(rows * rows))


def test_decode_bf16_ed_matrix_allocates_only_its_output(cuda):
    """Nothing beyond the (Q, B) distances and the (B,) row norms: no
    decoded copy of the payload."""
    queries, enc = bf16_block(3, 128, 8192, 256, cuda)
    payload = enc[:, :-4]
    ked.decode_bf16_ed_matrix(queries, payload)           # build and load first
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, sn = ked.decode_bf16_ed_matrix(queries, payload)
    torch.cuda.synchronize()
    out_bytes = sum(-(-t.numel() * 4 // 512) * 512 for t in (out, sn))
    assert torch.cuda.memory_allocated() - base == out_bytes
    assert torch.cuda.max_memory_allocated() - base == out_bytes


def test_decode_bf16_ed_matrix_soundness(cuda):
    """The kernel's error stays inside the slack the codec bounds give it."""
    queries, enc = bf16_block(4, 128, 4096, 256, cuda)
    payload = enc[:, :-4]
    got = ked.decode_bf16_ed_matrix(queries, payload)[0].double()
    q64 = queries.double()
    rows = tref.decode_bf16_ref(payload).double()
    exact = ((q64[:, None, :] - rows[None, :, :]) ** 2).sum(-1)
    scale = (q64 * q64).sum(1)[:, None] + (rows * rows).sum(1)[None, :]
    assert float(((got - exact).abs() / scale).max()) <= 1e-5


def test_decode_bf16_ed_matrix_rejects_bad_views(cuda):
    queries, enc = bf16_block(5, 4, 10, 16, cuda)
    with pytest.raises(ValueError, match="pitch"):
        ked.decode_bf16_ed_matrix(queries, enc[:, :-4].t().contiguous().t())
    with pytest.raises(ValueError, match="aligned"):
        ked.decode_bf16_ed_matrix(queries, enc.view(-1)[1:1 + 10 * 32].view(10, 32))
    with pytest.raises(ValueError, match="expected"):
        ked.decode_bf16_ed_matrix(queries, enc[:, :-6])


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_pinned_thread_reader_equals_sync(cuda, dtype):
    """Reader thread + pinned slots + side-stream copies give the sync
    reader's bytes; mutating a slot after a blocking stage() cannot reach
    the staged tensor."""
    data = (np.random.default_rng(6).standard_normal((5000, 72)) * 50).astype(dtype)
    src = TP.ArrayChunkSource(data, 700, dtype=dtype)
    sync = torch.cat([c for _, c in TP.iter_device_chunks(src, cuda, prefetch="sync")])
    thread = torch.cat([c for _, c in TP.iter_device_chunks(src, cuda,
                                                            prefetch="thread")])
    assert torch.equal(sync, thread) and sync.device.type == "cuda"
    np.testing.assert_array_equal(thread.cpu().numpy(), data)
    reader = TP.make_chunk_reader(data, 256, 72, dtype, prefetch="thread", device=cuda)
    try:
        for i in range(8):
            reader.submit(i * 256, 256)
        staged = []
        for i in range(8):
            view = reader.get()
            staged.append(reader.stage(view))
            view[:] = 0                          # what a refill would do
        for i, t in enumerate(staged):
            np.testing.assert_array_equal(t.cpu().numpy(), data[i * 256:(i + 1) * 256])
    finally:
        reader.close()


@pytest.mark.parametrize("codec", ["raw", "bf16"])
def test_ooc_local_equals_cpu(cuda, tmp_path, codec):
    """``ooc-local`` on the card answers as on the CPU. Under the raw stream
    every arithmetic step is device-independent, so every KnnResult field is
    equal; under bf16 the card's bounds come from the fused kernel, which can
    move pruning counts, so the answer (dists, positions, ids) is held."""
    data = walks(9, 4096, 64)
    rng = np.random.default_rng(10)
    q = (data[rng.integers(0, 4096, 12)]
         + rng.standard_normal((12, 64)) * np.sqrt(0.05)).astype(np.float32)
    icfg = IndexConfig(build=TT.BuildConfig(leaf_capacity=64),
                       search=SearchConfig(chunk=128, scan_block=256))
    path = str(tmp_path / "idx")
    build_index_to_disk(TP.ArrayChunkSource(data, 1000), path, icfg, codec=codec,
                        device=cuda)
    local = E.make_backend("local", data, index_config=icfg, device="cpu")
    for prefetch in ("sync", "thread"):
        gpu = E.QueryEngine(E.make_disk_backend("ooc-local", path, memory_budget_mb=0.25,
                                                prefetch=prefetch))
        cpu = E.QueryEngine(E.make_disk_backend("ooc-local", path, memory_budget_mb=0.25,
                                                prefetch=prefetch, device="cpu"))
        for k in (1, 5):
            g, c = gpu.knn(q, k=k), cpu.knn(q, k=k)
            fields = g._fields if codec == "raw" else ("dists", "positions", "ids")
            for f in fields:
                assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), (prefetch, k, f)
            want = local.knn(q, k=k)
            assert torch.equal(g.dists.cpu(), want.dists)
            assert torch.equal(g.ids.cpu().long(), want.ids.long())


@pytest.mark.parametrize("codec", ["raw", "bf16"])
def test_wave_on_the_card_equals_cpu(cuda, tmp_path, codec):
    """The wave plans on the card answer as on the CPU and as the card's
    per-query path. ``local`` (``wave_knn``): every KnnResult field equal to
    the CPU's, one ``lb_sax_matrix`` launch a call, distances bit for bit
    the per-query path's. ``ooc-local``: under the raw stream every field
    equal to the CPU's (the bf16 bounds come from the fused kernel, so the
    answer is held there, and the sharing counters with it), distances bit
    for bit the card's per-query answers, ids equal as sets per row."""
    data = walks(11, 4096, 64)
    rng = np.random.default_rng(12)
    q = (data[rng.integers(0, 4096, 12)]
         + rng.standard_normal((12, 64)) * np.sqrt(0.05)).astype(np.float32)
    icfg = IndexConfig(build=TT.BuildConfig(leaf_capacity=64),
                       search=SearchConfig(chunk=128, scan_block=256))
    gpu = E.QueryEngine(E.make_backend("local", data, index_config=icfg))
    cpu = E.QueryEngine(E.make_backend("local", data, index_config=icfg, device="cpu"))
    path = str(tmp_path / "idx")
    build_index_to_disk(TP.ArrayChunkSource(data, 1000), path, icfg, codec=codec,
                        device=cuda)
    for k in (1, 5):
        before = klb.lb_sax_matrix.launches
        g = gpu.knn(q, k=k, wave=True)
        assert klb.lb_sax_matrix.launches - before == 1
        c = cpu.knn(q, k=k, wave=True)
        for f in g._fields:
            assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), (k, f)
        assert torch.equal(g.dists, gpu.knn(q, k=k).dists)
        for prefetch in ("sync", "thread"):
            og, oc = (E.QueryEngine(E.make_disk_backend(
                "ooc-local", path, memory_budget_mb=0.25, prefetch=prefetch, device=d))
                for d in (None, "cpu"))
            wg, wc = og.knn(q, k=k, wave=True), oc.knn(q, k=k, wave=True)
            fields = wg._fields if codec == "raw" else ("dists", "positions", "ids")
            for f in fields:
                assert torch.equal(getattr(wg, f).cpu(), getattr(wc, f)), (prefetch, k, f)
            keys = ("rows_streamed", "runs_deduped", "runs_skipped_bsf",
                    "wave_rows_shared") if codec == "raw" else ()
            for key in ("wave_calls",) + keys:
                assert og.stats()[key] == oc.stats()[key], (prefetch, k, key)
            solo = og.knn(q, k=k)
            assert torch.equal(wg.dists, solo.dists)
            assert torch.equal(torch.sort(wg.ids.long(), 1).values,
                               torch.sort(solo.ids.long(), 1).values)


def test_sharded_four_shards_on_one_card(cuda):
    """``sharded`` with 4 shards on one card answers as the card's ``local``
    and as the CPU's 4 shards, bit for bit."""
    data = walks(14, 4096, 64)
    rng = np.random.default_rng(15)
    q = (data[rng.integers(0, 4096, 12)]
         + rng.standard_normal((12, 64)) * np.sqrt(0.05)).astype(np.float32)
    icfg = IndexConfig(build=TT.BuildConfig(leaf_capacity=64),
                       search=SearchConfig(chunk=128, scan_block=256))
    local = E.make_backend("local", data, index_config=icfg)
    sharded = E.make_backend("sharded", data, index_config=icfg, devices=[cuda] * 4)
    on_cpu = E.make_backend("sharded", data, index_config=icfg, num_shards=4,
                            device="cpu")
    assert sharded.plan_signature[2] == (str(cuda),) * 4
    for k in (1, 5):
        before = klb.lb_sax_matrix.launches
        g = E.QueryEngine(sharded).knn(q, k=k)
        assert klb.lb_sax_matrix.launches - before == 4 * 16    # 4 shards x bucket
        want = local.knn(q, k=k)
        assert torch.equal(g.dists, want.dists) and torch.equal(g.ids, want.ids)
        c = on_cpu.knn(q, k=k)
        assert torch.equal(g.dists.cpu(), c.dists) and torch.equal(g.ids.cpu(), c.ids)


@pytest.mark.parametrize("codec", ["raw", "bf16"])
def test_dist_ooc_four_shards_on_one_card(cuda, tmp_path, codec):
    """``dist-ooc`` with 4 shards on one card (a thread and a CUDA stream a
    shard) answers as the card's ``ooc-local`` bit for bit, with either
    reader and wave flag, its readers stay in their row ranges, and every
    launch from the shard threads is counted: under bf16 one
    ``decode_bf16_ed_matrix`` launch a streamed block."""
    data = walks(16, 4096, 64)
    rng = np.random.default_rng(17)
    q = (data[rng.integers(0, 4096, 12)]
         + rng.standard_normal((12, 64)) * np.sqrt(0.05)).astype(np.float32)
    icfg = IndexConfig(build=TT.BuildConfig(leaf_capacity=64),
                       search=SearchConfig(l_max=2, chunk=128, scan_block=256))
    path = str(tmp_path / "idx")
    build_index_to_disk(TP.ArrayChunkSource(data, 1000), path, icfg, codec=codec,
                        device=cuda)
    ooc = E.make_disk_backend("ooc-local", path, memory_budget_mb=0.25)
    for prefetch in ("sync", "thread"):
        dist = E.make_disk_backend("dist-ooc", path, memory_budget_mb=0.25,
                                   prefetch=prefetch, devices=[cuda] * 4)
        eng = E.QueryEngine(dist)
        for k in (1, 5):
            want = ooc.knn(q, k=k)
            for wave in (False, True):
                blocks = dist.stats()["blocks"]
                before = ked.decode_bf16_ed_matrix.launches
                got = eng.knn(q, k=k, wave=wave)
                for f in ("dists", "positions", "ids"):
                    assert torch.equal(getattr(got, f), getattr(want, f)), (prefetch, k, f)
                if codec == "bf16" and dist.stats()["codec_fallbacks"] == 0:
                    assert (ked.decode_bf16_ed_matrix.launches - before
                            == dist.stats()["blocks"] - blocks)
        d = eng.telemetry().dist
        assert d.shards == 4 and min(d.rows_streamed) > 0
        for (lo, hi), (tlo, thi) in zip(d.row_range, d.rows_touched):
            assert lo <= tlo and thi <= hi


@pytest.mark.parametrize("codec", ["raw", "bf16"])
def test_store_on_the_card_equals_cpu(cuda, tmp_path, codec):
    """A store appended to, queried and compacted on the card: with rows
    pending, every backend's merged answer equals the CPU store's bit for
    bit (positions -1 on journal rows), and every array of the compacted
    generation equals the one the CPU writes from the same rows; after
    compaction the answers are unchanged but for the journal rows'
    positions."""
    data_a, data_b = walks(11, 3000, 64), walks(12, 900, 64)
    rng = np.random.default_rng(13)
    src = np.concatenate([data_a, data_b])[rng.integers(0, 3900, 12)]
    q = (src + rng.standard_normal((12, 64)) * np.sqrt(0.05)).astype(np.float32)
    icfg = IndexConfig(build=TT.BuildConfig(leaf_capacity=64),
                       search=SearchConfig(chunk=128, scan_block=256))
    stores = {}
    for dev in ("cuda", "cpu"):
        hx = Hercules.create(str(tmp_path / dev), icfg, data=data_a, chunk_size=700,
                             codec=codec, device=dev)
        hx.append(data_b[:500], chunk_size=128)
        hx.append(torch.from_numpy(data_b[500:]).to(dev))    # a tensor on the device
        stores[dev] = hx
    try:
        pending = {}
        for name in ("local", "scan", "ooc-scan", "ooc-local"):
            for k in (1, 5):
                g, c = (stores[d].query(q, k, backend=name, memory_budget_mb=0.25)
                        for d in ("cuda", "cpu"))
                for f in ("dists", "positions", "ids"):
                    assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), (name, k, f)
                assert (g.ids >= 3000).any() and (g.positions[g.ids >= 3000] == -1).all()
                pending[(name, k)] = g
        for hx in stores.values():
            hx.compact(chunk_size=1000)
        g_saved, c_saved = stores["cuda"].saved, stores["cpu"].saved
        for f in g_saved.tree._fields:
            assert torch.equal(getattr(g_saved.tree, f), getattr(c_saved.tree, f)), f
        for name in ("lrd", "lsd") + (("enc",) if codec != "raw" else ()):
            np.testing.assert_array_equal(g_saved._mapped(name), c_saved._mapped(name))
        for f, arr in g_saved.small.items():
            np.testing.assert_array_equal(arr, c_saved.small[f], err_msg=f)
        for (name, k), before in pending.items():
            after = stores["cuda"].query(q, k, backend=name, memory_budget_mb=0.25)
            assert torch.equal(after.dists, before.dists), (name, k)
            assert torch.equal(after.ids, before.ids), (name, k)
            assert (after.positions >= 0).all()
    finally:
        for hx in stores.values():
            hx.close()


def wkv_inputs(seed, b, t, h, dk, dv, cuda, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)

    r, k, v = n(b, t, h, dk).to(dtype), n(b, t, h, dk).to(dtype), n(b, t, h, dv).to(dtype)
    w = torch.sigmoid(n(b, t, h, dk))
    return r, k, v, w, n(h, dk), n(b, h, dk, dv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,dk,dv", [(1, 1, 1, 1, 1), (2, 37, 2, 4, 4), (1, 64, 2, 8, 8),
                                         (2, 16, 1, 4, 8), (2, 40, 3, 64, 64),
                                         (4, 1, 64, 64, 64), (1, 5, 2, 33, 17), (2, 0, 2, 4, 4)])
def test_wkv6_kernel_matches_plain(cuda, b, t, h, dk, dv, dtype):
    r, k, v, w, u, s0 = wkv_inputs(b * 100 + t, b, t, h, dk, dv, cuda, dtype)
    before = kwkv.wkv6.launches
    out, sf = kwkv.wkv6(r, k, v, w, u, s0)
    assert kwkv.wkv6.launches == before + 1
    want_o, want_s = tref.wkv6_ref(r, k, v, w, u, s0)
    assert out.dtype == dtype and sf.dtype == torch.float32
    assert_close(out, want_o, "float32" if dtype == torch.float32 else "bfloat16")
    assert_close(sf, want_s)
    got = tops.wkv6(r, k, v, w, u, s0)
    assert torch.equal(got[0], out) and torch.equal(got[1], sf)


_WKV_CHUNK = 32            # csrc/wkv6.cu's default chunk of steps
_WKV_DIMS = (1, 4, 17, 33, 64)


def _wkv_words(x):
    """int32 words (bf16 zero-extended), every NaN as one word."""
    x = x.contiguous()
    words = x.view(torch.int32) if x.dtype == torch.float32 else \
        x.view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(torch.isnan(x.float()), torch.full_like(words, -1), words)


def _hold_wkv_fma(args):
    """The kernel's out and final state equal ``wkv6_fma_ref``'s in every
    bit (NaNs as one word)."""
    before = kwkv.wkv6.launches
    got = kwkv.wkv6(*args)
    assert kwkv.wkv6.launches == before + 1
    for a, b in zip(got, tref.wkv6_fma_ref(*args)):
        assert torch.equal(_wkv_words(a), _wkv_words(b))


def _placed(x, dtype, offset):
    """``x`` in ``dtype``, ``offset`` elements into a new flat buffer."""
    buf = torch.empty(x.numel() + offset, dtype=dtype, device=x.device)
    buf[offset:] = x.reshape(-1).to(dtype)
    return buf[offset:].view(x.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,dv", list(itertools.product(_WKV_DIMS, _WKV_DIMS)))
def test_wkv6_kernel_equals_the_fma_reference(cuda, dk, dv, dtype):
    """Bit for bit ``wkv6_fma_ref`` at T in {0, 1, C - 1, C, C + 1, 2C + 3,
    512} (C the kernel's chunk), on contiguous tensors and on views whose
    base is one row in; at K = V = 64 also one element in. K = 64 float32
    contiguous takes the aligned (cp.async) path, K = 33 and views one
    element in the element path."""
    c = _WKV_CHUNK
    layouts = [0, None] + ([1] if dk == dv == 64 else [])
    for t in (0, 1, c - 1, c, c + 1, 2 * c + 3, 512):
        r, k, v, w, u, s0 = wkv_inputs(dk * 100 + dv + t, 2, t, 2, dk, dv, cuda)
        for off in layouts:
            placed = [_placed(x, dt, x.shape[-1] if off is None else off)
                      for x, dt in ((r, dtype), (k, dtype), (v, dtype), (w, torch.float32))]
            _hold_wkv_fma((*placed, u, s0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,dv", [(64, 64), (33, 17)])
def test_wkv6_kernel_resets_in_one_chunk(cuda, dk, dv, dtype):
    """w == 0 at some rows of the second chunk only: that chunk runs the
    kernel's select, the others the reset-free loop; bit for bit
    ``wkv6_fma_ref``."""
    c = _WKV_CHUNK
    r, k, v, w, u, s0 = wkv_inputs(77 + dk, 2, 2 * c + 3, 2, dk, dv, cuda, dtype)
    zero = np.random.default_rng(5).random(tuple(w[:, c:c + 3].shape)) < 0.3
    w[:, c:c + 3] = torch.where(torch.from_numpy(zero).to(cuda), 0.0, w[:, c:c + 3])
    _hold_wkv_fma((r, k, v, w, u, s0))


def test_wkv6_kernel_extreme_decay(cuda):
    """w at the exact boundaries (0 resets, 1 keeps), subnormal, 1 - 1e-6,
    and one extreme per channel, with a nonzero initial state."""
    b, t, h, dk, dv = 1, 64, 1, 4, 4
    r, k, v, _, u, s0 = wkv_inputs(10, b, t, h, dk, dv, cuda)
    mixed = torch.stack([torch.zeros(b, t, h), torch.ones(b, t, h),
                         torch.full((b, t, h), 1e-38), torch.full((b, t, h), 1.0 - 1e-6)],
                        dim=-1).to(cuda)
    sweeps = [torch.full((b, t, h, dk), wv, device=cuda)
              for wv in (0.0, 1e-38, 1e-6, 1.0 - 1e-6, 1.0)] + [mixed]
    for w in sweeps:
        out, sf = kwkv.wkv6(r, k, v, w, u, s0)
        want_o, want_s = tref.wkv6_ref(r, k, v, w, u, s0)
        assert bool(torch.isfinite(out).all())
        assert_close(out, want_o)
        assert_close(sf, want_s)
        _hold_wkv_fma((r, k, v, w, u, s0))


def test_wkv6_kernel_resets_an_overflowed_state(cuda):
    b, t, h, dk, dv = 1, 24, 1, 4, 4
    r, k, v, _, u, _ = wkv_inputs(11, b, t, h, dk, dv, cuda)
    k[:, :8] = 2e19
    v[:, :8] = 2e19
    w = torch.ones(b, t, h, dk, device=cuda)
    w[:, 8] = 0.0
    s0 = torch.zeros(b, h, dk, dv, device=cuda)
    out, sf = kwkv.wkv6(r, k, v, w, u, s0)
    want_o, want_s = tref.wkv6_ref(r, k, v, w, u, s0)
    assert bool(torch.isfinite(out[:, 9:]).all()) and bool(torch.isfinite(sf).all())
    assert_close(out[:, 9:], want_o[:, 9:])
    assert_close(sf, want_s)
    _hold_wkv_fma((r, k, v, w, u, s0))


def test_wkv6_kernel_refuses_what_it_cannot_take(cuda):
    r, k, v, w, u, s0 = wkv_inputs(12, 1, 3, 1, 65, 4, cuda)
    with pytest.raises(ValueError, match="K, V <= 64"):
        kwkv.wkv6(r, k, v, w, u, s0)
    r, k, v, w, u, s0 = wkv_inputs(12, 1, 3, 1, 4, 4, cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        kwkv.wkv6(r, k, v, w, u, s0.cpu())
    with pytest.raises(TypeError):
        kwkv.wkv6(r, k, v, w, u.double(), s0)
    with pytest.raises(TypeError, match="one dtype"):
        kwkv.wkv6(r.bfloat16(), k, v, w, u, s0)
    with pytest.raises(TypeError, match="float32 w"):
        kwkv.wkv6(r, k, v, w.bfloat16(), u, s0)


def test_wkv6_build_error_raises(cuda, tmp_path, monkeypatch):
    """A source that does not compile raises at the first launch: nothing
    falls back to the plain version."""
    src = tmp_path / "csrc"
    src.mkdir()
    for name in _build.SOURCES:
        (src / f"{name}.cu").write_bytes((_build.CSRC / f"{name}.cu").read_bytes())
    (src / "wkv6.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    r, k, v, w, u, s0 = wkv_inputs(13, 1, 3, 1, 4, 4, cuda)
    before = kwkv.wkv6.launches
    with pytest.raises(RuntimeError, match="nvcc failed for wkv6.cu"):
        tops.wkv6(r, k, v, w, u, s0)
    assert kwkv.wkv6.launches == before


def test_rwkv6_smoke_on_the_card_equals_cpu(cuda):
    """The smoke model (float32) with the same weights: the card (wkv6
    kernel) and the CPU (plain version) give logits within 1e-4 and the same
    greedy tokens, and the card keeps TF32 off."""
    cfg = get_smoke("rwkv6-7b")
    gpu = TR.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    cpu = TR.init_params(torch.Generator().manual_seed(0), cfg)
    cpu.load_state_dict(gpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(14).integers(0, cfg.vocab_size, (3, 20)))
    before = kwkv.wkv6.launches
    lg, _ = TR.forward(gpu, {"tokens": toks.to(cuda)}, cfg)
    assert kwkv.wkv6.launches == before + cfg.num_layers
    lc, _ = TR.forward(cpu, {"tokens": toks}, cfg)
    assert_close(lg, lc)
    model = get_model(cfg)
    outs = []
    for params in (gpu, cpu):
        eng = ServeEngine(model, cfg, params, ServeConfig(max_seq=64, batch_slots=2,
                                                          max_new_tokens=8))
        for row in toks.numpy():
            eng.submit(row)
        outs.append(eng.run())
    assert outs[0] == outs[1]
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("band", [0, 8, 9, 13, 15, 16, 17, 31, 32, 33, 255])
def test_dtw_band_kernel_equals_plain_bitwise(cuda, n, band):
    """Every banded-DTW kernel that takes the band equals ``dtw_band_ref``
    in every bit: v1, v2 with one thread a pair (instances of 17, 33 and 65
    cells: bands up to 8, 16, 32) and v2 with each lane count (64 band
    cells a pair at most: bands up to 31), at each instance's edge bands;
    a query against a ragged number of candidates (a block's edge), 1 and
    33 candidates (a group's and a warp's edge) and queries against their
    own candidates (a refinement round). Band 255 covers the whole matrix
    at both lengths (clamped to n - 1: v1, whose opt-in shared memory it
    takes at n = 256; at n = 64, v2). Some candidates hold +-1e20 and
    +-3e19 (costs overflow to inf, sums pass 3.0e38), where a cell left at
    inf instead of 3.0e38 would show. ``dtw_band`` itself (``_plan``'s
    choice) is one launch and equals the CPU's result."""
    data = torch.from_numpy(walks(21, 1000, n)).to(cuda)
    data[::7, 5] = 1e20
    data[::11, :3] = -3e19
    data[::13, -2:] = 1.3e19
    q = torch.from_numpy(walks(22, 3, n)).to(cuda)
    b = min(band, n - 1)
    plans = [("v1", 1)] + ([("v2", 1)] if b <= kdtw.ROW_BANDS[-1] else []) \
        + ([("v2", g) for g in kdtw.LANES] if b <= kdtw.LANE_MAX_BAND else [])
    for qa, ca in ((q[0], data), (q[0], data[:1]), (q[0], data[:33]),
                   (q, data[:3 * 257].reshape(3, 257, n))):
        want = tref.dtw_band_ref(qa, ca, band).view(torch.int32)
        for plan in plans:
            before = kdtw.dtw_band.launches
            got = kdtw.dtw_band_as(qa, ca, band, *plan)
            assert kdtw.dtw_band.launches == before + 1
            assert torch.equal(got.view(torch.int32), want), plan
        before = kdtw.dtw_band.launches
        assert torch.equal(kdtw.dtw_band(qa, ca, band).view(torch.int32), want)
        assert kdtw.dtw_band.launches == before + 1
    assert torch.equal(kdtw.dtw_band(q[0], data, band).cpu(),
                       tref.dtw_band_ref(q[0].cpu(), data.cpu(), band))


def test_dtw_knn_on_the_card_equals_cpu(cuda):
    """``dtw_knn`` over the same index on the card and on the CPU: dists and
    positions equal bit for bit (LB_Keogh is a fixed-order sum and each DTW
    cell one rounded add, so even the refinement order is the same)."""
    data = walks(23, 4096, 128)
    rng = np.random.default_rng(24)
    q = torch.from_numpy((data[rng.integers(0, 4096, 6)]
                          + rng.standard_normal((6, 128)) * np.sqrt(0.05)).astype(np.float32))
    icfg = IndexConfig(build=TT.BuildConfig(leaf_capacity=128),
                       search=SearchConfig(chunk=256, scan_block=256))
    gpu = E.make_backend("local", data, index_config=icfg, device=cuda).index.layout
    cpu = E.make_backend("local", data, index_config=icfg, device="cpu").index.layout
    for k, band in ((1, 6), (4, 13)):
        sg, sc = {}, {}
        dg, pg = TD.dtw_knn(gpu, q.to(cuda), k=k, band=band, stats=sg)
        dc, pc = TD.dtw_knn(cpu, q, k=k, band=band, stats=sc)
        assert torch.equal(dg.cpu().view(torch.int32), dc.view(torch.int32))
        assert torch.equal(pg.cpu(), pc)
        assert sg == sc


def test_sanitized_pinned_reader_equals_plain(cuda, monkeypatch):
    """Under REPRO_SANITIZE=1 the pinned reader poisons each recycled slot
    and checks every staged copy after its event: a real copy passes (no
    SanitizerError), with the plain reader's bytes."""
    from repro_torch.analysis import sanitize
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    data = np.random.default_rng(25).standard_normal((3000, 40)).astype(np.float32)
    src = TP.ArrayChunkSource(data, 512)
    got = torch.cat([c for _, c in TP.iter_device_chunks(src, cuda, prefetch="thread")])
    np.testing.assert_array_equal(got.cpu().numpy(), data)


def _dense_pair(cuda, arch):
    """The smoke model's parameters made on the card, and a CPU copy."""
    cfg = get_smoke(arch)
    model = get_model(cfg)
    gpu = model.init(torch.Generator(device=resolve_device(cuda)).manual_seed(0), cfg)
    cpu = model.init(torch.Generator().manual_seed(0), cfg)
    cpu.load_state_dict(gpu.state_dict())
    return cfg, model, gpu, cpu


def _dense_batch(cfg, seed, b, t, device):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t))
                                        .astype(np.int32))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.num_patches, cfg.d_patch)).astype(np.float32))
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["minicpm-2b", "granite-34b", "llama3-405b",
                                  "phi-3-vision-4.2b"])
def test_dense_smoke_on_the_card_equals_cpu(cuda, arch):
    """Forward logits within 1e-4 and the same served greedy tokens."""
    cfg, model, gpu, cpu = _dense_pair(cuda, arch)
    batch = _dense_batch(cfg, 15, 3, 12, "cpu")
    lg, _ = model.forward(gpu, {k: v.to(cuda) for k, v in batch.items()}, cfg)
    lc, _ = model.forward(cpu, batch, cfg)
    assert_close(lg, lc)
    outs = []
    for params in (gpu, cpu):
        eng = ServeEngine(model, cfg, params, ServeConfig(max_seq=64, batch_slots=2,
                                                          max_new_tokens=8))
        for i, row in enumerate(batch["tokens"].numpy()):
            extras = ({"patch_embeds": batch["patch_embeds"][i].numpy()}
                      if cfg.family == "vlm" else None)
            eng.submit(row, extras)
        outs.append(eng.run())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_train_step_on_the_card_equals_cpu(cuda, moments):
    """One train step (microbatches 2): loss and metrics within 1e-4, the
    gradients within 1e-4 of each tensor's largest magnitude, and AdamW on
    the card's gradients (moved to the CPU for the CPU's update) within
    1e-6."""
    cfg, model, gpu, cpu = _dense_pair(cuda, "minicpm-2b")
    tcfg = TTS.TrainConfig(optimizer=TO.AdamWConfig(learning_rate=1e-3, warmup_steps=1,
                                                    moment_dtype=moments),
                           microbatches=2)
    batch = _dense_batch(cfg, 16, 4, 10, "cpu")
    grad_fn = TTS.make_grad_fn(model, cfg, tcfg)
    mg, gg = grad_fn(gpu, {k: v.to(cuda) for k, v in batch.items()})
    mc, gc = grad_fn(cpu, batch)
    for k in mc:
        assert_close(mg[k], mc[k])
    for a, b in zip(TMC.tree_leaves(gg), TMC.tree_leaves(gc)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))
    sg = TO.adamw_init(gpu, tcfg.optimizer)
    sc = TO.adamw_init(cpu, tcfg.optimizer)
    _, sg, og = TO.adamw_update(gpu, gg, sg, tcfg.optimizer)
    _, sc, oc = TO.adamw_update(cpu, TMC.tree_map(lambda g: g.cpu(), gg), sc, tcfg.optimizer)
    for a, b in zip(gpu.parameters(), cpu.parameters()):
        np.testing.assert_allclose(a.detach().cpu().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(og["grad_norm"]), float(oc["grad_norm"]), rtol=1e-6)
    step = TTS.make_train_step(model, cfg, tcfg)
    _, sg, metrics = step(gpu, sg, {k: v.to(cuda) for k, v in batch.items()})
    assert np.isfinite(float(metrics["loss"])) and int(sg["step"]) == 2


# (B, T, R, floats the (B, T, R) operands sit into their buffers): the
# Griffin path's prefill / training and decode shapes, ragged shapes, T=0,
# v2's tile tail, R % 32 != 0, R % 4 != 0 (v1), B * R under one block, and
# the path's shape as a view one float in (not 16-byte aligned: v1)
RG_CASES = [(4, 512, 2560, 0), (4, 1, 2560, 0), (3, 37, 77, 0), (1, 9, 1, 0), (2, 0, 5, 0),
            (4, 515, 2560, 0), (2, 100, 36, 0), (2, 100, 37, 0), (1, 64, 8, 0),
            (4, 512, 2560, 1)]


def offset_view(x, offset):
    """``x`` as a contiguous view ``offset`` floats into a new buffer."""
    if not offset:
        return x
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    buf[offset:] = x.reshape(-1)
    return buf[offset:].view(x.shape)


# the cases that the plan sends to v2 (aligned, R % 4 == 0, T >= V2_MIN_STEPS)
RG_V2 = {(4, 512, 2560, 0), (4, 515, 2560, 0), (2, 100, 36, 0), (1, 64, 8, 0)}


def rg_launch_once(wrapper, b, t, r, offset, call):
    """``call()``, which must launch ``wrapper``'s kernel once (none at
    T=0), the variant the plan picks for the case."""
    planned = "v2" if (b, t, r, offset) in RG_V2 else "v1"
    assert krg._plan(t, r, offset == 0) == planned
    before, by = wrapper.launches, wrapper.launches_by[(planned, (b, t, r))]
    got = call()
    assert wrapper.launches == before + (1 if t else 0)
    assert wrapper.launches_by[(planned, (b, t, r))] == by + (1 if t else 0)
    return got


@pytest.mark.parametrize("b,t,r,offset", RG_CASES)
def test_rg_lru_scan_kernel_equals_plain_bitwise(cuda, b, t, r, offset):
    """y and hT equal the plain version in every bit, on the card and on the
    CPU, through ``ops.rg_lru_scan``: the plan's variant (v2 at the cases of
    ``RG_V2``, v1 at the rest), one launch a call, none at T=0."""
    rng = np.random.default_rng(31)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (b, t, r)).astype(np.float32))
    g = randn(32, b, t, r)
    h0 = randn(33, b, r)
    ac, gc = offset_view(a.to(cuda), offset), offset_view(g.to(cuda), offset)
    want = tref.rg_lru_scan_ref(ac, gc, h0.to(cuda))
    cpu = tref.rg_lru_scan_ref(a, g, h0)
    got = rg_launch_once(krg.rg_lru_scan, b, t, r, offset,
                         lambda: tops.rg_lru_scan(ac, gc, h0.to(cuda)))
    for x, w, c in zip(got, want, cpu):
        assert torch.equal(x.view(torch.int32), w.view(torch.int32))
        assert torch.equal(x.cpu().view(torch.int32), c.view(torch.int32))


def test_rg_lru_scan_kernel_refuses_what_it_cannot_take(cuda):
    a, g, h0 = randn(34, 2, 3, 4).to(cuda), randn(35, 2, 3, 4).to(cuda), randn(36, 2, 4).to(cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        krg.rg_lru_scan(a.cpu(), g, h0)
    with pytest.raises(TypeError, match="float32"):
        krg.rg_lru_scan(a.double(), g, h0)
    with pytest.raises(ValueError, match="shapes"):
        krg.rg_lru_scan(a, g, h0[:1])
    y, _ = krg.rg_lru_scan(a, g, h0)
    with pytest.raises(ValueError, match="one CUDA device"):
        krg.rg_lru_scan_bwd(a, y.cpu(), h0, g, h0)
    with pytest.raises(TypeError, match="float32"):
        krg.rg_lru_scan_bwd(a, y, h0, g.double(), h0)
    with pytest.raises(ValueError, match="shapes"):
        krg.rg_lru_scan_bwd(a, y, h0, g, h0[:1])


@pytest.mark.parametrize("b,t,r,offset", RG_CASES)
def test_rg_lru_scan_bwd_kernel_equals_plain_bitwise(cuda, b, t, r, offset):
    """The scan's gradient at the cases of the forward: da, dg and dh0
    equal ``rg_lru_scan_bwd_ref`` in every bit, on the card and on the CPU,
    through the plan's variant; one launch a call (none at T=0)."""
    rng = np.random.default_rng(41)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (b, t, r)).astype(np.float32)).to(cuda)
    h0 = randn(42, b, r).to(cuda)
    y, _ = krg.rg_lru_scan(a, randn(43, b, t, r).to(cuda), h0)
    dy, dht = randn(44, b, t, r).to(cuda), randn(45, b, r).to(cuda)
    a, y, dy = (offset_view(x, offset) for x in (a, y, dy))
    args = (a, y, h0, dy, dht)
    want = tref.rg_lru_scan_bwd_ref(*args)
    cpu = tref.rg_lru_scan_bwd_ref(*(v.cpu() for v in args))
    got = rg_launch_once(krg.rg_lru_scan_bwd, b, t, r, offset,
                         lambda: krg.rg_lru_scan_bwd(*args))
    for x, w, c in zip(got, want, cpu):
        assert torch.equal(x.view(torch.int32), w.view(torch.int32))
        assert torch.equal(x.cpu().view(torch.int32), c.view(torch.int32))


def _wkv_grad_args(seed, b, t, h, dk, dv, dtype, cuda, step3=True):
    """Inputs of ``wkv6_bwd`` from a seed: w == 0 at half the rows of step 3
    (with ``step3``, T > 3) and at every third row of steps C + 1 .. C + 3
    (T > C + 3), C the kernel's chunk: chunk 1 only."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)

    r, k, v, dout = n(b, t, h, dk), n(b, t, h, dk), n(b, t, h, dv), n(b, t, h, dv)
    w = torch.sigmoid(n(b, t, h, dk))
    if step3 and t > 3:
        w[:, 3, :, : dk // 2] = 0.0            # resets in one step
    c = kwkv.BWD_CHUNK
    if t > c + 3:
        w[:, c + 1:c + 4, :, ::3] = 0.0        # resets in chunk 1
    return (r.to(dtype), k.to(dtype), v.to(dtype), w, n(h, dk), n(b, h, dk, dv),
            dout.to(dtype), n(b, h, dk, dv))


def _grad_words(x):
    """The bits of a float32 or bf16 gradient, as integers."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x.view(torch.int16)


WKV_BWD_CHUNK = kwkv.BWD_CHUNK     # csrc/wkv6_bwd.cu's steps a checkpoint covers


def _hold_wkv6_bwd_kernel(args, dtype):
    """The gradient's kernel on ``args`` against ``wkv6_bwd_ref`` (float32
    within 1e-5 of each tensor's largest magnitude, bf16 gradients within a
    bf16 step, 8e-3 of it), dw exactly 0 at the reset rows, the dtypes of
    the inputs, one launch a call, a second launch bit-equal to the first,
    and bit for bit ``wkv6_bwd_fma_ref``."""
    before = kwkv.wkv6_bwd.launches
    got = kwkv.wkv6_bwd(*args)
    assert kwkv.wkv6_bwd.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    for x, want in zip(got, tref.wkv6_bwd_ref(*args)):
        assert x.dtype == want.dtype and x.shape == want.shape
        biggest = float(want.abs().max()) if want.numel() else 0.0
        np.testing.assert_allclose(x.float().cpu().numpy(), want.float().cpu().numpy(),
                                   rtol=0, atol=tol * max(biggest, 1e-30))
    assert not got[3][args[3] == 0.0].any()
    for x, y in zip(got, tref.wkv6_bwd_fma_ref(*args)):
        assert torch.equal(_grad_words(x), _grad_words(y))
    for x, y in zip(got, kwkv.wkv6_bwd(*args)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,dk,dv", [(2, 67, 3, 64, 64), (1, 33, 2, 33, 17),
                                         (2, 1, 4, 64, 64), (1, 0, 2, 8, 8),
                                         (1, 20, 1, 1, 1),
                                         (1, WKV_BWD_CHUNK - 1, 2, 64, 64),
                                         (2, WKV_BWD_CHUNK, 1, 64, 64),
                                         (1, WKV_BWD_CHUNK + 1, 2, 17, 64),
                                         (2, 2 * WKV_BWD_CHUNK + 3, 2, 64, 64),
                                         (4, 512, 64, 64, 64)])
def test_wkv6_bwd_kernel_matches_plain(cuda, b, t, h, dk, dv, dtype):
    """:func:`_hold_wkv6_bwd_kernel`, resets at step 3 (T > 3) and in chunk
    1 (T > C + 3), at T across the kernel's chunk edges and at the training
    shape."""
    _hold_wkv6_bwd_kernel(_wkv_grad_args(46, b, t, h, dk, dv, dtype, cuda), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,dk,dv", [(2, 2 * WKV_BWD_CHUNK + 3, 2, 64, 64),
                                         (1, 2 * WKV_BWD_CHUNK + 3, 2, 33, 17)])
def test_wkv6_bwd_kernel_resets_in_one_chunk(cuda, b, t, h, dk, dv, dtype):
    """:func:`_hold_wkv6_bwd_kernel` with w == 0 in chunk 1 only: chunks 0
    and 2 run without the reset's select."""
    args = _wkv_grad_args(48, b, t, h, dk, dv, dtype, cuda, step3=False)
    c = WKV_BWD_CHUNK
    assert bool((args[3][:, c:2 * c] == 0).any()) and not bool((args[3][:, :c] == 0).any())
    assert not bool((args[3][:, 2 * c:] == 0).any())
    _hold_wkv6_bwd_kernel(args, dtype)


def test_recurrent_train_steps_on_the_card_equal_cpu(cuda):
    """rwkv6 and recurrentgemma smoke models: a train step's metrics within
    1e-4 and gradients within 1e-4 of each tensor's largest magnitude, the
    card's through the backward kernels (launched), the CPU's through the
    plain backward versions."""
    for arch, kname in (("rwkv6-7b", kwkv.wkv6_bwd), ("recurrentgemma-2b", krg.rg_lru_scan_bwd)):
        cfg, model, gpu, cpu = _smoke_pair(cuda, arch)
        batch = _dense_batch(cfg, 47, 2, 12, "cpu")
        grad_fn = TTS.make_grad_fn(model, cfg, TTS.TrainConfig())
        before = kname.launches
        mg, gg = grad_fn(gpu, {k: v.to(cuda) for k, v in batch.items()})
        assert kname.launches > before
        mc, gc = grad_fn(cpu, batch)
        for k in mc:
            assert_close(mg[k], mc[k])
        for a, b in zip(TMC.tree_leaves(gg), TMC.tree_leaves(gc)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-4 * float(b.abs().max()))


def _smoke_pair(cuda, arch):
    """The smoke model's parameters made on the card, and a CPU copy."""
    cfg = get_smoke(arch)
    model = get_model(cfg)
    gpu = model.init(torch.Generator(device=resolve_device(cuda)).manual_seed(0), cfg)
    return cfg, model, gpu, model.params_from_numpy(gpu.tree(), cfg, "cpu")


def _served(model, cfg, params, rows):
    eng = ServeEngine(model, cfg, params, ServeConfig(max_seq=64, batch_slots=2,
                                                      max_new_tokens=8))
    for row in rows:
        eng.submit(row)
    return eng.run()


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "moonshot-v1-16b-a3b"])
def test_moe_smoke_on_the_card_equals_cpu(cuda, arch):
    """Forward logits and aux within 1e-4, the same served greedy tokens,
    and a train step's metrics (``moe_aux`` among them) within 1e-4 and
    gradients within 1e-4 of each tensor's largest magnitude."""
    cfg, model, gpu, cpu = _smoke_pair(cuda, arch)
    batch = _dense_batch(cfg, 37, 3, 12, "cpu")
    with torch.no_grad():
        lg, ag = model.forward(gpu, {k: v.to(cuda) for k, v in batch.items()}, cfg)
        lc, ac = model.forward(cpu, batch, cfg)
    assert_close(lg, lc)
    assert_close(ag, ac)
    rows = batch["tokens"].numpy()
    assert _served(model, cfg, gpu, rows) == _served(model, cfg, cpu, rows)
    grad_fn = TTS.make_grad_fn(model, cfg, TTS.TrainConfig())
    mg, gg = grad_fn(gpu, {k: v.to(cuda) for k, v in batch.items()})
    mc, gc = grad_fn(cpu, batch)
    assert "moe_aux" in mc
    for k in mc:
        assert_close(mg[k], mc[k])
    for a, b in zip(TMC.tree_leaves(gg), TMC.tree_leaves(gc)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


def test_griffin_smoke_on_the_card_equals_cpu(cuda):
    """recurrentgemma's smoke model with the same weights: the card
    (``rg_lru_scan``, one launch a recurrent layer a call) and the CPU
    (its plain version) give logits within 1e-4 and the same served
    tokens, past the local window of 16."""
    cfg, model, gpu, cpu = _smoke_pair(cuda, "recurrentgemma-2b")
    toks = torch.from_numpy(np.random.default_rng(38).integers(0, cfg.vocab_size, (3, 20)))
    before = krg.rg_lru_scan.launches
    with torch.no_grad():
        lg, _ = model.forward(gpu, {"tokens": toks.to(cuda)}, cfg)
        lc, _ = model.forward(cpu, {"tokens": toks}, cfg)
    assert krg.rg_lru_scan.launches == before + 2
    assert_close(lg, lc)
    rows = toks.numpy()
    assert _served(model, cfg, gpu, rows) == _served(model, cfg, cpu, rows)


def test_loader_stages_on_the_card(cuda):
    """``DoubleBufferedLoader`` on the card: pinned copies on a side stream,
    the consumer's stream waiting on each batch's event; the batches equal
    the CPU loader's bit for bit, whatever ``make_batch`` does to its
    buffer after handing it over."""
    buf = np.zeros((64, 1024), np.float32)

    def make(step):
        buf[:] = np.random.default_rng(step).standard_normal(buf.shape)
        return {"x": buf, "ids": torch.arange(8, dtype=torch.int32) + step}

    card = TP.DoubleBufferedLoader(make, device=cuda)
    got = [next(card) for _ in range(4)]
    host = TP.DoubleBufferedLoader(make, device="cpu")
    for batch in got:
        want = next(host)
        assert batch["x"].device.type == "cuda" and batch["ids"].dtype == torch.int32
        assert torch.equal(batch["x"].cpu(), want["x"])
        assert torch.equal(batch["ids"].cpu(), want["ids"])
    assert card.state == 4


def test_whisper_smoke_on_the_card_equals_cpu(cuda):
    """whisper's smoke model with the same weights: forward logits within
    1e-4 and the same served greedy tokens, with each request's frames;
    no kernel of the port launches."""
    cfg, model, gpu, cpu = _smoke_pair(cuda, "whisper-large-v3")
    rng = np.random.default_rng(39)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 12)).astype(np.int32))
    frames = torch.from_numpy(rng.standard_normal((3, cfg.num_frames, cfg.d_model))
                              .astype(np.float32))
    with torch.no_grad():
        lg, _ = model.forward(gpu, {"tokens": toks.to(cuda), "frames": frames.to(cuda)}, cfg)
        lc, _ = model.forward(cpu, {"tokens": toks, "frames": frames}, cfg)
    assert_close(lg, lc)
    outs = []
    for params in (gpu, cpu):
        eng = ServeEngine(model, cfg, params, ServeConfig(max_seq=64, batch_slots=2,
                                                          max_new_tokens=8))
        for row, f in zip(toks.numpy(), frames.numpy()):
            eng.submit(row, {"frames": f})
        outs.append(eng.run())
    assert outs[0] == outs[1]


def test_pipeline_on_four_card_stages_equals_cpu(cuda):
    """GPipe with P = 4 stages on four ``cuda`` entries (tanh layers, L = 8,
    d = 16, microbatches of 4, M = 6): outputs and gradients of
    sum(out**2) within 1e-5 and 1e-4 of the same pipeline on the CPU."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((8, 16, 16)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((6, 4, 16)).astype(np.float32)

    def stage(params, x):
        for wi in params:
            x = torch.tanh(x @ wi)
        return x

    got = []
    for dev in (cuda, torch.device("cpu")):
        tw = torch.from_numpy(w).to(dev).requires_grad_(True)
        out = TPIPE.pipeline_forward(stage, TPIPE.split_stages(tw, 4),
                                     torch.from_numpy(xs).to(dev), [dev] * 4)
        (out ** 2).sum().backward()
        got.append((out.detach().cpu(), tw.grad.cpu()))
    assert float((got[0][0] - got[1][0]).abs().max()) < 1e-5
    assert float((got[0][1] - got[1][1]).abs().max()) < 1e-4


def test_compressed_mean_on_the_card_equals_cpu(cuda):
    """The int8 error-feedback mean over four workers on one card, two
    steps: means, error buffers, codes and scales bit for bit the CPU's."""
    rng = np.random.default_rng(1)
    grads = [{"w": rng.standard_normal((33, 65)).astype(np.float32) * (w + 1),
              "b": rng.standard_normal(65).astype(np.float32)} for w in range(4)]
    runs = []
    for dev in (cuda, torch.device("cpu")):
        gs = [{k: torch.from_numpy(v).to(dev) for k, v in g.items()} for g in grads]
        errs = [TCOMP.init_error_buffer(g) for g in gs]
        steps = []
        for _ in range(2):
            means, errs = TCOMP.compressed_psum(gs, errs)
            steps.append([means[0]["w"], means[0]["b"]] + [e[k] for e in errs for k in "wb"])
        steps.append([t for g in gs for t in TCOMP.compress_int8(g["w"])])
        runs.append([t.cpu() for ts in steps for t in ts])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
