"""The port on a CUDA card: each hand-written kernel against its plain
version, the pinned-slot reader, and the card's build and answers
(in memory and out of core) against the CPU's.

Every test here carries the ``gpu`` marker and skips without a CUDA card.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)

Tolerances: float32 ``rtol = atol = 1e-4``, bfloat16 series
``rtol = 5e-2, atol = 2.5e-1`` (``tests/test_kernel_conformance.py:15-31``);
argmins exactly equal; ``lb_sax_matrix`` equal in every bit (it rounds and
folds as its plain version does). ``decode_bf16_ed_matrix``: distances
within ``rtol = atol = 1e-4`` of the plain version, and within
``1e-5 * (||q||^2 + ||s^||^2)`` of a float64 evaluation -- the slack the
out-of-core bounds allow for it (``core/engine.py`` ``_BOUND_REL``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as E
from repro_torch.core import layout as TL
from repro_torch.core import summaries as TS
from repro_torch.core import tree as TT
from repro_torch.core.index import IndexConfig
from repro_torch.core.search import SearchConfig
from repro_torch.data import pipeline as TP
from repro_torch.kernels import ed as ked
from repro_torch.kernels import lb_sax as klb
from repro_torch.kernels import ref as tref
from repro_torch.storage import build_index_to_disk
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


def test_ed_min_ties_and_all_inf_rows(cuda):
    dmin, amin = ked.ed_min(torch.zeros(4, 16, device=cuda), torch.ones(300, 16, device=cuda))
    assert bool((amin == 0).all()) and bool((dmin == 16).all())
    dmin, amin = ked.ed_min(torch.full((2, 16), 2e19, device=cuda),
                            torch.full((300, 16), -2e19, device=cuda))
    assert bool(torch.isinf(dmin).all()) and bool((amin == 0).all())


@pytest.mark.parametrize("q,n,m,alphabet", [(1, 1, 16, 256), (5, 77, 16, 256),
                                            (3, 130, 8, 64), (1, 70001, 16, 256)])
def test_lb_sax_kernel_matches_plain_bitwise(cuda, q, n, m, alphabet):
    q_paa = TS.paa(randn(3, q, 4 * m).to(cuda), m)
    codes = TS.isax(randn(4, n, 4 * m).to(cuda), m, alphabet)
    got = klb.lb_sax_matrix(q_paa, codes, 4 * m, alphabet)
    assert torch.equal(got, tref.lb_sax_matrix_ref(q_paa, codes, 4 * m, alphabet))


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
                                   (128, 131, 255), (5, 4097, 64), (128, 64, 7)])
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
