"""The port on a CUDA card: each hand-written kernel against its plain
version, and the card's build and answers against the CPU's.

Every test here carries the ``gpu`` marker and skips without a CUDA card.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)

Tolerances: float32 ``rtol = atol = 1e-4``, bfloat16 series
``rtol = 5e-2, atol = 2.5e-1`` (``tests/test_kernel_conformance.py:15-31``);
argmins exactly equal; ``lb_sax_matrix`` equal in every bit (it rounds and
folds as its plain version does).
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
from repro_torch.kernels import ed as ked
from repro_torch.kernels import lb_sax as klb
from repro_torch.kernels import ref as tref

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
