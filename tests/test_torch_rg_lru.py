"""The RG-LRU scan kernels' plan and launch counts on the CPU
(``repro_torch/kernels/rg_lru.py``).

``_plan`` is a pure function of the call's T, R and alignment: v2 (the
ring of ``cp.async`` stages) from ``V2_MIN_STEPS`` steps where R is a
multiple of 4 and the (B, T, R) operands are 16-byte aligned, v1 otherwise
(decode, ragged R, a view with a storage offset). The kernels themselves
run only on the card (``tests/test_torch_gpu.py`` holds both variants to
the plain versions bit for bit there); on CPU tensors ``kernels/ops.py``
and ``RGLRUScanFn`` take the plain versions (``kernels/ref.py``) and
launch nothing.
"""
import collections
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rg_lru as krg
from repro_torch.kernels.compat import count_launch
from _torch_threads import one_torch_thread  # noqa: F401


def inputs(seed, b, t, r):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, (b, t, r)).astype(np.float32)
    g, dy = (rng.standard_normal((b, t, r)).astype(np.float32) for _ in range(2))
    h0, dht = (rng.standard_normal((b, r)).astype(np.float32) for _ in range(2))
    return a, g, h0, dy, dht


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def test_plan_takes_v2_at_the_path_shape():
    """The Griffin path's prefill and training shape (4, 512, 2560), forward
    and backward: one plan for both wrappers."""
    assert krg._plan(512, 2560, True) == "v2"
    assert krg._plan(515, 2560, True) == "v2"         # a tile tail
    assert krg._plan(512, 36, True) == "v2"           # R % 32 != 0, R % 4 == 0


@pytest.mark.parametrize("t,r,aligned", [(1, 2560, True), (512, 2563, True),
                                         (512, 77, True), (512, 2560, False),
                                         (0, 2560, True), (1, 3, False)])
def test_plan_takes_v1_for_decode_ragged_r_and_unaligned(t, r, aligned):
    assert krg._plan(t, r, aligned) == "v1"


def test_plan_boundary_of_t_long_enough():
    m = krg.V2_MIN_STEPS
    assert krg._plan(m - 1, 2560, True) == "v1"
    assert krg._plan(m, 2560, True) == "v2"
    assert krg._plan(m, 4, True) == "v2"
    assert krg._plan(m, 4, False) == "v1"
    assert krg._plan(m, 6, True) == "v1"


def test_alignment_sees_a_storage_offset():
    """A contiguous view one float into its buffer is not 16-byte aligned,
    and the wrapper's ``contiguous()`` keeps it so: v1."""
    buf = torch.zeros(4 * 64 * 8 + 4)
    x = buf[4:].view(4, 64, 8)
    assert x.is_contiguous() and krg._aligned(x)
    y = buf[1:1 + 4 * 64 * 8].view(4, 64, 8)
    assert y.is_contiguous() and not krg._aligned(y) and not krg._aligned(y.contiguous())
    assert krg._plan(64, 8, krg._aligned(x)) == "v2"
    assert krg._plan(64, 8, krg._aligned(x, y)) == "v1"


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------

def test_count_launch_counts_by_key_where_one_is_given():
    def wrapper():
        pass

    wrapper.launches, wrapper.launches_by = 0, collections.Counter()
    count_launch(wrapper, ("v2", (4, 512, 2560)))
    count_launch(wrapper, ("v1", (4, 1, 2560)))
    count_launch(wrapper, ("v1", (4, 1, 2560)))
    count_launch(wrapper)
    assert wrapper.launches == 4
    assert wrapper.launches_by == {("v2", (4, 512, 2560)): 1, ("v1", (4, 1, 2560)): 2}


def test_count_launch_by_key_loses_no_count_between_threads():
    def wrapper():
        pass

    wrapper.launches, wrapper.launches_by = 0, collections.Counter()

    def launch(kind):
        for _ in range(2000):
            count_launch(wrapper, (kind, (1, 1, 1)))

    threads = [threading.Thread(target=launch, args=(k,)) for k in ("v1", "v2") * 4]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert wrapper.launches == 16000
    assert wrapper.launches_by == {("v1", (1, 1, 1)): 8000, ("v2", (1, 1, 1)): 8000}


@pytest.mark.parametrize("wrapper", [krg.rg_lru_scan, krg.rg_lru_scan_bwd])
def test_the_wrappers_count_by_variant_and_shape(wrapper):
    assert isinstance(wrapper.launches, int)
    assert isinstance(wrapper.launches_by, collections.Counter)


# ---------------------------------------------------------------------------
# CPU tensors take the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,r", [(4, 512, 16), (2, 1, 8), (2, 70, 6)])
def test_cpu_tensors_take_the_plain_versions_and_launch_nothing(b, t, r):
    a, g, h0, dy, dht = (torch.from_numpy(v) for v in inputs(7, b, t, r))
    counts = (krg.rg_lru_scan, krg.rg_lru_scan_bwd)
    before = [(w.launches, dict(w.launches_by)) for w in counts]
    y, h = tops.rg_lru_scan(a, g, h0)
    wy, wh = tref.rg_lru_scan_ref(a, g, h0)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    xs = [x.clone().requires_grad_(True) for x in (a, g, h0)]
    y2, h2 = tops.rg_lru_scan(*xs)
    assert type(y2.grad_fn).__name__.startswith("RGLRUScanFn")
    got = torch.autograd.grad((y2, h2), xs, (dy, dht))
    want = tref.rg_lru_scan_bwd_ref(a, wy, h0, dy, dht)
    for x, w in zip(got, want):
        assert torch.equal(x, w)
    assert [(w.launches, dict(w.launches_by)) for w in counts] == before


def test_the_wrappers_refuse_cpu_tensors_before_planning():
    a, g, h0, dy, dht = (torch.from_numpy(v) for v in inputs(8, 2, 64, 8))
    with pytest.raises(ValueError, match="one CUDA device"):
        krg.rg_lru_scan(a, g, h0)
    with pytest.raises(ValueError, match="one CUDA device"):
        krg.rg_lru_scan_bwd(a, a, h0, dy, dht)
