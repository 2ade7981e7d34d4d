"""Port vs reference: the int8 error-feedback all-reduce
(``repro_torch.train.compression``).

``compress_int8`` must give the reference's codes and scale exactly (an
all-zero tensor, ties at .5 and tensors of every sign included); the
error-feedback contraction and the round-trip bound are the reference's
tests (``tests/test_train.py``). The port's mean over W = 4 workers
(``["cpu"] * 4``) must equal the reference's
``jax.vmap(make_compressed_psum("dp"), axis_name="dp")`` on the same
stacked gradients over two steps: the codes exactly, the means and the new
error buffers within 1 ulp. Gradients come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as JC
from repro_torch.models import common as TC
from repro_torch.train import compression as TCOMP
from repro_torch.train import (compress_int8, compressed_psum, decompress_int8,
                               init_error_buffer, make_compressed_psum)
from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

W = 4


def _tensors(seed):
    rng = np.random.default_rng(seed)
    ties = (np.arange(-127, 128, dtype=np.float32) + 0.5) / 127.0
    return [
        (rng.standard_normal((64, 64)) * 3.0).astype(np.float32),
        np.zeros((5, 7), np.float32),
        np.concatenate([ties, [-1.0, 1.0]]).astype(np.float32),
        (rng.standard_normal(1000) * 1e-30).astype(np.float32),
        -np.abs(rng.standard_normal((3, 4, 5))).astype(np.float32) * 1e4,
        rng.uniform(-1, 1, 4096).astype(np.float32),
    ]


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-(2 ** 31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(2 ** 31)) - ib, ib)
    return int(np.abs(ia - ib).max()) if a.size else 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codes_and_scale_equal_the_reference(seed):
    for x in _tensors(seed):
        q, s = compress_int8(torch.from_numpy(x))
        jq, js = JC.compress_int8(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.ndim == 0
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert np.float32(s.item()).tobytes() == np.asarray(js, np.float32).tobytes()
        back = decompress_int8(q, s).numpy()
        assert back.tobytes() == np.asarray(JC.decompress_int8(jq, js)).tobytes()


def test_all_zero_tensor():
    q, s = compress_int8(torch.zeros(3, 3))
    assert float(s) == 0.0 and not q.any()


def test_int8_roundtrip_error_bounded():
    x = torch.from_numpy((np.random.default_rng(5).standard_normal((64, 64)) * 3.0
                          ).astype(np.float32))
    q, s = compress_int8(x)
    assert float((decompress_int8(q, s) - x).abs().max()) <= float(s) * 0.51 + 1e-6


def test_error_feedback_contracts():
    """Sum of (compressed + carried error) over steps converges to the true
    sum (the reference's test)."""
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(128).astype(np.float32))
    e = torch.zeros(128)
    acc = torch.zeros(128)
    for _ in range(50):
        q, s = compress_int8(g + e)
        approx = decompress_int8(q, s)
        e = (g + e) - approx
        acc = acc + approx
    np.testing.assert_allclose((acc / 50).numpy(), g.numpy(), atol=0.02)


def _worker_grads(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (32, 48), "b": (48,), "blocks": [{"k": (4, 8, 8)}, {"k": (4, 8, 8)}]}

    def draw(shape, w):
        return (rng.standard_normal(shape) * (1.0 + w)).astype(np.float32)

    return [{"w": draw(shapes["w"], w), "b": np.zeros(48, np.float32) if w == 2 else
             draw(shapes["b"], w), "blocks": [{"k": draw((4, 8, 8), w)} for _ in range(2)]}
            for w in range(W)]


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(tree.copy())


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


@pytest.mark.parametrize("seed", [0, 3])
def test_four_worker_mean_equals_the_reference_vmap(seed):
    steps = [_worker_grads(seed), _worker_grads(seed + 100)]
    port = make_compressed_psum()
    assert port is compressed_psum
    ref = jax.vmap(JC.make_compressed_psum("dp"), axis_name="dp")
    errs = [init_error_buffer(_to_torch(steps[0][w])) for w in range(W)]
    jerr = _stack([JC.init_error_buffer(jax.tree.map(jnp.asarray, steps[0][w]))
                   for w in range(W)])
    for grads in steps:
        means, errs = port([_to_torch(g) for g in grads], errs)
        jmean, jerr = ref(_stack([jax.tree.map(jnp.asarray, g) for g in grads]), jerr)
        for w in range(W):
            got_m = jax.tree.leaves(means[w])
            got_e = jax.tree.leaves(errs[w])
            for gm, jm in zip(got_m, jax.tree.leaves(jmean)):
                assert _ulps(gm.numpy(), np.asarray(jm)[w]) <= 1
            for ge, je in zip(got_e, jax.tree.leaves(jerr)):
                assert _ulps(ge.numpy(), np.asarray(je)[w]) <= 1
        # every worker holds the same mean
        for leaves in zip(*(jax.tree.leaves(m) for m in means)):
            assert all(torch.equal(leaves[0], x) for x in leaves[1:])


def _f32(x):
    """A float64 array rounded to float32 and back: one float32 operation
    (float64 keeps more than 2 x 24 + 2 bits, so rounding twice is exact)."""
    return x.astype(np.float32).astype(np.float64)


@pytest.mark.parametrize("seed", [0, 5])
def test_four_worker_mean_is_the_arithmetic_exactly(seed):
    """Over three steps, every new buffer is exactly x - q * scale and the
    mean exactly sum(q) * scale / W, with x = g + e, scale = max|x| / 127
    over the workers and q = round(x / scale), each float32 operation
    recomputed in float64 and rounded (what ``chip_smoke.py`` phase 32
    holds the card to)."""
    grads = _worker_grads(seed)
    grads[1]["w"][0, :8] = (np.arange(8) + 0.5) * 0.01      # quotients near ties
    tg = [_to_torch(g) for g in grads]
    errs = [init_error_buffer(g) for g in tg]
    for _ in range(3):
        prev = [[e.numpy().astype(np.float64) for e in TC.tree_leaves(t)] for t in errs]
        means, errs = compressed_psum(tg, errs)
        for i in range(len(prev[0])):
            xs = [_f32(TC.tree_leaves(tg[w])[i].numpy().astype(np.float64) + prev[w][i])
                  for w in range(W)]
            scale = max(_f32(np.abs(x).max() / 127.0) for x in xs)
            div = max(scale, float(np.float32(1e-20)))
            summed = np.zeros_like(xs[0])
            for w, x in enumerate(xs):
                q = np.round(_f32(x / div))
                assert np.abs(q).max() <= 127
                want = _f32(x - _f32(q * scale)).astype(np.float32)
                assert TC.tree_leaves(errs[w])[i].numpy().tobytes() == want.tobytes()
                summed += q
            want = _f32(_f32(summed * scale) / W).astype(np.float32)
            assert TC.tree_leaves(means[0])[i].numpy().tobytes() == want.tobytes()


def test_codes_summed_equal_the_reference():
    grads = _worker_grads(9)
    tg = [_to_torch(g) for g in grads]
    errs = [init_error_buffer(g) for g in tg]
    captured = []
    orig = TCOMP._codes

    def spy(x32, scale):
        q = orig(x32, scale)
        captured.append(q.clone())
        return q

    TCOMP._codes, saved = spy, TCOMP._codes
    try:
        compressed_psum(tg, errs)
    finally:
        TCOMP._codes = saved
    # the reference's codes: q = round(g32 / shared scale) per worker
    flat = [[jnp.asarray(x) for x in TC.tree_leaves(g)] for g in grads]   # the port's order
    i = 0
    for leaf in range(len(flat[0])):
        scales = [JC.compress_int8(flat[w][leaf])[1] for w in range(W)]
        scale = jnp.max(jnp.stack(scales))
        for w in range(W):
            jq = jnp.round(flat[w][leaf] / jnp.maximum(scale, 1e-20)).astype(jnp.int8)
            assert np.array_equal(captured[i].numpy(), np.asarray(jq))
            i += 1


def test_mismatched_workers_are_refused():
    g = [{"w": torch.zeros(2)}] * 2
    with pytest.raises(ValueError):
        compressed_psum(g, g[:1])
