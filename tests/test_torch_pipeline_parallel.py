"""Port vs reference: GPipe over a "stage" axis
(``repro_torch.distributed.pipeline``).

The reference test's workload (``tests/test_pipeline.py``): L = 8 tanh
layers of width 16, microbatches of 4, M = 6, weights and inputs from a
numpy seed. The port's ``pipeline_forward`` at P = 1 and P = 4 over
``["cpu"] * 4`` (a stage mesh with repeats, as four stages on one card)
against the reference's plain ``ref_f``: outputs within 1e-5, gradients of
``sum(out**2)`` within 1e-4 of ``jax.grad``'s, the reference test's
limits. At P = 1 the reference's own ``pipeline_forward`` on its one-device
mesh runs too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compat import auto_axis_types, make_mesh
from repro.distributed.pipeline import pipeline_forward as jpipeline_forward
from repro.distributed.pipeline import split_stages as jsplit_stages
from repro_torch.distributed.pipeline import pipeline_forward, split_stages
from repro_torch.launch.mesh import Mesh
from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

L, D, MB, M = 8, 16, 4, 6


def _inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((M, MB, D)).astype(np.float32)
    return w, xs


def ref_f(w, x):
    for i in range(w.shape[0]):
        x = jnp.tanh(x @ w[i])
    return x


def stage_fn(params, x):
    for wi in params:
        x = torch.tanh(x @ wi)
    return x


def _ref(w, xs):
    out = jnp.stack([ref_f(w, xs[i]) for i in range(M)])
    grad = jax.grad(lambda w: jnp.sum(jnp.stack([ref_f(w, xs[i]) for i in range(M)]) ** 2))(w)
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_pipeline_matches_the_plain_reference(stages):
    w, xs = _inputs()
    want_out, want_grad = _ref(jnp.asarray(w), jnp.asarray(xs))
    tw = torch.from_numpy(w.copy()).requires_grad_(True)
    out = pipeline_forward(stage_fn, split_stages(tw, stages), torch.from_numpy(xs),
                           ["cpu"] * stages)
    assert out.shape == (M, MB, D)
    assert float(np.abs(out.detach().numpy() - want_out).max()) < 1e-5
    (out ** 2).sum().backward()
    assert float(np.abs(tw.grad.numpy() - want_grad).max()) < 1e-4


def test_pipeline_over_a_stage_mesh_and_stage_lists():
    w, xs = _inputs()
    want_out, want_grad = _ref(jnp.asarray(w), jnp.asarray(xs))
    devs = np.empty(4, dtype=object)
    devs[:] = [torch.device("cpu")] * 4
    layers = [torch.from_numpy(w[i].copy()).requires_grad_(True) for i in range(L)]
    out = pipeline_forward(stage_fn, split_stages(layers, 4), torch.from_numpy(xs),
                           Mesh(devs, ("stage",)))
    assert float(np.abs(out.detach().numpy() - want_out).max()) < 1e-5
    (out ** 2).sum().backward()
    grad = np.stack([t.grad.numpy() for t in layers])
    assert float(np.abs(grad - want_grad).max()) < 1e-4


def test_single_stage_matches_the_reference_pipeline():
    w, xs = _inputs()
    mesh = make_mesh((1,), ("stage",), axis_types=auto_axis_types(1))

    def jstage(params, x):
        return jax.lax.scan(lambda x, wi: (jnp.tanh(x @ wi), None), x, params)[0]

    want = np.asarray(jpipeline_forward(jstage, jsplit_stages(jnp.asarray(w), 1),
                                        jnp.asarray(xs), mesh))
    got = pipeline_forward(stage_fn, split_stages(torch.from_numpy(w), 1),
                           torch.from_numpy(xs), ["cpu"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_split_stages_shape_and_refusal():
    s = split_stages(torch.zeros(8, 4, 4), 4)
    assert s.shape == jsplit_stages(jnp.zeros((8, 4, 4)), 4).shape == (4, 2, 4, 4)
    tree = split_stages({"a": torch.zeros(6, 2), "b": {"c": torch.zeros(6)}}, 3)
    assert tree["a"].shape == (3, 2, 2) and tree["b"]["c"].shape == (3, 2)
    assert [len(g) for g in split_stages(list(range(8)), 2)] == [4, 4]
    for bad in (torch.zeros(7, 4), list(range(7))):
        with pytest.raises(ValueError):
            split_stages(bad, 4)
    with pytest.raises(ValueError):
        jsplit_stages(jnp.zeros((7, 4)), 4)
    with pytest.raises(ValueError):
        pipeline_forward(stage_fn, [[torch.eye(4)]] * 3, torch.zeros(2, 1, 4), ["cpu"] * 4)


def test_hand_offs_are_copies_on_a_shared_device():
    """Each activation reaching a stage is a new buffer, never the tensor
    the stage before it returned (``ppermute`` is a copy)."""
    ins, outs = [], []

    def stage(params, x):
        ins.append(x)
        outs.append(x * params)
        return outs[-1]

    out = pipeline_forward(stage, [torch.tensor(2.0)] * 3, torch.ones(3, 2, 2), ["cpu"] * 3)
    assert torch.equal(out, torch.full((3, 2, 2), 8.0))
    assert len(ins) == 9
    made = {t.data_ptr() for t in outs}
    assert not any(x.data_ptr() in made for x in ins)
