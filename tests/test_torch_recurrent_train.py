"""Port vs reference: training the two recurrent families (RWKV-6 and
recurrentgemma): the recurrences' autograd Functions (``kernels/ops.py``
``WKV6Fn``, ``RGLRUScanFn``) and their plain backward versions
(``kernels/ref.py::wkv6_bwd_ref``, ``rg_lru_scan_bwd_ref``), the models'
gradients, AdamW and checkpoints in recurrentgemma's list layout, remat in
RWKV-6, and the training CLI for both families.

The Functions' CPU gradients are held to ``jax.vjp`` of the reference's
plain recurrences (``repro.kernels.ref.wkv6_ref``; the ``lax.scan`` of
``h = a h + g`` at ``repro/models/recurrentgemma.py:124-130``), and the
plain backward versions to torch autograd of the plain forwards. Inputs
are made with numpy from a seed. Tolerances: a recurrence's gradient
within ``1e-5`` of its tensor's largest magnitude (float32 sums in another
order; a gradient's small entries are sums of terms that cancel); a
model's gradient within ``1e-4`` of it and ``rtol = 1e-4`` (as
``tests/test_torch_train.py``); AdamW and checkpoints as there (int8 codes
within one step). The kernels themselves run on the card only
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phases 22-26).
"""
import dataclasses
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.kernels import ref as jref
from repro.models import get_model as jget_model
from repro.train import checkpoint as JCK
from repro.train import loss as JL
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rg_lru as krg
from repro_torch.kernels import wkv6 as kwkv
from repro_torch.launch import train as train_cli
from repro_torch.models import common as TC
from repro_torch.models import get_model
from repro_torch.train import checkpoint as TCK
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS
from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ARCHS = ("rwkv6-7b", "recurrentgemma-2b")
F32 = dict(rtol=1e-4, atol=1e-4)


def rel_close(got, want, rel):
    """Every element of ``got`` within ``rel`` of ``want``'s largest magnitude."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max(initial=0.0)), 1e-30))


def close_grad(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * max(float(np.abs(want).max()), 1e-30))


def leaves(tree, path=()):
    """{path: leaf} of a nested dict/list tree (lists indexed by ints)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(leaves(v, (*path, k)))
    return out


# ---------------------------------------------------------------------------
# the recurrences' gradients
# ---------------------------------------------------------------------------

def wkv_inputs(seed, b, t, h, dk, dv, resets=()):
    """float32 numpy (r, k, v, w, u, s0, dout, dsT); w = sigmoid(normal),
    0 at the (step, head, row) triples of ``resets`` (every batch row)."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    r, k, v = n(b, t, h, dk), n(b, t, h, dk), n(b, t, h, dv)
    w = (1.0 / (1.0 + np.exp(-n(b, t, h, dk)))).astype(np.float32)
    for step, head, row in resets:
        w[:, step, head, row] = 0.0
    return r, k, v, w, n(h, dk), n(b, h, dk, dv), n(b, t, h, dv), n(b, h, dk, dv)


def wkv_jax_grads(arrays):
    """jax.vjp of the reference's ``wkv6_ref`` at (r, k, v, w, u, s0),
    pulled back from (dout, dsT)."""
    _, vjp = jax.vjp(jref.wkv6_ref, *map(jnp.asarray, arrays[:6]))
    return [np.asarray(g) for g in vjp((jnp.asarray(arrays[6]), jnp.asarray(arrays[7])))]


def wkv_fn_grads(arrays, dtype=torch.float32):
    """The port's ``ops.wkv6`` (``WKV6Fn`` on CPU tensors) differentiated by
    torch autograd from (dout, dsT); r, k, v in ``dtype``."""
    xs = [torch.tensor(a, requires_grad=True) for a in arrays[:6]]
    ins = [x.to(dtype) if i < 3 else x for i, x in enumerate(xs)]
    out, s = tops.wkv6(*ins)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("WKV6Fn")
    return torch.autograd.grad((out, s), xs, (torch.from_numpy(arrays[6]).to(out.dtype),
                                              torch.from_numpy(arrays[7])))


WKV_SHAPES = [(2, 67, 3, 8, 8), (1, 33, 2, 5, 7), (2, 1, 1, 4, 4), (1, 0, 2, 4, 4),
              (2, 20, 2, 16, 16)]


@pytest.mark.parametrize("b,t,h,dk,dv", WKV_SHAPES)
def test_wkv6_fn_gradients_match_jax_vjp(b, t, h, dk, dv):
    """Every gradient (r, k, v, w, u, the initial state) within 1e-5 of its
    tensor's largest magnitude, at ragged T with an incoming dsT, and with
    rows reset (w == 0) at a few steps."""
    resets = [(s, s % h, s % dk) for s in range(0, t, 5)]
    arrays = wkv_inputs(1, b, t, h, dk, dv, resets)
    for got, want in zip(wkv_fn_grads(arrays), wkv_jax_grads(arrays)):
        rel_close(got, want, 1e-5)


def test_wkv6_reset_passes_nothing_to_the_earlier_state():
    """At w == 0 the reference's select gives dw = 0 (the state is finite)
    and no gradient to the state before the step: with dout = 0 and every
    row of the last step reset, the initial state's gradient is exactly 0,
    as ``jax.vjp`` gives; at a reset row in the middle, dw is exactly 0."""
    b, t, h, dk, dv = 2, 6, 2, 4, 3
    arrays = list(wkv_inputs(2, b, t, h, dk, dv))
    arrays[3][:, -1] = 0.0
    arrays[6] = np.zeros_like(arrays[6])
    got, want = wkv_fn_grads(arrays), wkv_jax_grads(arrays)
    assert not got[5].any() and not np.any(want[5])
    assert not got[3][:, -1].any() and not np.any(want[3][:, -1])
    arrays = wkv_inputs(3, b, t, h, dk, dv, resets=[(2, 1, 3)])
    got, want = wkv_fn_grads(arrays), wkv_jax_grads(arrays)
    assert float(got[3][:, 2, 1, 3].abs().max()) == 0.0
    assert float(np.abs(want[3][:, 2, 1, 3]).max()) == 0.0
    for g, w in zip(got, want):
        rel_close(g, w, 1e-5)


def test_wkv6_bf16_gradients_come_back_in_bf16():
    """bf16 r, k, v give bf16 gradients for them, each the float32
    gradient (of the widened values) rounded once: within a bf16 step of
    the float32 run; w, u and the state's stay float32."""
    arrays = wkv_inputs(4, 2, 19, 2, 8, 8)
    widened = [torch.from_numpy(a).to(torch.bfloat16).float().numpy() if i in (0, 1, 2, 6)
               else a for i, a in enumerate(arrays)]
    got = wkv_fn_grads(arrays, torch.bfloat16)
    want = wkv_fn_grads(widened)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32          # autograd casts back to the leaf's dtype
        rel_close(g, w.numpy(), 1e-2 if i < 3 else 1e-5)
    r, k, v, w_, u, s0, dout, dst = (torch.from_numpy(a) for a in widened)
    dr, dk, dv, dw, du, ds0 = tref.wkv6_bwd_ref(r.bfloat16(), k.bfloat16(), v.bfloat16(), w_,
                                                u, s0, dout.bfloat16(), dst)
    assert (dr.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert (dw.dtype, du.dtype, ds0.dtype) == (torch.float32,) * 3


@pytest.mark.parametrize("b,t,h,dk,dv", [(2, 13, 2, 4, 5), (1, 1, 1, 3, 3), (2, 0, 1, 2, 2)])
def test_wkv6_plain_backward_matches_autograd_of_the_plain_forward(b, t, h, dk, dv):
    arrays = wkv_inputs(5, b, t, h, dk, dv, resets=[(0, 0, 1)] if t else ())
    xs = [torch.tensor(a, requires_grad=True) for a in arrays[:6]]
    outs = [(o, torch.from_numpy(d)) for o, d in zip(tref.wkv6_ref(*xs), arrays[6:])
            if o.requires_grad]                   # T = 0: out is empty, made by no op
    outputs, cotangents = zip(*outs)
    want = torch.autograd.grad(outputs, xs, cotangents, allow_unused=True)
    got = tref.wkv6_bwd_ref(*map(torch.from_numpy, arrays))
    for g, w, x in zip(got, want, xs):
        rel_close(g, (torch.zeros_like(x) if w is None else w).numpy(), 1e-5)


def rg_inputs(seed, b, t, r):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, (b, t, r)).astype(np.float32)
    g, h0 = (rng.standard_normal(s).astype(np.float32) for s in ((b, t, r), (b, r)))
    dy, dht = (rng.standard_normal(s).astype(np.float32) for s in ((b, t, r), (b, r)))
    return a, g, h0, dy, dht


def _jax_scan(a, g, h0):
    """The reference's scan ``h = a h + g`` (``recurrentgemma.py:124-130``)."""
    def step(h, xs):
        a_t, g_t = xs
        h = a_t * h + g_t
        return h, h

    h_t, ys = jax.lax.scan(step, h0, (jnp.moveaxis(a, 1, 0), jnp.moveaxis(g, 1, 0)))
    return jnp.moveaxis(ys, 0, 1), h_t


@pytest.mark.parametrize("b,t,r", [(2, 67, 5), (3, 1, 4), (2, 0, 3), (1, 40, 16)])
def test_rg_lru_fn_gradients_match_jax_vjp(b, t, r):
    a, g, h0, dy, dht = rg_inputs(6, b, t, r)
    _, vjp = jax.vjp(_jax_scan, *map(jnp.asarray, (a, g, h0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dht)))
    xs = [torch.tensor(x, requires_grad=True) for x in (a, g, h0)]
    y, h_t = tops.rg_lru_scan(*xs)
    assert type(y.grad_fn).__name__.startswith("RGLRUScanFn")
    got = torch.autograd.grad((y, h_t), xs, (torch.from_numpy(dy), torch.from_numpy(dht)))
    for x, w in zip(got, want):
        rel_close(x, w, 1e-5)


@pytest.mark.parametrize("b,t,r", [(2, 23, 5), (1, 1, 3), (2, 0, 2)])
def test_rg_lru_plain_backward_is_autograd_of_the_plain_forward(b, t, r):
    """The plain backward against torch autograd of ``rg_lru_scan_ref``:
    the same multiplies and adds, so the same bits."""
    a, g, h0, dy, dht = rg_inputs(7, b, t, r)
    xs = [torch.tensor(x, requires_grad=True) for x in (a, g, h0)]
    y, h_t = tref.rg_lru_scan_ref(*xs)
    outputs, cotangents = zip(*((o, torch.from_numpy(d)) for o, d in ((y, dy), (h_t, dht))
                                if o.requires_grad))   # T = 0: y is empty, made by no op
    want = torch.autograd.grad(outputs, xs, cotangents, allow_unused=True)
    got = tref.rg_lru_scan_bwd_ref(xs[0].detach(), y.detach(), xs[2].detach(),
                                   torch.from_numpy(dy), torch.from_numpy(dht))
    for x, w, leaf in zip(got, want, xs):
        assert torch.equal(x, torch.zeros_like(leaf) if w is None else w)


def test_functions_take_the_plain_versions_on_the_cpu_and_refuse_the_kernel():
    """On CPU tensors the Functions run the plain forward and backward and
    launch nothing; ``mode="cuda"`` on them raises, as do the kernel
    wrappers; without grad no Function is made."""
    arrays = wkv_inputs(8, 1, 3, 1, 2, 2)
    before = (kwkv.wkv6.launches, kwkv.wkv6_bwd.launches, krg.rg_lru_scan.launches,
              krg.rg_lru_scan_bwd.launches)
    wkv_fn_grads(arrays)
    a, g, h0, dy, dht = (torch.from_numpy(x) for x in rg_inputs(9, 1, 3, 2))
    y, _ = tops.rg_lru_scan(a.requires_grad_(True), g, h0)
    y.sum().backward()
    assert (kwkv.wkv6.launches, kwkv.wkv6_bwd.launches, krg.rg_lru_scan.launches,
            krg.rg_lru_scan_bwd.launches) == before
    xs = [torch.from_numpy(x) for x in arrays[:6]]
    xs[0].requires_grad_(True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.wkv6(*xs, mode="cuda")
    with pytest.raises(ValueError, match="one CUDA device"):
        kwkv.wkv6_bwd(*(torch.from_numpy(x) for x in arrays))
    with pytest.raises(ValueError, match="one CUDA device"):
        krg.rg_lru_scan_bwd(a.detach(), y.detach(), h0, dy, dht)
    with torch.no_grad():
        out, _ = tops.wkv6(*xs)
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference(arch):
    jcfg = jget_smoke(arch)
    return jcfg, jax.jit(jget_model(jcfg).init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)


def pair(arch):
    jcfg, jparams = _reference(arch)
    tcfg = get_smoke(arch)
    return jcfg, tcfg, jparams, get_model(tcfg).params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def batches(cfg, seed, b, t):
    arr = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    return {"tokens": jnp.asarray(arr)}, {"tokens": torch.from_numpy(arr)}


def jax_loss_fn(model, cfg, tcfg):
    def loss_fn(params, batch):
        logits, _ = model.forward(params, batch, cfg)
        labels, mask = JL.make_labels(batch, cfg)
        loss, metrics = JL.cross_entropy(logits, labels, mask, tcfg.z_loss)
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def port_layout(tree, params):
    """A port gradient tree in the reference's layout."""
    return TC.stack_tree(tree, params.stacked_blocks)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_value_and_grad(arch):
    """The port's ``make_grad_fn`` (the Functions' plain backward versions
    on the CPU) against ``jax.value_and_grad`` of the reference's loss:
    metrics within 1e-4, every gradient within 1e-4 of its tensor's largest
    magnitude, the reference's tree layout (recurrentgemma's blocks a
    list)."""
    jcfg, tcfg, jparams, tparams = pair(arch)
    jb, tb = batches(tcfg, 8, 2, 21)
    (_, jmet), jgrads = jax.jit(jax.value_and_grad(
        jax_loss_fn(jget_model(jcfg), jcfg, JS.TrainConfig()), has_aux=True))(jparams, jb)
    tmet, tgrads = TS.make_grad_fn(get_model(tcfg), tcfg, TS.TrainConfig())(tparams, tb)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **F32)
    want = leaves(jax.tree.map(np.asarray, jgrads))
    got = leaves(port_layout(tgrads, tparams))
    assert set(got) == set(want)
    for path, g in got.items():
        close_grad(g, want[path])


def test_rwkv6_remat_gives_equal_gradients():
    """Checkpointing each layer changes no bit of the gradients, and runs
    each layer's recurrence forward twice and backward once."""
    cfg = get_smoke("rwkv6-7b")
    model = get_model(cfg)
    _, tb = batches(cfg, 9, 2, 12)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tref.wkv6_ref, tref.wkv6_bwd_ref

    def counted(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run

    grads = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        params = model.init(torch.Generator().manual_seed(3), c)
        calls.update(fwd=0, bwd=0)
        tref.wkv6_ref, tref.wkv6_bwd_ref = counted("fwd", fwd), counted("bwd", bwd)
        try:
            _, grads[remat] = TS.make_grad_fn(model, c, TS.TrainConfig())(params, tb)
        finally:
            tref.wkv6_ref, tref.wkv6_bwd_ref = fwd, bwd
        n = cfg.num_layers
        assert calls == {"fwd": n * (2 if remat else 1), "bwd": n}
    for a, b in zip(TC.tree_leaves(grads[False]), TC.tree_leaves(grads[True])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_steps_gradients_die_with_their_last_reference(arch):
    """With the garbage collector off, the gradients of a step are freed as
    soon as the caller drops them, after AdamW and the checkpoint layout
    have walked them: no tree walk leaves a reference cycle behind (one
    would hold a whole model's gradients, device memory on the card, until
    a collection ran)."""
    cfg = get_smoke(arch)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(4), cfg)
    _, tb = batches(cfg, 11, 2, 8)
    ocfg = TO.AdamWConfig()
    opt = TO.adamw_init(params, ocfg)
    gc.collect()
    gc.disable()
    try:
        _, grads = TS.make_grad_fn(model, cfg, TS.TrainConfig())(params, tb)
        alive = [weakref.ref(g) for g in TC.tree_leaves(grads)]
        TO.adamw_update(params, grads, opt, ocfg)
        TC.stack_tree(grads, params.stacked_blocks)
        del grads
        assert not [r for r in alive if r() is not None]
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# AdamW and checkpoints in recurrentgemma's list layout
# ---------------------------------------------------------------------------

jadamw_update = jax.jit(JO.adamw_update, static_argnums=3)


def shared_grads(jparams, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
                        jparams)


def port_grads(np_tree, params):
    """A reference-layout gradient tree as the port's tree of ``params``."""
    return TC.params_from_numpy(np_tree, len(params.blocks), "cpu",
                                stacked=params.stacked_blocks).tree()


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_float32_matches_reference(arch):
    """Two updates on the same gradients: the moments' layout (a list of
    layers for recurrentgemma, stacked for RWKV-6), parameters, moments
    and step."""
    _, tcfg, jparams, tparams = pair(arch)
    kw = dict(learning_rate=1e-2, warmup_steps=2)
    jo, to = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jstate, tstate = JO.adamw_init(jparams, jo), TO.adamw_init(tparams, to)
    assert isinstance(tstate["m"]["blocks"], list) == isinstance(jstate["m"]["blocks"], list)
    assert {p: tuple(v.shape) for p, v in leaves(tstate["m"]).items()} == \
        {p: tuple(v.shape) for p, v in leaves(jstate["m"]).items()}
    for seed in (4, 5):
        g = shared_grads(jparams, seed)
        jparams, jstate, jmet = jadamw_update(jparams, g, jstate, jo)
        tparams, tstate, tmet = TO.adamw_update(tparams, port_grads(g, tparams), tstate, to)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"])
    for name in ("m", "v"):
        want = leaves(jstate[name])
        for path, t in leaves(tstate[name]).items():
            np.testing.assert_allclose(t.numpy(), np.asarray(want[path]), rtol=1e-5, atol=1e-9)
    want = leaves(jparams)
    for path, t in leaves(port_layout(tparams.tree(), tparams)).items():
        np.testing.assert_allclose(t.numpy(), np.asarray(want[path]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_int8_matches_reference(arch):
    """From the reference's int8 state after one update, one more update in
    both packages: parameters, scales within 1e-6 relative, codes within
    one step (recurrentgemma's blocks of moments a list of layers)."""
    _, tcfg, jparams, _ = pair(arch)
    kw = dict(learning_rate=1e-2, warmup_steps=1, moment_dtype="int8")
    jo, to = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jparams, jstate, _ = jadamw_update(jparams, shared_grads(jparams, 6),
                                       JO.adamw_init(jparams, jo), jo)
    tparams = get_model(tcfg).params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tstate = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jstate)
    assert {p: tuple(v.shape) for p, v in leaves(TO.adamw_init(tparams, to)["m"]).items()} == \
        {p: tuple(v.shape) for p, v in leaves(jstate["m"]).items()}
    g = shared_grads(jparams, 7)
    jparams, jstate, _ = jadamw_update(jparams, g, jstate, jo)
    tparams, tstate, _ = TO.adamw_update(tparams, port_grads(g, tparams), tstate, to)
    want = leaves(jparams)
    for path, t in leaves(port_layout(tparams.tree(), tparams)).items():
        np.testing.assert_allclose(t.numpy(), np.asarray(want[path]), rtol=1e-5, atol=1e-6)
    for name in ("m", "v"):
        want, got = leaves(jstate[name]), leaves(tstate[name])
        assert set(got) == set(want)
        for path, t in got.items():
            if path[-1] == "q":
                diff = np.abs(t.numpy().astype(np.int32) - np.asarray(want[path], np.int32))
                assert t.dtype == torch.int8 and diff.max() <= 1 and (diff > 0).mean() < 1e-3
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(want[path]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_recurrentgemma_checkpoints_cross_load_both_ways(tmp_path, moments):
    """The reference writes, the port reads; the port writes, the reference
    reads: keys ``params/blocks/<i>/...``, shapes and values, params and
    optimizer state."""
    _, tcfg, jparams, _ = pair("recurrentgemma-2b")
    jo = JO.AdamWConfig(moment_dtype=moments, warmup_steps=1)
    jparams, jopt, _ = jadamw_update(jparams, shared_grads(jparams, 11),
                                     JO.adamw_init(jparams, jo), jo)
    JCK.save_checkpoint(str(tmp_path / "j"), 3, {"params": jparams, "opt": jopt}, {"seed": 5})
    state, meta = TCK.load_checkpoint(str(tmp_path / "j"), device="cpu")
    assert meta == {"step": 3, "seed": 5}
    assert isinstance(state["params"]["blocks"], list)
    params = get_model(tcfg).params_from_numpy(state["params"], tcfg, "cpu")
    assert params.stacked_blocks is False
    want = leaves(jparams)
    got = leaves(port_layout(params.tree(), params))
    assert set(got) == set(want) and ("blocks", 0, "rec", "w_x") in got
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[path]))
    # the port writes (its ParamTree in the list layout), the reference reads
    TCK.save_checkpoint(str(tmp_path / "t"), 4, {"params": params, "opt": state["opt"]})
    with np.load(tmp_path / "t" / "step_00000004.npz") as z:
        assert "params/blocks/2/attn/wq" in z.files and "opt/m/blocks/0/rec/w_x" in \
            z.files or "opt/m/blocks/0/rec/w_x/q" in z.files
    jback, jmeta = JCK.load_checkpoint(str(tmp_path / "t"))
    assert jmeta == {"step": 4}
    assert jax.tree.structure(jback["params"]) == jax.tree.structure(jparams)
    assert jax.tree.structure(jback["opt"]) == jax.tree.structure(jopt)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves({"params": jparams, "opt": jopt})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_recurrentgemma_port_init_keeps_the_list_layout():
    """A tree the port draws itself is in the list layout too: its
    checkpoint keys, moments and resumed training are the list's."""
    cfg = get_smoke("recurrentgemma-2b")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    assert params.stacked_blocks is False
    opt = TO.adamw_init(params, TO.AdamWConfig())
    assert isinstance(opt["m"]["blocks"], list) and len(opt["m"]["blocks"]) == cfg.num_layers
    assert set(opt["m"]["blocks"][2]) == {"ln_mix", "ln_mlp", "mlp", "attn"}
    # two recurrent layers alone are uniform, and still a list: the family decides
    two = dataclasses.replace(cfg, num_layers=2)
    p2 = model.init(torch.Generator().manual_seed(0), two)
    assert p2.stacked_blocks is False
    assert isinstance(TC.stack_tree(p2.tree(), p2.stacked_blocks)["blocks"], list)


@pytest.mark.parametrize("arch,stacked", [("rwkv6-7b", True), ("recurrentgemma-2b", False),
                                          ("minicpm-2b", True), ("granite-moe-1b-a400m", True)])
def test_params_from_numpy_keeps_the_family_layout(arch, stacked):
    """The blocks' layout is the family's, whatever form the tree comes in:
    the port's own tree (a list of layers) carried over, as the card-vs-CPU
    checks carry it, groups its leaves as the family's init does."""
    cfg = get_smoke(arch)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    copy = model.params_from_numpy(params.tree(), cfg, "cpu")
    assert params.stacked_blocks is stacked and copy.stacked_blocks is stacked
    want = [(p, [t.shape for t in ts]) for p, ts in TC.leaf_groups(params.tree(), stacked)]
    assert [(p, [t.shape for t in ts]) for p, ts in TC.leaf_groups(copy.tree(), stacked)] == want


# ---------------------------------------------------------------------------
# the training CLI and the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_both_families(arch, tmp_path, capsys):
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
            "--seq", "8", "--log-every", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    train_cli.main(args[:6] + ["2"] + args[7:])
    assert TCK.latest_step(str(tmp_path)) == 2
    train_cli.main(args)
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step     4 loss" in out and "done: 2 steps" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_falls_and_the_first_step_is_the_references(arch):
    """Ten ``make_train_step`` steps on one batch: the first loss is the
    reference's on the same weights and batch, and the loss falls."""
    jcfg, tcfg, jparams, tparams = pair(arch)
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=50, schedule="constant")
    jb, tb = batches(tcfg, 10, 4, 16)
    tt = TS.TrainConfig(optimizer=TO.AdamWConfig(**kw))
    step = TS.make_train_step(get_model(tcfg), tcfg, tt)
    opt = TO.adamw_init(tparams, tt.optimizer)
    losses = []
    for _ in range(10):
        tparams, opt, met = step(tparams, opt, tb)
        losses.append(float(met["loss"]))
    jt = JS.TrainConfig(optimizer=JO.AdamWConfig(**kw))
    _, _, jmet = jax.jit(JS.make_train_step(jget_model(jcfg), jcfg, jt))(
        jparams, JO.adamw_init(jparams, jt.optimizer), jb)
    np.testing.assert_allclose(losses[0], float(jmet["loss"]), **F32)
    assert np.isfinite(losses).all() and losses[-1] < losses[0] - 0.5
