"""Port vs reference: the audio family (``repro_torch.models.whisper``), its
config copy, its training (loss, gradients, AdamW and checkpoints with the
two stacks ``enc`` and ``dec`` in the reference's layout), serving with
``frames`` extras, and the CLIs; and the layouts of the other families'
moments and checkpoints, which the generalised stacks must leave as they
were.

Weights come from the reference's ``model.init(PRNGKey(0))`` and are
carried into the port by ``params_from_numpy``; frames, tokens and
gradients are made with numpy from a seed. Tolerances as
``tests/test_torch_transformer.py``: float32 ``rtol = atol = 1e-4`` (the
same float32 arithmetic in another summation order), bf16 ``5e-2``; a
gradient within 1e-4 of its tensor's largest magnitude and ``rtol =
1e-4``; AdamW and checkpoints as ``tests/test_torch_recurrent_train.py``
(int8 codes within one step).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import get_model as jget_model
from repro.models import whisper as JW
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.train import checkpoint as JCK
from repro.train import loss as JL
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import common as TC
from repro_torch.models import get_model
from repro_torch.models import whisper as TW
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import checkpoint as TCK
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS
from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ARCH = "whisper-large-v3"
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)


def close(got, want, tol=F32):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


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


@functools.lru_cache(maxsize=None)
def _reference(changes):
    jcfg = dataclasses.replace(jget_smoke(ARCH), **dict(changes))
    init = jax.jit(jget_model(jcfg).init, static_argnums=1)
    return jcfg, init(jax.random.PRNGKey(0), jcfg)


def pair(**changes):
    """(JAX cfg, port cfg, JAX params, port params) for the smoke config,
    the port's weights carried from the reference's PRNGKey(0)."""
    jcfg, jparams = _reference(tuple(sorted(changes.items())))
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), **changes)
    tparams = TW.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def jmodel(cfg):
    """The reference's ModelDef with forward, prefill and decode_step
    jitted (cfg static)."""
    m = jget_model(cfg)
    return dataclasses.replace(m, **{name: jax.jit(getattr(m, name), static_argnums=2)
                                     for name in ("forward", "prefill", "decode_step")})


def batches(cfg, seed, b, t):
    """The same frames and tokens for both packages: (JAX batch, port
    batch)."""
    rng = np.random.default_rng(seed)
    arrays = {"frames": rng.standard_normal((b, cfg.num_frames, cfg.d_model))
              .astype(np.float32),
              "tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def port_layout(tree):
    """A port tree (``enc``/``dec`` lists of layers) in the reference's
    layout."""
    return TC.stack_tree(tree, TW.STACKS)


# ---------------------------------------------------------------------------
# parameters and positions
# ---------------------------------------------------------------------------

def test_init_params_has_the_reference_tree():
    """The port's own draw: the reference's paths, shapes and float32 dtype
    in its layout (``enc`` and ``dec`` stacked), frozen, the layout
    ``("enc", "dec")``; the reference's scales and norm values."""
    cfg = tconfigs.get_smoke(ARCH)
    params = TW.init_params(torch.Generator().manual_seed(0), cfg)
    assert params.stacked_blocks == ("enc", "dec")
    assert len(params.enc) == cfg.encoder_layers and len(params.dec) == cfg.num_layers
    shapes = jax.eval_shape(lambda k: JW.init_params(k, jget_smoke(ARCH)),
                            jax.random.PRNGKey(0))
    want = {path: (tuple(a.shape), np.dtype(a.dtype))
            for path, a in leaves(shapes).items()}
    got = {path: (tuple(t.shape), np.dtype(str(t.dtype).removeprefix("torch.")))
           for path, t in leaves(port_layout(params.tree())).items()}
    assert got == want
    assert not any(p.requires_grad for p in params.parameters())
    d = cfg.d_model
    assert abs(float(params.dec[0].cross_attn.wq.std()) * d ** 0.5 - 1.0) < 0.2
    assert abs(float(params.embed.std()) / 0.02 - 1.0) < 0.1
    assert torch.equal(params.enc[1].ln2_w, torch.ones(d))
    assert torch.equal(params.dec[1].ln3_b, torch.zeros(d))


@pytest.mark.parametrize("d", [64, 1280, 2])
def test_sinusoid_matches_reference(d):
    """Float32 sinusoids, cast after, length-generic: past Whisper's 448
    text positions up to the encoder's last frame, and per row of a (B, 1)
    decode position. XLA's and PyTorch's float32 ``exp`` differ by an ulp
    in some frequencies, which an angle of p radians turns into p x 2^-23
    at most: within 1e-4 over the 448 text positions, and within 1,499 x
    2^-23 (1.8e-4) over the frames."""
    for top, atol in ((448, 1e-4), (1499, 1499 * 2.0 ** -23)):
        pos = np.array([0, 1, 7, 447, top], np.int32)
        for dtype, tol in ((torch.float32, dict(rtol=1e-4, atol=atol)), (torch.bfloat16, BF16)):
            jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
            got = TW._sinusoid(torch.from_numpy(pos), d, dtype)
            assert got.dtype == dtype and got.shape == (len(pos), d)
            close(got, JW._sinusoid(jnp.asarray(pos), d, jd).astype(jnp.float32), tol)
    got = TW._sinusoid(torch.from_numpy(np.array([[3], [448], [3000]])), d, torch.float32)
    assert got.shape == (3, 1, d) and bool(torch.isfinite(got).all())


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

def test_encode_and_forward_match_reference():
    jcfg, tcfg, jparams, tparams = pair()
    jb, tb = batches(tcfg, 1, 2, 10)
    close(TW.encode(tparams, tb["frames"], tcfg),
          jax.jit(JW.encode, static_argnums=2)(jparams, jb["frames"], jcfg))
    jl, jaux = jmodel(jcfg).forward(jparams, jb, jcfg)
    tl, aux = TW.forward(tparams, tb, tcfg)
    assert tl.dtype == torch.float32 and tl.shape == (2, 10, tcfg.vocab_size)
    assert float(aux) == float(jaux) == 0.0
    close(tl, jl)


def test_prefill_and_ten_decode_steps_match_reference():
    """Prefill's logits and every cache entry (self K/V, cross K/V, pos),
    then ten decode steps on the reference's greedy tokens: logits and
    caches each step."""
    jcfg, tcfg, jparams, tparams = pair()
    jm, tm = jmodel(jcfg), get_model(tcfg)
    jb, tb = batches(tcfg, 2, 3, 7)
    jl, jc = jm.prefill(jparams, jb, jcfg, jm.init_cache(jcfg, 3, 24))
    tl, tc = tm.prefill(tparams, tb, tcfg, tm.init_cache(tcfg, 3, 24, "cpu"))
    assert tl.shape == (3, 1, tcfg.vocab_size)
    close(tl, jl)
    assert set(tc) == set(jc)
    for key in jc:
        assert tuple(tc[key].shape) == tuple(jc[key].shape)
        close(tc[key], jc[key])
    assert tc["cross_k"].shape == (tcfg.num_layers, 3, tcfg.num_frames, 4, 16)
    assert tc["pos"].tolist() == [7, 7, 7]
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for _ in range(10):
        jl, jc = jm.decode_step(jparams, jnp.asarray(tok), jcfg, jc)
        tl, tc = tm.decode_step(tparams, torch.from_numpy(tok), tcfg, tc)
        assert tl.shape == (3, 1, tcfg.vocab_size)
        close(tl, jl)
        for key in jc:
            close(tc[key], jc[key])
        tok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(np.int32)
    assert tc["pos"].tolist() == [17, 17, 17]


def test_prefill_then_decode_reproduces_forward():
    """Teacher forcing through the caches: prefill of 9 tokens and decode
    of the next three give ``forward``'s logits at those positions."""
    _, cfg, _, params = pair()
    _, batch = batches(cfg, 3, 2, 12)
    full, _ = TW.forward(params, batch, cfg)
    lg, cache = TW.prefill(params, {**batch, "tokens": batch["tokens"][:, :9]}, cfg,
                           TW.init_cache(cfg, 2, 16, "cpu"))
    close(lg[:, -1], full[:, 8], dict(rtol=1e-3, atol=1e-3))
    for i in (9, 10, 11):
        lg, cache = TW.decode_step(params, batch["tokens"][:, i:i + 1], cfg, cache)
        close(lg[:, 0], full[:, i], dict(rtol=1e-3, atol=1e-3))


def test_bfloat16_forward_prefill_decode_match_reference():
    jcfg, tcfg, jparams, tparams = pair(dtype="bfloat16")
    jm, tm = jmodel(jcfg), get_model(tcfg)
    jb, tb = batches(tcfg, 4, 2, 9)
    jl, _ = jm.forward(jparams, jb, jcfg)
    tl, _ = tm.forward(tparams, tb, tcfg)
    assert tl.dtype == torch.float32
    close(tl, jl, BF16)
    jl, jc = jm.prefill(jparams, jb, jcfg, jm.init_cache(jcfg, 2, 16))
    tl, tc = tm.prefill(tparams, tb, tcfg, tm.init_cache(tcfg, 2, 16, "cpu"))
    assert tc["k"].dtype == tc["cross_k"].dtype == torch.bfloat16
    close(tl, jl, BF16)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jl, _ = jm.decode_step(jparams, jnp.asarray(tok), jcfg, jc)
    tl, _ = tm.decode_step(tparams, torch.from_numpy(tok), tcfg, tc)
    close(tl, jl, BF16)


def test_serving_tree_gives_the_float32_trees_logits_in_bf16():
    """``serving=True`` holds every matrix in bf16 (norms float32): the
    same logits, bit for bit, as the float32 tree cast at each use."""
    _, cfg, jparams, _ = pair(dtype="bfloat16")
    np_tree = jax.tree.map(np.asarray, jparams)
    full = TW.params_from_numpy(np_tree, cfg, "cpu")
    held = TW.params_from_numpy(np_tree, cfg, "cpu", serving=True)
    assert held.dec[0].self_attn.wq.dtype == torch.bfloat16
    assert held.ln_enc_w.dtype == held.enc[0].ln1_w.dtype == torch.float32
    _, tb = batches(cfg, 5, 2, 6)
    with torch.no_grad():
        assert torch.equal(TW.forward(full, tb, cfg)[0], TW.forward(held, tb, cfg)[0])


# ---------------------------------------------------------------------------
# training: loss, gradients, remat, AdamW, checkpoints
# ---------------------------------------------------------------------------

def jax_loss_fn(model, cfg, tcfg):
    def loss_fn(params, batch):
        logits, _ = model.forward(params, batch, cfg)
        labels, mask = JL.make_labels(batch, cfg)
        loss, metrics = JL.cross_entropy(logits, labels, mask, tcfg.z_loss)
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def test_gradients_match_jax_value_and_grad():
    """The loss's metrics within 1e-4 and every gradient (``enc``/``dec``
    stacked, the tied embedding's from the lookup and the head) against
    ``jax.value_and_grad`` of the reference's loss."""
    jcfg, tcfg, jparams, tparams = pair()
    jb, tb = batches(tcfg, 6, 2, 11)
    (_, jmet), jgrads = jax.jit(jax.value_and_grad(
        jax_loss_fn(jget_model(jcfg), jcfg, JS.TrainConfig()), has_aux=True))(jparams, jb)
    tmet, tgrads = TS.make_grad_fn(get_model(tcfg), tcfg, TS.TrainConfig())(tparams, tb)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **F32)
    want = leaves(jax.tree.map(np.asarray, jgrads))
    got = leaves(port_layout(tgrads))
    assert set(got) == set(want) and ("enc", "attn", "wq") in got
    for path, g in got.items():
        close_grad(g, want[path])


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_train_step_matches_reference_step(moments):
    """One ``make_train_step`` step in each package: loss and every metric,
    and the gradients the step used, read from the first moments (m = (1 -
    b1) g after one step; int8 codes within one step of their block's
    scale), in the reference's ``enc``/``dec`` layout."""
    jcfg, tcfg, jparams, tparams = pair()
    ocfg = dict(learning_rate=1e-3, warmup_steps=2, grad_clip=0.0)
    jt = JS.TrainConfig(optimizer=JO.AdamWConfig(**ocfg))
    tt = TS.TrainConfig(optimizer=TO.AdamWConfig(**ocfg, moment_dtype=moments))
    jb, tb = batches(tcfg, 7, 2, 9)
    _, jstate, jmet = jax.jit(JS.make_train_step(jget_model(jcfg), jcfg, jt))(
        jparams, JO.adamw_init(jparams, jt.optimizer), jb)
    tparams, tstate, tmet = TS.make_train_step(get_model(tcfg), tcfg, tt)(
        tparams, TO.adamw_init(tparams, tt.optimizer), tb)
    assert set(tmet) == set(jmet)
    for k in jmet:
        close(tmet[k], jmet[k])
    assert int(tstate["step"]) == 1
    got = leaves(tstate["m"])
    want_m = leaves(jstate["m"])
    assert ("dec", "cross_attn", "wv") in want_m
    for path, want in want_m.items():
        if moments == "int8":
            shape = tuple(want.shape)
            m = TO._dequantize(TC.get_path(tstate["m"], path), shape, int(np.prod(shape)))
            step = float(got[(*path, "scale")].max())
            np.testing.assert_allclose(m.numpy(), np.asarray(want), atol=step * 1.001, rtol=0)
        else:
            close_grad(got[path], want)


def test_remat_changes_no_gradient():
    """``cfg.remat`` recomputes each encoder and decoder layer in the
    backward pass: the same loss and gradients as without it."""
    _, cfg, _, params = pair()
    _, batch = batches(cfg, 8, 2, 8)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        _, grads = TS.make_grad_fn(get_model(c), c, TS.TrainConfig())(params, batch)
        out.append(TC.tree_leaves(grads))
    for a, b in zip(*out, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


jadamw_update = jax.jit(JO.adamw_update, static_argnums=3)


def shared_grads(jparams, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
                        jparams)


def port_grads(np_tree, cfg):
    """A reference-layout gradient tree as a port tree."""
    return TW.params_from_numpy(np_tree, cfg, "cpu").tree()


def test_adamw_float32_matches_reference():
    """Two updates on the same gradients: the moments in the reference's
    layout (``enc``/``dec`` stacked on a leading layer axis), parameters,
    moments and step."""
    _, tcfg, jparams, tparams = pair()
    kw = dict(learning_rate=1e-2, warmup_steps=2)
    jo, to = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jstate, tstate = JO.adamw_init(jparams, jo), TO.adamw_init(tparams, to)
    assert {p: tuple(v.shape) for p, v in leaves(tstate["m"]).items()} == \
        {p: tuple(v.shape) for p, v in leaves(jstate["m"]).items()}
    assert tstate["m"]["dec"]["cross_attn"]["wq"].shape == (tcfg.num_layers, 64, 64)
    for seed in (4, 5):
        g = shared_grads(jparams, seed)
        jparams, jstate, jmet = jadamw_update(jparams, g, jstate, jo)
        tparams, tstate, tmet = TO.adamw_update(tparams, port_grads(g, tcfg), tstate, to)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"])
    for name in ("m", "v"):
        want = leaves(jstate[name])
        for path, t in leaves(tstate[name]).items():
            np.testing.assert_allclose(t.numpy(), np.asarray(want[path]), rtol=1e-5, atol=1e-9)
    want = leaves(jparams)
    for path, t in leaves(port_layout(tparams.tree())).items():
        np.testing.assert_allclose(t.numpy(), np.asarray(want[path]), rtol=1e-5, atol=1e-6)


def test_adamw_int8_matches_reference():
    """From the reference's int8 state after one update, one more update in
    both packages: parameters, scales within 1e-6 relative, codes within
    one step, in the reference's blocks (a stacked norm vector of 64 takes
    the padded fallback across the layers; a stacked (L, 64, 128) matrix
    is not a multiple of 256 wide either)."""
    _, tcfg, jparams, _ = pair()
    kw = dict(learning_rate=1e-2, warmup_steps=1, moment_dtype="int8")
    jo, to = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jparams, jstate, _ = jadamw_update(jparams, shared_grads(jparams, 6),
                                       JO.adamw_init(jparams, jo), jo)
    tparams = TW.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tstate = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jstate)
    fresh = TO.adamw_init(tparams, to)
    assert {p: tuple(v.shape) for p, v in leaves(fresh["m"]).items()} == \
        {p: tuple(v.shape) for p, v in leaves(jstate["m"]).items()}
    assert fresh["m"]["enc"]["ln1_w"]["q"].shape == (1, 1, 256)
    g = shared_grads(jparams, 7)
    jparams, jstate, _ = jadamw_update(jparams, g, jstate, jo)
    tparams, tstate, _ = TO.adamw_update(tparams, port_grads(g, tcfg), tstate, to)
    want = leaves(jparams)
    for path, t in leaves(port_layout(tparams.tree())).items():
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
def test_checkpoints_cross_load_both_ways(tmp_path, moments):
    """The reference writes, the port reads; the port writes, the reference
    reads: keys ``params/enc/...`` and ``params/dec/...`` stacked, shapes
    and values, params and optimizer state."""
    _, tcfg, jparams, _ = pair()
    jo = JO.AdamWConfig(moment_dtype=moments, warmup_steps=1)
    jparams, jopt, _ = jadamw_update(jparams, shared_grads(jparams, 11),
                                     JO.adamw_init(jparams, jo), jo)
    JCK.save_checkpoint(str(tmp_path / "j"), 3, {"params": jparams, "opt": jopt}, {"seed": 5})
    state, meta = TCK.load_checkpoint(str(tmp_path / "j"), device="cpu")
    assert meta == {"step": 3, "seed": 5}
    params = get_model(tcfg).params_from_numpy(state["params"], tcfg, "cpu")
    assert params.stacked_blocks == ("enc", "dec")
    want = leaves(jparams)
    got = leaves(port_layout(params.tree()))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[path]))
    TCK.save_checkpoint(str(tmp_path / "t"), 4, {"params": params, "opt": state["opt"]})
    with np.load(tmp_path / "t" / "step_00000004.npz") as z:
        assert z["params/enc/attn/wq"].shape == (tcfg.encoder_layers, 64, 64)
        assert z["params/dec/cross_attn/wk"].shape == (tcfg.num_layers, 64, 64)
    jback, jmeta = JCK.load_checkpoint(str(tmp_path / "t"))
    assert jmeta == {"step": 4}
    assert jax.tree.structure(jback["params"]) == jax.tree.structure(jparams)
    assert jax.tree.structure(jback["opt"]) == jax.tree.structure(jopt)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves({"params": jparams, "opt": jopt})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restart_gives_the_same_run(tmp_path):
    """Four steps straight against two, a checkpoint written by the port, a
    reload and two more: the same parameters and moments, bit for bit (the
    batches from ``synth_batch(seed, t)``, frames included)."""
    cfg = tconfigs.get_smoke(ARCH)
    model = get_model(cfg)
    tt = TS.TrainConfig(optimizer=TO.AdamWConfig(learning_rate=1e-3, warmup_steps=2))
    step = TS.make_train_step(model, cfg, tt)

    def run(params, opt, steps):
        for t in steps:
            params, opt, _ = step(params, opt, train_cli.synth_batch(3, t, cfg, 2, 6, "cpu"))
        return params, opt

    straight = run(*TS.init_train_state(model, cfg, tt, torch.Generator().manual_seed(1)),
                   range(4))
    half = run(*TS.init_train_state(model, cfg, tt, torch.Generator().manual_seed(1)),
               range(2))
    TCK.save_checkpoint(str(tmp_path), 2, {"params": half[0], "opt": half[1]})
    state, meta = TCK.load_checkpoint(str(tmp_path), device="cpu")
    params = model.params_from_numpy(state["params"], cfg, "cpu")
    resumed = run(params, state["opt"], range(meta["step"], 4))
    for a, b in zip(straight[0].parameters(), resumed[0].parameters(), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(TC.tree_leaves(straight[1]), TC.tree_leaves(resumed[1]), strict=True):
        assert torch.equal(a, b)


def test_synth_batch_draws_frames():
    cfg = tconfigs.get_smoke(ARCH)
    a = train_cli.synth_batch(0, 5, cfg, 2, 8, "cpu")
    b = train_cli.synth_batch(0, 5, cfg, 2, 8, "cpu")
    c = train_cli.synth_batch(0, 6, cfg, 2, 8, "cpu")
    assert set(a) == {"tokens", "frames"}
    assert a["frames"].shape == (2, cfg.num_frames, cfg.d_model)
    assert a["frames"].dtype == torch.float32
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["frames"], c["frames"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _serve(prompts, frames, slots, packages=("port", "jax")):
    jcfg, tcfg, jparams, tparams = pair()
    engines = {"port": (ServeEngine, ServeConfig, get_model(tcfg), tcfg, tparams),
               "jax": (JServeEngine, JServeConfig, jget_model(jcfg), jcfg, jparams)}
    out = []
    for name in packages:
        engine, config, model, cfg, params = engines[name]
        eng = engine(model, cfg, params, config(max_seq=32, batch_slots=slots,
                                                max_new_tokens=6))
        rids = [eng.submit(p, {"frames": f}) for p, f in zip(prompts, frames)]
        res = eng.run()
        out.append([res[r] for r in rids])
    return out


def test_serving_with_frames_matches_reference():
    """Five requests, each with its own frames, in waves of 2 (the last
    wave of one): the port's tokens equal the reference engine's, and
    each equals the request served alone."""
    rng = np.random.default_rng(13)
    prompts = rng.integers(0, 256, (5, 6))
    frames = rng.standard_normal((5, 16, 64)).astype(np.float32)
    port_out, jax_out = _serve(prompts, frames, 2)
    assert port_out == jax_out
    assert all(len(t) == 6 for t in port_out)
    solo = [_serve([p], [f], 1, ("port",))[0][0] for p, f in zip(prompts[:2], frames[:2])]
    assert port_out[:2] == solo


def test_ragged_wave_with_frames_matches_reference():
    """Prompts of 6, 3 and 2 tokens in one wave. As in the reference, the
    decode attends to the pads after each shorter prompt (``pos`` is the
    padded length). Pinned: port == reference, first tokens == solo."""
    rng = np.random.default_rng(14)
    prompts = [np.arange(1, 7), np.array([7, 8, 9]), np.array([4, 5])]
    frames = rng.standard_normal((3, 16, 64)).astype(np.float32)
    port_out, jax_out = _serve(prompts, frames, 4)
    assert port_out == jax_out
    solo = [_serve([p], [f], 1, ("port",))[0][0] for p, f in zip(prompts, frames)]
    assert port_out[0] == solo[0]
    assert all(p[0] == s[0] for p, s in zip(port_out, solo))


def test_serve_and_train_clis_run_whisper_on_cpu(tmp_path, capsys):
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                    "--prompt-len", "5", "--new-tokens", "3", "--slots", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens in" in out and "tok/s" in out
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
            "--seq", "8", "--log-every", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    train_cli.main(args)
    out = capsys.readouterr().out
    assert "step     4 loss" in out and "done: 4 steps" in out
    assert TCK.latest_step(str(tmp_path)) == 4
    with np.load(tmp_path / "step_00000004.npz") as z:
        assert z["params/dec/mlp/w_up"].shape == (2, 64, 128)


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.params_from_numpy({}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", ARCH, "--smoke"])
    assert TW.init_cache(cfg, 2, 8, "cpu")["cross_k"].shape == (2, 2, 16, 4, 16)


# ---------------------------------------------------------------------------
# the config, and the other families' layouts
# ---------------------------------------------------------------------------

def test_config_copy_equals_reference():
    for get_t, get_j in ((tconfigs.get_config, jget_config),
                         (tconfigs.get_smoke, jget_smoke)):
        t, j = get_t(ARCH), get_j(ARCH)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
    # the reference's formula counts the tied head twice and no norm or bias
    assert tconfigs.get_config(ARCH).param_count() == 1_600_783_360
    assert get_model(tconfigs.get_smoke(ARCH)).prefill is TW.prefill


@pytest.mark.parametrize("arch", ["minicpm-2b", "rwkv6-7b", "recurrentgemma-2b"])
@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_other_families_keep_their_moment_and_checkpoint_layouts(arch, moments, tmp_path):
    """The generalised stacks leave the other families as they were: the
    layout flag (True for ``blocks`` stacked, False for recurrentgemma's
    list) and its tuple form group the leaves alike, and the port's
    moments and checkpoint keys have the reference's paths and shapes."""
    cfg, jcfg = tconfigs.get_smoke(arch), jget_smoke(arch)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    stacked = params.stacked_blocks
    assert stacked is (arch != "recurrentgemma-2b")
    tree = params.tree()
    assert TC.leaf_groups(tree, stacked) == TC.leaf_groups(tree, TC.stack_keys(stacked))
    jparams = jax.eval_shape(lambda k: jget_model(jcfg).init(k, jcfg), jax.random.PRNGKey(0))
    jo, to = JO.AdamWConfig(moment_dtype=moments), TO.AdamWConfig(moment_dtype=moments)
    jstate = jax.eval_shape(lambda p: JO.adamw_init(p, jo), jparams)
    tstate = TO.adamw_init(params, to)
    for name in ("m", "v"):
        assert {p: tuple(v.shape) for p, v in leaves(tstate[name]).items()} == \
            {p: tuple(v.shape) for p, v in leaves(jstate[name]).items()}
    TCK.save_checkpoint(str(tmp_path), 1, {"params": params, "opt": tstate})
    with np.load(tmp_path / "step_00000001.npz") as z:
        got = {k: z[k].shape for k in z.files if k != "__meta__"}
    want = {"/".join(map(str, ("params", *p))): tuple(a.shape)
            for p, a in leaves(jparams).items()}
    want.update({"/".join(map(str, ("opt", *p))): tuple(a.shape)
                 for p, a in leaves(jstate).items()})
    assert got == want
