"""Port vs reference: the mixture-of-experts layer (``repro_torch.models.moe``)
and the two MoE archs through the transformer (granite-moe-1b-a400m,
moonshot-v1-16b-a3b): capacity, routing and dispatch, the forward pass,
prefill and decode, serving, the train step, and the bf16 serving tree.

Weights come from the reference's ``init(PRNGKey(0))`` (or ``init_moe``),
carried by ``params_from_numpy``; activations, router probabilities and
tokens are made with numpy from a seed. Tolerances: float32 ``rtol = atol =
1e-4`` (``tests/test_torch_models.py``: the same float32 arithmetic in
another summation order); a gradient within ``1e-4`` of its tensor's
largest magnitude (``tests/test_torch_train.py``). Routing (the top
experts, each assignment's token, slot and keep) and the dispatch buffer
are equal exactly: both packages sort the same float32 probabilities. The
bf16 serving tree gives the same bits as rounding at each use.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import get_model as jget_model
from repro.models import moe as JM
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.train import loss as JL
from repro.train import train_step as JS
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import common as TC
from repro_torch.models import get_model
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import train_step as TS
from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

F32 = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b")


def close(got, want, tol=F32):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


def close_grad(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * max(float(np.abs(want).max()), 1e-30))


@functools.lru_cache(maxsize=None)
def _reference(arch, changes):
    jcfg = dataclasses.replace(jget_smoke(arch), **dict(changes))
    return jcfg, jax.jit(jget_model(jcfg).init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)


def pair(arch, **changes):
    """(JAX cfg, port cfg, JAX params, port params) for the smoke config."""
    jcfg, jparams = _reference(arch, tuple(sorted(changes.items())))
    tcfg = dataclasses.replace(get_smoke(arch), **changes)
    return jcfg, tcfg, jparams, TT.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                     tcfg, "cpu")


def jmodel(cfg):
    m = jget_model(cfg)
    return dataclasses.replace(m, **{name: jax.jit(getattr(m, name), static_argnums=2)
                                     for name in ("forward", "prefill", "decode_step")})


def tokens(cfg, seed, b, t):
    arr = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    return {"tokens": jnp.asarray(arr)}, {"tokens": torch.from_numpy(arr)}


def moe_pair(arch, **changes):
    """The reference's ``init_moe`` weights of one layer (numpy) and the
    port's ParamTree of them, for the smoke config."""
    jcfg = dataclasses.replace(jget_smoke(arch), **changes)
    tcfg = dataclasses.replace(get_smoke(arch), **changes)
    jp = jax.tree.map(np.asarray, JM.init_moe(jax.random.PRNGKey(3), jcfg))
    return jcfg, tcfg, jp, TC.ParamTree({k: torch.from_numpy(v.copy()) for k, v in jp.items()})


def probs_of(seed, b, t, e, scale=2.0):
    logits = np.random.default_rng(seed).standard_normal((b, t, e)).astype(np.float32) * scale
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


# ---------------------------------------------------------------------------
# capacity, routing, dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("experts,k", [(4, 1), (4, 2), (8, 2), (32, 8), (64, 6)])
def test_moe_capacity_matches_reference(experts, k):
    for cf in (0.25, 1.0, 1.25, 2.0, 8.0):
        for tokens_ in (1, 2, 7, 16, 100, 512, 2048, 4096):
            jcfg = dataclasses.replace(jget_smoke(ARCHS[0]), num_experts=experts,
                                       experts_per_token=k, capacity_factor=cf)
            tcfg = dataclasses.replace(get_smoke(ARCHS[0]), num_experts=experts,
                                       experts_per_token=k, capacity_factor=cf)
            cap = TM.moe_capacity(tcfg, tokens_)
            assert cap == JM.moe_capacity(jcfg, tokens_)
            assert cap >= 8 and cap % 8 == 0
    assert TM.moe_capacity(get_config("granite-moe-1b-a400m"), 512) == 168
    assert TM.moe_capacity(get_config("moonshot-v1-16b-a3b"), 512) == 64
    for arch in ARCHS:
        assert TM.moe_capacity(get_config(arch), 1) == 8


def _jax_dispatch(x, probs, cfg, cap):
    return jax.vmap(lambda xt, pr: JM._dispatch_one_group(xt, pr, cfg, cap))(
        jnp.asarray(x), jnp.asarray(probs))


@pytest.mark.parametrize("arch,cf,t", [("granite-moe-1b-a400m", 0.25, 64),
                                       ("moonshot-v1-16b-a3b", 0.25, 64),
                                       ("granite-moe-1b-a400m", 8.0, 12),
                                       ("moonshot-v1-16b-a3b", 1.0, 1)])
def test_dispatch_internals_equal_the_reference(arch, cf, t):
    """top_e, and each sorted assignment's token, slot, weight and keep, and
    the dispatch buffer, equal the reference's exactly; at capacity factor
    0.25 the experts overflow and tokens are dropped."""
    jcfg = dataclasses.replace(jget_smoke(arch), capacity_factor=cf)
    tcfg = dataclasses.replace(get_smoke(arch), capacity_factor=cf)
    b, e, k = 3, tcfg.num_experts, tcfg.experts_per_token
    cap = TM.moe_capacity(tcfg, t)
    probs = probs_of(5, b, t, e)
    x = np.random.default_rng(6).standard_normal((b, t, 8)).astype(np.float32)
    jdisp, jstok, jslot, jsw, jkeep = _jax_dispatch(x, probs, jcfg, cap)
    top_e, stok, slot, sw, keep = TM._route(torch.from_numpy(probs), tcfg, cap)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jax.lax.top_k(probs, k)[1]))
    np.testing.assert_array_equal(stok.numpy(), np.asarray(jstok))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    disp = TM._dispatch(torch.from_numpy(x), stok, slot, keep, e, cap)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
    if cf == 0.25:
        assert not keep.all() and keep.any()
        assert int((slot == e * cap).sum()) == int((~keep).sum())


def test_ties_on_a_zero_router_take_the_lower_experts():
    """A zero router makes every probability 1/E: ``jax.lax.top_k`` gives
    the lowest k experts, and so must the port (``torch.topk`` promises no
    order among ties). Routing equal, outputs and aux within 1e-4."""
    jcfg, tcfg, jp, tp = moe_pair("moonshot-v1-16b-a3b")
    jp = {**jp, "router": np.zeros_like(jp["router"])}
    tp.router.data.zero_()
    x = np.random.default_rng(7).standard_normal((2, 10, tcfg.d_model)).astype(np.float32)
    probs = np.full((2, 10, tcfg.num_experts), 1.0 / tcfg.num_experts, np.float32)
    cap = TM.moe_capacity(tcfg, 10)
    top_e, stok, slot, _, keep = TM._route(torch.from_numpy(probs), tcfg, cap)
    assert (top_e.numpy() == np.arange(tcfg.experts_per_token)).all()
    _, jstok, jslot, _, jkeep = _jax_dispatch(x, probs, jcfg, cap)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(stok.numpy(), np.asarray(jstok))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    jy, jaux = JM.moe_forward(jp, jnp.asarray(x), jcfg)
    ty, taux = TM.moe_forward(tp, torch.from_numpy(x), tcfg)
    close(ty, jy)
    close(taux, jaux)
    assert float(taux) == 1.0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b,s,cf", [(2, 12, None), (3, 1, None), (2, 40, 0.25)])
def test_moe_forward_matches_reference(arch, b, s, cf):
    """Out and the Switch aux loss within 1e-4: a prefill-like group, a
    decode step (S=1, capacity 8) and a group that drops tokens."""
    changes = {} if cf is None else {"capacity_factor": cf}
    jcfg, tcfg, jp, tp = moe_pair(arch, **changes)
    x = np.random.default_rng(8).standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    jy, jaux = JM.moe_forward(jp, jnp.asarray(x), jcfg)
    ty, taux = TM.moe_forward(tp, torch.from_numpy(x), tcfg)
    assert ty.shape == (b, s, tcfg.d_model) and ty.dtype == torch.float32
    close(ty, jy)
    close(taux, jaux)


# ---------------------------------------------------------------------------
# the transformer with MoE blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch):
    jcfg, tcfg, jparams, tparams = pair(arch)
    jb, tb = tokens(tcfg, 9, 2, 11)
    jl, jaux = jmodel(jcfg).forward(jparams, jb, jcfg)
    tl, taux = TT.forward(tparams, tb, tcfg)
    close(tl, jl)
    close(taux, jaux)
    assert float(taux) > 0.0
    jc = jget_model(jcfg).init_cache(jcfg, 2, 24)
    tc = TT.init_cache(tcfg, 2, 24, "cpu")
    jl, jc = jmodel(jcfg).prefill(jparams, jb, jcfg, jc)
    tl, tc = TT.prefill(tparams, tb, tcfg, tc)
    close(tl, jl)
    for _ in range(5):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        assert (torch.argmax(tl[:, -1], -1).numpy() == tok[:, 0]).all()
        jl, jc = jmodel(jcfg).decode_step(jparams, jnp.asarray(tok), jcfg, jc)
        tl, tc = TT.decode_step(tparams, torch.from_numpy(tok), tcfg, tc)
        close(tl, jl)
    close(tc["k"], jc["k"])


def _jax_loss_fn(model, cfg, tcfg):
    """The reference's train-step loss with the MoE term
    (``repro/train/train_step.py``)."""

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch, cfg)
        labels, mask = JL.make_labels(batch, cfg)
        loss, metrics = JL.cross_entropy(logits, labels, mask, tcfg.z_loss)
        loss = loss + tcfg.moe_aux_weight * aux
        metrics["moe_aux"] = aux
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def _leaves(tree):
    out = {}

    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, (*path, k))
            else:
                out[(*path, k)] = v

    walk(tree)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_gradients_match_reference(arch):
    """The train step's loss (with ``moe_aux_weight * aux``), its metrics,
    ``moe_aux`` among them, and every gradient (router and experts too)."""
    jcfg, tcfg, jparams, tparams = pair(arch)
    jt, tt = JS.TrainConfig(), TS.TrainConfig()
    assert tt.moe_aux_weight == jt.moe_aux_weight
    jb, tb = tokens(tcfg, 10, 2, 9)
    (_, jmet), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jget_model(jcfg), jcfg, jt), has_aux=True))(jparams, jb)
    tmet, tgrads = TS.make_grad_fn(get_model(tcfg), tcfg, tt)(tparams, tb)
    assert set(tmet) == set(jmet) and "moe_aux" in tmet
    for k in jmet:
        close(tmet[k], jmet[k])
    want = _leaves(jgrads)
    got = _leaves(TC.stack_tree(tgrads))
    assert set(got) == set(want)
    assert ("blocks", "moe", "router") in got
    for path, g in got.items():
        close_grad(g, want[path])


def test_ragged_wave_spends_capacity_on_pads_as_the_reference_does():
    """Prompts of 9, 4 and 2 tokens in one wave, at a capacity factor that
    drops tokens: capacity is per sequence, so the pads of the shorter rows
    compete for it, as in the reference. Served tokens equal the
    reference's."""
    jcfg, tcfg, jparams, tparams = pair("granite-moe-1b-a400m", capacity_factor=0.5)
    prompts = [np.arange(1, 10), np.array([7, 8, 9, 3]), np.array([4, 5])]
    out = []
    for engine, config, model, cfg, params in (
            (ServeEngine, ServeConfig, get_model(tcfg), tcfg, tparams),
            (JServeEngine, JServeConfig, jget_model(jcfg), jcfg, jparams)):
        eng = engine(model, cfg, params, config(max_seq=32, batch_slots=4,
                                                max_new_tokens=5))
        rids = [eng.submit(p) for p in prompts]
        res = eng.run()
        out.append([res[r] for r in rids])
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_params_from_numpy_carries_the_moe_tree():
    jcfg, tcfg, jparams, tparams = pair("moonshot-v1-16b-a3b")
    want = _leaves(jax.tree.map(np.asarray, jparams))
    got = _leaves(TC.stack_tree(tparams.tree()))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[path])
    layer = tparams.blocks[1].moe
    e, d, ff = tcfg.num_experts, tcfg.d_model, tcfg.d_ff
    assert layer.router.shape == (d, e) and layer.w_gate.shape == (e, d, ff)
    assert layer.w_down.shape == (e, ff, d)
    fresh = TT.init_params(torch.Generator().manual_seed(0), tcfg)
    assert {p: t.shape for p, t in _leaves(TC.stack_tree(fresh.tree())).items()} == \
        {p: t.shape for p, t in got.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serving_tree_equals_cast_at_use(arch):
    """A bf16 serving tree (each matrix held in bf16 only, carried layer by
    layer) gives the same bits as the float32 tree rounded at each use:
    forward, prefill and decode logits equal; the router and the norms stay
    float32."""
    jcfg, jparams = _reference(arch, ())
    tcfg = dataclasses.replace(get_smoke(arch), dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jparams)
    full = TT.params_from_numpy(tree, tcfg, "cpu")
    held = TT.params_from_numpy(tree, tcfg, "cpu", serving=True)
    layer = held.blocks[0]
    assert layer.moe.w_gate.dtype == torch.bfloat16 and layer.attn.wq.dtype == torch.bfloat16
    assert held.embed.dtype == torch.bfloat16 and held.lm_head.dtype == torch.bfloat16
    assert layer.moe.router.dtype == torch.float32 and layer.ln_attn.dtype == torch.float32
    assert held.ln_final.dtype == torch.float32
    assert torch.equal(layer.moe.w_up.float(), full.blocks[0].moe.w_up.to(torch.bfloat16).float())
    _, tb = tokens(tcfg, 11, 2, 7)
    with torch.no_grad():
        assert torch.equal(TT.forward(held, tb, tcfg)[0], TT.forward(full, tb, tcfg)[0])
        outs = []
        for params in (held, full):
            lg, cache = TT.prefill(params, tb, tcfg, TT.init_cache(tcfg, 2, 16, "cpu"))
            seq = [lg]
            for _ in range(3):
                tok = torch.argmax(lg[:, -1], -1)[:, None].to(torch.int32)
                lg, cache = TT.decode_step(params, tok, tcfg, cache)
                seq.append(lg)
            outs.append(torch.cat(seq, 1))
    assert torch.equal(outs[0], outs[1])
    fresh = TT.init_params(torch.Generator().manual_seed(1), tcfg, serving=True)
    assert fresh.blocks[1].moe.w_down.dtype == torch.bfloat16
    assert fresh.blocks[1].moe.router.dtype == torch.float32


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_clis_run_the_moe_archs(arch, capsys):
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                    "--prompt-len", "6", "--new-tokens", "4", "--slots", "2"])
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                    "--batch", "2", "--seq", "8", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "step     2 loss" in out and "done: 2 steps" in out


def test_serve_cli_builds_a_serving_tree(capsys, monkeypatch):
    """The serving CLI builds the parameters with ``serving=True``."""
    from repro_torch.launch import serve as serve_cli
    seen = []
    init = TT.init_params

    def spy(generator, cfg, **kwargs):
        seen.append(kwargs)
        return init(generator, cfg, **kwargs)

    monkeypatch.setattr(TT, "init_params", spy)
    serve_cli.main(["--arch", "granite-moe-1b-a400m", "--smoke", "--device", "cpu",
                    "--requests", "2", "--prompt-len", "5", "--new-tokens", "3"])
    assert seen == [{"serving": True}]
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out
