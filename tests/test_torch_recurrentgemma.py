"""Port vs reference: recurrentgemma (``repro_torch.models.recurrentgemma``):
the causal conv, the RG-LRU and its scan's plain version
(``kernels/ref.py::rg_lru_scan_ref``), the forward pass, prefill and decode
past the local window, a ragged serving wave, the list layout of
``params_from_numpy``, and the bf16 serving tree.

Weights come from the reference's ``init(PRNGKey(0))`` (or
``init_layer``), carried by ``params_from_numpy``; activations and tokens
are made with numpy from a seed. Tolerances: float32 ``rtol = atol = 1e-4``
(``tests/test_torch_models.py``: the same float32 arithmetic in another
summation order). The scan's plain version against the reference's
``lax.scan``: ``rtol = atol = 1e-6`` (XLA may fuse the step's multiply and
add, the plain version rounds each; 512 steps of a decay below 1 keep the
difference at a few ulps). The bf16 serving tree gives the same bits as
rounding at each use, and ``kernels/ops.py`` on CPU tensors is the plain
version itself.
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
from repro.models import recurrentgemma as JG
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import get_model
from repro_torch.models import recurrentgemma as TG
from repro_torch.models.common import ParamTree
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import train_step as TS
from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

F32 = dict(rtol=1e-4, atol=1e-4)
ARCH = "recurrentgemma-2b"


def close(got, want, tol=F32):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


@functools.lru_cache(maxsize=None)
def _reference(changes):
    jcfg = dataclasses.replace(jget_smoke(ARCH), **dict(changes))
    return jcfg, jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)


def pair(**changes):
    """(JAX cfg, port cfg, JAX params, port params) for the smoke config."""
    jcfg, jparams = _reference(tuple(sorted(changes.items())))
    tcfg = dataclasses.replace(get_smoke(ARCH), **changes)
    return jcfg, tcfg, jparams, TG.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                     tcfg, "cpu")


def jmodel(cfg):
    m = jget_model(cfg)
    return dataclasses.replace(m, **{name: jax.jit(getattr(m, name), static_argnums=2)
                                     for name in ("forward", "prefill", "decode_step")})


def tokens(cfg, seed, b, t):
    arr = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    return {"tokens": jnp.asarray(arr)}, {"tokens": torch.from_numpy(arr)}


def rec_layer():
    """A recurrent layer's ``rec`` weights from the reference's
    ``init_layer``: (numpy dict, port ParamTree)."""
    jcfg = jget_smoke(ARCH)
    jp = jax.tree.map(np.asarray, JG.init_layer(jax.random.PRNGKey(4), "rec", jcfg))["rec"]
    return jp, ParamTree({k: torch.from_numpy(v.copy()) for k, v in jp.items()})


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# conv, RG-LRU, the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_tail", [False, True])
@pytest.mark.parametrize("t", [1, 9])
def test_causal_conv_matches_reference(with_tail, t):
    jp, tp = rec_layer()
    x = randn(1, 2, t, 64)
    tail = randn(2, 2, 3, 64) if with_tail else None
    jy, jtail = JG._causal_conv(jnp.asarray(x), jnp.asarray(jp["conv_w"]),
                                jnp.asarray(jp["conv_b"]),
                                None if tail is None else jnp.asarray(tail))
    ty, ttail = TG._causal_conv(torch.from_numpy(x), tp.conv_w, tp.conv_b,
                                None if tail is None else torch.from_numpy(tail))
    close(ty, jy, dict(rtol=1e-6, atol=1e-6))
    np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))


@pytest.mark.parametrize("t", [1, 17])
def test_rg_lru_matches_reference(t):
    jp, tp = rec_layer()
    x = randn(3, 2, t, 64)
    h0 = randn(4, 2, 64)
    jy, jh = JG._rg_lru(jp, jnp.asarray(x), jnp.asarray(h0))
    ty, th = TG._rg_lru(tp, torch.from_numpy(x), torch.from_numpy(h0))
    close(ty, jy)
    close(th, jh)
    assert th.dtype == torch.float32


@pytest.mark.parametrize("b,t,r", [(4, 512, 16), (2, 1, 7), (3, 0, 5)])
def test_rg_lru_scan_ref_matches_the_reference_scan(b, t, r):
    """The plain version against the reference's ``lax.scan`` step on the
    same (a, g, h0); ``kernels/ops.py`` takes it for CPU tensors."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0.0, 1.0, (b, t, r)).astype(np.float32)
    g = rng.standard_normal((b, t, r)).astype(np.float32)
    h0 = rng.standard_normal((b, r)).astype(np.float32)

    def step(h, xs):
        a_t, g_t = xs
        h = a_t * h + g_t
        return h, h

    jh, jys = jax.lax.scan(step, jnp.asarray(h0), (jnp.moveaxis(jnp.asarray(a), 1, 0),
                                                   jnp.moveaxis(jnp.asarray(g), 1, 0)))
    ta, tg, th0 = (torch.from_numpy(v) for v in (a, g, h0))
    y, h = tref.rg_lru_scan_ref(ta, tg, th0)
    assert y.shape == (b, t, r) and h.shape == (b, r)
    close(y, np.moveaxis(np.asarray(jys), 0, 1), dict(rtol=1e-6, atol=1e-6))
    close(h, jh, dict(rtol=1e-6, atol=1e-6))
    oy, oh = tops.rg_lru_scan(ta, tg, th0)
    assert torch.equal(oy, y) and torch.equal(oh, h)
    if t:
        # a rounded multiply, then a rounded add: float64 rounded back per step
        hh = h0.copy()
        for i in range(t):
            hh = (a[:, i] * hh).astype(np.float32) + g[:, i]
        np.testing.assert_array_equal(h.numpy(), hh)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_matches_reference():
    jcfg, tcfg, jparams, tparams = pair()
    jb, tb = tokens(tcfg, 6, 2, 21)
    jl, _ = jmodel(jcfg).forward(jparams, jb, jcfg)
    tl, aux = TG.forward(tparams, tb, tcfg)
    close(tl, jl)
    assert float(aux) == 0.0 and tl.dtype == torch.float32


@pytest.mark.parametrize("prompt,steps", [(12, 10), (20, 3)])
def test_prefill_and_decode_past_the_window_match_reference(prompt, steps):
    """The smoke window is 16: a 12-token prompt decoded 10 steps past it
    (the ring buffer wraps), and a 20-token prompt, longer than the window
    (prefill keeps its last 16 positions at slots 0-15, the reference's
    simplification), decoded on."""
    jcfg, tcfg, jparams, tparams = pair()
    jb, tb = tokens(tcfg, 7, 2, prompt)
    jc = jget_model(jcfg).init_cache(jcfg, 2, 40)
    tc = TG.init_cache(tcfg, 2, 40, "cpu")
    jl, jc = jmodel(jcfg).prefill(jparams, jb, jcfg, jc)
    tl, tc = TG.prefill(tparams, tb, tcfg, tc)
    close(tl, jl)
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        assert (torch.argmax(tl[:, -1], -1).numpy() == tok[:, 0]).all()
        jl, jc = jmodel(jcfg).decode_step(jparams, jnp.asarray(tok), jcfg, jc)
        tl, tc = TG.decode_step(tparams, torch.from_numpy(tok), tcfg, tc)
        close(tl, jl)
    assert tc["pos"].tolist() == [prompt + steps] * 2
    for tlc, jlc in zip(tc["layers"], jc["layers"]):
        assert set(tlc) == set(jlc)
        for key in tlc:
            close(tlc[key], jlc[key])
    assert tc["layers"][2]["k"].shape == (2, 16, 1, 16)


def test_ragged_wave_matches_reference():
    """Prompts of 9, 4 and 2 tokens in one wave: the recurrent state and
    the conv tail also run over the pads of the shorter rows, as in the
    reference (``ROADMAP.md`` section 3). Served tokens equal the
    reference's; first tokens equal each prompt's solo run; later tokens of
    a padded row differ from it."""
    jcfg, tcfg, jparams, tparams = pair()
    prompts = [np.arange(1, 10), np.array([7, 8, 9, 3]), np.array([4, 5])]

    def serve(prompts, slots, packages=2):
        out = []
        for engine, config, model, cfg, params in (
                (ServeEngine, ServeConfig, get_model(tcfg), tcfg, tparams),
                (JServeEngine, JServeConfig, jget_model(jcfg), jcfg, jparams))[:packages]:
            eng = engine(model, cfg, params, config(max_seq=32, batch_slots=slots,
                                                    max_new_tokens=6))
            rids = [eng.submit(p) for p in prompts]
            res = eng.run()
            out.append([res[r] for r in rids])
        return out

    port_out, jax_out = serve(prompts, 4)
    assert port_out == jax_out
    solo = [serve([p], 1, packages=1)[0][0] for p in prompts]
    assert port_out[0] == solo[0]
    assert all(p[0] == s[0] for p, s in zip(port_out, solo))
    assert port_out[1] != solo[1] or port_out[2] != solo[2]


# ---------------------------------------------------------------------------
# parameters, dispatch, training, the CLI
# ---------------------------------------------------------------------------

def test_params_from_numpy_keeps_the_list_layout():
    jcfg, tcfg, jparams, tparams = pair()
    tree = jax.tree.map(np.asarray, jparams)
    assert isinstance(tree["blocks"], list)
    kinds = TG._pattern(tcfg)
    assert kinds == JG._pattern(jcfg) == ("rec", "rec", "attn")
    for layer, jlayer, kind in zip(tparams.tree()["blocks"], tree["blocks"], kinds):
        assert set(layer) == set(jlayer) and (kind in layer or "rec" in layer)
        for key, sub in jlayer.items():
            if isinstance(sub, dict):
                for name, arr in sub.items():
                    np.testing.assert_array_equal(layer[key][name].detach().numpy(), arr)
            else:
                np.testing.assert_array_equal(layer[key].detach().numpy(), sub)
    np.testing.assert_array_equal(tparams.embed.detach().numpy(), tree["embed"])
    # the port's own init: the reference's keys and shapes, layer by layer
    fresh = TG.init_params(torch.Generator().manual_seed(0), tcfg).tree()

    def shapes(node):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in node.items()}

    assert [shapes(layer) for layer in fresh["blocks"]] == \
        [shapes(layer) for layer in tree["blocks"]]


def test_param_counts():
    """The tree of the published config holds 3,549,934,080 parameters;
    ``param_count()`` gives 3,313,592,320 in both packages: its formula
    leaves out ``w_input_gate`` and ``w_rec_gate`` (2 rnn^2 a recurrent
    layer), the conv weights and two of the four rnn-vectors, and the norm
    gains."""
    cfg = get_config(ARCH)
    assert cfg.param_count() == 3_313_592_320
    n_rec = sum(kind == "rec" for kind in TG._pattern(cfg))
    rnn = cfg.d_rnn
    assert n_rec == 18
    tree = cfg.param_count() + n_rec * 2 * rnn * rnn + cfg.num_layers * 2 * cfg.d_model \
        + cfg.d_model + n_rec * (cfg.conv_width * rnn + 2 * rnn)
    assert tree == 3_549_934_080
    small = get_smoke(ARCH)
    params = TG.init_params(torch.Generator().manual_seed(0), small)
    n = sum(p.numel() for p in params.parameters())
    n_rec = sum(kind == "rec" for kind in TG._pattern(small))
    rnn = small.d_rnn
    assert n == small.param_count() + n_rec * 2 * rnn * rnn + small.num_layers * 2 * \
        small.d_model + small.d_model + n_rec * (small.conv_width * rnn + 2 * rnn)


def test_bf16_serving_tree_equals_cast_at_use():
    """Each matrix held in bf16 only gives the same bits as rounding it at
    each use; the gates, ``lambda``, their biases and the norms stay
    float32."""
    jcfg, jparams = _reference(())
    tcfg = dataclasses.replace(get_smoke(ARCH), dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jparams)
    full = TG.params_from_numpy(tree, tcfg, "cpu")
    held = TG.params_from_numpy(tree, tcfg, "cpu", serving=True)
    rec = held.blocks[0].rec
    for name in ("w_x", "w_gate", "w_out", "conv_w", "conv_b"):
        assert getattr(rec, name).dtype == torch.bfloat16
    for name in ("lambda", "w_input_gate", "b_input_gate", "w_rec_gate", "b_rec_gate"):
        assert getattr(rec, name).dtype == torch.float32
    assert held.blocks[2].attn.wk.dtype == torch.bfloat16
    assert held.blocks[2].ln_mix.dtype == torch.float32
    _, tb = tokens(tcfg, 8, 2, 18)
    with torch.no_grad():
        assert torch.equal(TG.forward(held, tb, tcfg)[0], TG.forward(full, tb, tcfg)[0])
        outs = []
        for params in (held, full):
            lg, cache = TG.prefill(params, tb, tcfg, TG.init_cache(tcfg, 2, 24, "cpu"))
            seq = [lg]
            for _ in range(4):
                tok = torch.argmax(lg[:, -1], -1)[:, None].to(torch.int32)
                lg, cache = TG.decode_step(params, tok, tcfg, cache)
                seq.append(lg)
            outs.append(torch.cat(seq, 1))
    assert torch.equal(outs[0], outs[1])


def test_dispatch_and_training_not_yet():
    cfg = get_smoke(ARCH)
    model = get_model(cfg)
    assert model.forward is TG.forward and model.params_from_numpy is TG.params_from_numpy
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TS.make_grad_fn(model, cfg, TS.TrainConfig())


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.params_from_numpy({}, cfg)
    cache = TG.init_cache(cfg, 2, 8, "cpu")
    assert [sorted(c) for c in cache["layers"]] == [["conv", "h"], ["conv", "h"], ["k", "v"]]


def test_serve_cli_runs_recurrentgemma(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                    "--prompt-len", "6", "--new-tokens", "20", "--slots", "2"])
    assert "served 3 requests, 60 tokens" in capsys.readouterr().out
