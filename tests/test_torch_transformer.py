"""Port vs reference: the dense and vlm transformer
(``repro_torch.models.transformer``), its attention, rotary and norm parts
(``models/common.py``), the five archs' config copies and the registry, and
LM serving of a ragged wave.

Weights come from the reference's ``model.init(PRNGKey(0))`` and are carried
into the port by ``params_from_numpy``; tokens, patch embeddings and
activations are made with numpy from a seed. Tolerances: float32
``rtol = atol = 1e-4`` (``tests/test_torch_models.py``: the same float32
arithmetic in another summation order). bfloat16 (minicpm's smoke config
in its published compute dtype): ``rtol = atol = 5e-2`` on logits of
magnitude below 1, the bf16 policy of ``tests/test_torch_models.py``: each
op rounds to bf16 in both packages, at places that XLA and PyTorch fuse
differently.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro import configs as jconfigs
from repro.configs import get_smoke as jget_smoke
from repro.models import common as JC
from repro.models import get_model as jget_model
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.models import common as TC
from repro_torch.models import get_model as tget_model
from repro_torch.models import transformer as TT
from repro_torch.models import whisper as TW
from repro_torch.serve import ServeConfig, ServeEngine
from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)
ARCHS = ("minicpm-2b", "codeqwen1.5-7b", "granite-34b", "llama3-405b", "phi-3-vision-4.2b")


def close(got, want, tol=F32):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


@functools.lru_cache(maxsize=None)
def _reference(arch, changes):
    jcfg = dataclasses.replace(jget_smoke(arch), **dict(changes))
    init = jax.jit(jget_model(jcfg).init, static_argnums=1)
    return jcfg, init(jax.random.PRNGKey(0), jcfg)


def pair(arch, **changes):
    """(JAX cfg, port cfg, JAX params, port params) for the smoke config,
    the port's weights carried from the reference's PRNGKey(0) (fresh port
    parameters at every call)."""
    jcfg, jparams = _reference(arch, tuple(sorted(changes.items())))
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **changes)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def jmodel(cfg):
    """The reference's ModelDef with forward, prefill and decode_step
    jitted (cfg static), as its own engines run them."""
    m = jget_model(cfg)
    return dataclasses.replace(m, **{name: jax.jit(getattr(m, name), static_argnums=2)
                                     for name in ("forward", "prefill", "decode_step")})


def batches(cfg, seed, b, t):
    """The same batch for both packages: (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.family == "vlm":
        arrays["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_patch)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def attn_params(d, spec_j, seed=0):
    """The reference's ``init_attention`` weights, in both packages."""
    jp = JC.init_attention(jax.random.PRNGKey(seed), d, spec_j)
    return jp, TC.ParamTree({k: torch.tensor(np.asarray(v)) for k, v in jp.items()},
                          stacked=True)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def test_rms_norm_matches_reference():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 48)) * 2 + 0.5).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    close(TC.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
          JC.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    out = TC.rms_norm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w))
    assert out.dtype == torch.bfloat16
    close(out, JC.rms_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w)), BF16)


@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope_matches_reference(batched):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 600, (2, 7)) if batched else np.arange(3, 10)).astype(np.int32)
    for theta in (10000.0, 500000.0):
        close(TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
              JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    close(TC.rope_freqs(16, 10000.0), JC.rope_freqs(16, 10000.0))


def test_mlps_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.3
         for s in ((16, 32), (16, 32), (32, 16), (32,), (16,))]
    t = [torch.from_numpy(a) for a in w]
    j = [jnp.asarray(a) for a in w]
    close(TC.swiglu(torch.from_numpy(x), *t[:3]), JC.swiglu(jnp.asarray(x), *j[:3]))
    close(TC.gelu_mlp(torch.from_numpy(x), t[0], t[3], t[2], t[4]),
          JC.gelu_mlp(jnp.asarray(x), j[0], j[3], j[2], j[4]))


# (heads, kv heads, window): MHA, GQA, MQA, GQA with a sliding window
HEADS = [(4, 4, 0), (4, 2, 0), (4, 1, 0), (4, 2, 3)]


@pytest.mark.parametrize("h,g,window", HEADS)
def test_attention_full_and_chunked_match_reference(h, g, window):
    rng = np.random.default_rng(4)
    b, s, hd = 2, 12, 8
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, g, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, g, hd)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    for impl, fn in (("full", "attention_full"), ("chunked", "attention_chunked")):
        jspec = JC.AttnSpec(h, g, hd, window=window, impl=impl, chunk=4)
        tspec = TC.AttnSpec(h, g, hd, window=window, impl=impl, chunk=4)
        want = getattr(JC, fn)(*map(jnp.asarray, (q, k, v, pos, pos)), jspec)
        got = getattr(TC, fn)(*map(torch.from_numpy, (q, k, v, pos, pos)), tspec)
        close(got, want)
    with pytest.raises(ValueError, match="not divisible"):
        TC.attention_chunked(*map(torch.from_numpy, (q, k[:, :10], v[:, :10], pos, pos[:10])),
                             TC.AttnSpec(h, g, hd, chunk=4))


def test_chunked_attention_guards_fully_masked_rows():
    """Query positions before every key: all-masked rows give 0, not NaN,
    as the reference's guard gives."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 4, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 8, 2, 8)).astype(np.float32)
    qpos, kpos = np.arange(4, dtype=np.int32), np.arange(4, 12, dtype=np.int32)
    spec_j, spec_t = JC.AttnSpec(2, 2, 8, chunk=4), TC.AttnSpec(2, 2, 8, chunk=4)
    want = JC.attention_chunked(*map(jnp.asarray, (q, k, k, qpos, kpos)), spec_j)
    got = TC.attention_chunked(*map(torch.from_numpy, (q, k, k, qpos, kpos)), spec_t)
    assert bool(torch.isfinite(got).all()) and float(got.abs().max()) == 0.0
    close(got, want)


@pytest.mark.parametrize("h,g,window", HEADS)
def test_attention_decode_step_matches_reference(h, g, window):
    """Three lockstep steps from a filled cache: the output and the caches
    (the ring buffer's slot ``pos % Smax`` with a window)."""
    rng = np.random.default_rng(6)
    b, d, hd, smax = 2, 16, 8, 6
    jspec, tspec = JC.AttnSpec(h, g, hd, window=window), TC.AttnSpec(h, g, hd, window=window)
    jp, tp = attn_params(d, jspec)
    ck = rng.standard_normal((b, smax, g, hd)).astype(np.float32)
    cv = rng.standard_normal((b, smax, g, hd)).astype(np.float32)
    jk, jv, tk, tv = jnp.asarray(ck), jnp.asarray(cv), torch.from_numpy(ck), torch.from_numpy(cv)
    for p in (3, 4, 5):
        x = rng.standard_normal((b, 1, d)).astype(np.float32)
        pos = np.full((b,), p, np.int32)
        jo, jk, jv = JC.attention_decode_step(jp, jnp.asarray(x), jk, jv, jnp.asarray(pos),
                                              jspec, 10000.0)
        to, tk, tv = TC.attention_decode_step(tp, torch.from_numpy(x), tk, tv,
                                              torch.from_numpy(pos), tspec, 10000.0)
        close(to, jo)
        close(tk, jk)
        close(tv, jv)


def test_grad_cast_casts_the_cotangent_only():
    """Identity forward; on the way back the cotangent is rounded to the
    given dtype."""
    x = torch.randn(3, 4, dtype=torch.float64, requires_grad=True)
    c = torch.randn(3, 4, dtype=torch.float64)
    y = TC.grad_cast(x, torch.float32)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad((y * c).sum(), x)
    assert torch.equal(g, c.float().double()) and not torch.equal(g, c)


# ---------------------------------------------------------------------------
# the model, per arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch):
    jcfg, tcfg, jparams, tparams = pair(arch)
    jm, tm = jmodel(jcfg), tget_model(tcfg)
    jb, tb = batches(tcfg, 7, 2, 10)
    jl, _ = jm.forward(jparams, jb, jcfg)
    tl, aux = tm.forward(tparams, tb, tcfg)
    extra = tcfg.num_patches if tcfg.family == "vlm" else 0
    assert tl.dtype == torch.float32 and tl.shape == (2, 10 + extra, tcfg.vocab_size)
    assert float(aux) == 0.0
    close(tl, jl)
    jc, tc = jm.init_cache(jcfg, 2, 32), tm.init_cache(tcfg, 2, 32, "cpu")
    jl, jc = jm.prefill(jparams, {**jb, "tokens": jb["tokens"][:, :8]}, jcfg, jc)
    tl, tc = tm.prefill(tparams, {**tb, "tokens": tb["tokens"][:, :8]}, tcfg, tc)
    close(tl, jl)
    for i in (8, 9):
        jl, jc = jm.decode_step(jparams, jb["tokens"][:, i:i + 1], jcfg, jc)
        tl, tc = tm.decode_step(tparams, tb["tokens"][:, i:i + 1], tcfg, tc)
        assert tl.shape == (2, 1, tcfg.vocab_size)
        close(tl, jl)
        close(tc["k"], jc["k"])
        close(tc["v"], jc["v"])
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_bfloat16_forward_prefill_decode_match_reference():
    jcfg, tcfg, jparams, tparams = pair("minicpm-2b", dtype="bfloat16")
    jm, tm = jmodel(jcfg), tget_model(tcfg)
    jb, tb = batches(tcfg, 8, 2, 9)
    jl, _ = jm.forward(jparams, jb, jcfg)
    tl, _ = tm.forward(tparams, tb, tcfg)
    assert tl.dtype == torch.float32
    close(tl, jl, BF16)
    jl, jc = jm.prefill(jparams, {"tokens": jb["tokens"][:, :8]}, jcfg, jm.init_cache(jcfg, 2, 16))
    tl, tc = tm.prefill(tparams, {"tokens": tb["tokens"][:, :8]}, tcfg,
                        tm.init_cache(tcfg, 2, 16, "cpu"))
    assert tc["k"].dtype == torch.bfloat16
    close(tl, jl, BF16)
    jl, _ = jm.decode_step(jparams, jb["tokens"][:, 8:], jcfg, jc)
    tl, _ = tm.decode_step(tparams, tb["tokens"][:, 8:], tcfg, tc)
    close(tl, jl, BF16)


@pytest.mark.parametrize("changes", [dict(attention_impl="chunked", attention_chunk=4),
                                     dict(window=4)])
def test_chunked_and_windowed_configs_match_reference(changes):
    """The chunked attention through ``forward``, and a sliding window:
    forward, prefill into a window-sized ring cache, then ring decode."""
    jcfg, tcfg, jparams, tparams = pair("llama3-405b", **changes)
    jm, tm = jmodel(jcfg), tget_model(tcfg)
    jb, tb = batches(tcfg, 9, 2, 12)
    close(tm.forward(tparams, tb, tcfg)[0], jm.forward(jparams, jb, jcfg)[0])
    jl, jc = jm.prefill(jparams, {"tokens": jb["tokens"][:, :8]}, jcfg, jm.init_cache(jcfg, 2, 16))
    tl, tc = tm.prefill(tparams, {"tokens": tb["tokens"][:, :8]}, tcfg,
                        tm.init_cache(tcfg, 2, 16, "cpu"))
    assert tc["k"].shape == jc["k"].shape
    close(tl, jl)
    for i in range(8, 12):
        jl, jc = jm.decode_step(jparams, jb["tokens"][:, i:i + 1], jcfg, jc)
        tl, tc = tm.decode_step(tparams, tb["tokens"][:, i:i + 1], tcfg, tc)
        close(tl, jl)
        close(tc["k"], jc["k"])


def test_prefill_then_decode_reproduces_forward():
    """The analogue of ``tests/test_models.py``'s decode consistency, on the
    port alone (codeqwen, phi-3-vision with its patches)."""
    for arch in ("codeqwen1.5-7b", "phi-3-vision-4.2b"):
        _, cfg, _, params = pair(arch)
        model = tget_model(cfg)
        _, batch = batches(cfg, 10, 2, 12)
        full, _ = model.forward(params, batch, cfg)
        off = cfg.num_patches if cfg.family == "vlm" else 0
        cache = model.init_cache(cfg, 2, 32, "cpu")
        lg, cache = model.prefill(params, {**batch, "tokens": batch["tokens"][:, :10]}, cfg,
                                  cache)
        close(lg[:, -1], full[:, off + 9], dict(rtol=1e-3, atol=1e-3))
        for i in (10, 11):
            lg, cache = model.decode_step(params, batch["tokens"][:, i:i + 1], cfg, cache)
            close(lg[:, 0], full[:, off + i], dict(rtol=1e-3, atol=1e-3))


def test_remat_changes_no_gradient():
    """``cfg.remat`` recomputes each layer in the backward pass: the same
    loss and gradients as without it."""
    _, cfg, _, params = pair("granite-34b")
    _, batch = batches(cfg, 11, 2, 8)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        params.requires_grad_(True)
        logits, _ = TT.forward(params, batch, c)
        loss = logits.square().mean()
        out.append((loss.detach(), torch.autograd.grad(loss, list(params.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_ragged_prefill_matches_reference():
    jcfg, tcfg, jparams, tparams = pair("minicpm-2b")
    jb, tb = batches(tcfg, 12, 3, 6)
    lens = np.array([6, 3, 2], np.int32)
    jl, jc = jmodel(jcfg).prefill(jparams, {**jb, "lens": jnp.asarray(lens)}, jcfg,
                                  jget_model(jcfg).init_cache(jcfg, 3, 16))
    tl, tc = TT.prefill(tparams, {**tb, "lens": torch.from_numpy(lens)}, tcfg,
                        TT.init_cache(tcfg, 3, 16, "cpu"))
    close(tl, jl)
    close(tc["k"], jc["k"])
    assert tc["pos"].tolist() == [6, 6, 6]


def test_ragged_wave_serving_matches_reference():
    """Prompts of 6, 3 and 2 tokens in one 4-slot wave. As in the reference,
    the wave's decode attends to the pad tokens after each shorter prompt
    (``pos`` is the padded length), so those rows' tokens after the first
    differ from their solo runs. Pinned: port == reference, first tokens ==
    solo."""
    jcfg, tcfg, jparams, tparams = pair("minicpm-2b")
    prompts = [np.arange(1, 7), np.array([7, 8, 9]), np.array([4, 5])]

    def serve(prompts, slots, packages=2):
        out = []
        for engine, config, model, cfg, params in (
                (ServeEngine, ServeConfig, tget_model(tcfg), tcfg, tparams),
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


def test_vlm_serving_carries_extras():
    """phi-3-vision requests with their patch embeddings: the port's tokens
    equal the reference's."""
    jcfg, tcfg, jparams, tparams = pair("phi-3-vision-4.2b")
    rng = np.random.default_rng(13)
    prompts = rng.integers(0, tcfg.vocab_size, (3, 5))
    extras = [{"patch_embeds": rng.standard_normal((tcfg.num_patches, tcfg.d_patch))
               .astype(np.float32)} for _ in range(3)]
    out = []
    for engine, config, model, cfg, params in (
            (JServeEngine, JServeConfig, jget_model(jcfg), jcfg, jparams),
            (ServeEngine, ServeConfig, tget_model(tcfg), tcfg, tparams)):
        eng = engine(model, cfg, params, config(max_seq=32, batch_slots=2, max_new_tokens=4))
        rids = [eng.submit(p, e) for p, e in zip(prompts, extras)]
        res = eng.run()
        out.append([res[r] for r in rids])
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# parameters, configs, registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    jcfg, tcfg = jget_smoke(arch), tconfigs.get_smoke(arch)
    shapes = jax.eval_shape(lambda k: jget_model(jcfg).init(k, jcfg), jax.random.PRNGKey(0))
    params = TT.init_params(torch.Generator().manual_seed(0), tcfg)
    flat = {}

    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, (*path, k))
            else:
                flat[(*path, k)] = (tuple(v.shape), v.dtype)

    walk(TC.stack_tree(params.tree(), True))
    want = {tuple(k.key for k in path): (tuple(leaf.shape), torch.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    assert flat == want
    assert not any(p.requires_grad for p in params.parameters())
    d = tcfg.d_model
    assert abs(float(params.blocks[0].attn.wq.std()) * d ** 0.5 - 1.0) < 0.15
    assert abs(float(params.embed.std()) / 0.02 - 1.0) < 0.1
    assert torch.equal(params.blocks[1].ln_attn, torch.zeros(d))


def test_config_copies_and_registry():
    assert tconfigs.ARCH_NAMES == (("granite-moe-1b-a400m", "moonshot-v1-16b-a3b") + ARCHS[1:4]
                                   + ARCHS[:1] + ARCHS[4:]
                                   + ("whisper-large-v3", "rwkv6-7b", "recurrentgemma-2b"))
    for arch in tconfigs.ARCH_NAMES:
        for get_t, get_j in ((tconfigs.get_config, jget_config),
                             (tconfigs.get_smoke, jget_smoke)):
            t, j = get_t(arch), get_j(arch)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert t.param_count() == j.param_count()
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.all_configs().items()} == \
        {k: dataclasses.asdict(jget_config(k)) for k in tconfigs.ARCH_NAMES}
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert tget_model(tconfigs.get_smoke("whisper-large-v3")).forward is TW.forward
    for arch in ARCHS:
        model = tget_model(tconfigs.get_smoke(arch))
        assert model.forward is TT.forward and model.params_from_numpy is TT.params_from_numpy


def test_mixture_of_experts_waits():
    """It no longer waits: a dense config given experts builds MoE blocks
    (``models/moe.py``) in place of the MLP, and the ``moe`` family
    dispatches to this module."""
    cfg = dataclasses.replace(tconfigs.get_smoke("minicpm-2b"), num_experts=4,
                              experts_per_token=2)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg)
    assert params.blocks[0].moe.w_gate.shape == (4, cfg.d_model, cfg.d_ff)
    assert not hasattr(params.blocks[0], "mlp")
    assert tget_model(dataclasses.replace(cfg, family="moe")).forward is TT.forward


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke("minicpm-2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.params_from_numpy({}, cfg)
    assert TT.init_cache(cfg, 2, 8, "cpu")["k"].shape == (2, 2, 8, 4, 18)
