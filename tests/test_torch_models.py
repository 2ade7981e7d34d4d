"""Port vs reference: the RWKV-6 model (``repro_torch.models.rwkv6``), its
building blocks (``models/common.py``), the arch config copy and registry.

Weights come from the reference's ``model.init(PRNGKey(0))`` and are carried
into the port by ``params_from_numpy``; token and activation inputs are made
with numpy from a seed. Tolerances: the float32 smoke config
``rtol = atol = 1e-4`` (the conformance policy of
``tests/test_kernel_conformance.py:15-31``; both packages run the same
float32 arithmetic in another summation order). The bfloat16 variant:
``rtol = atol = 5e-2`` on logits of magnitude below 1, the bf16 policy of
the same file scaled to them: every elementwise op rounds to bf16 in both
packages, but XLA and PyTorch fuse and round at different places (the
difference measured on these seeds is 1.0e-2 at most).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import SHAPES as JSHAPES, LONG_CONTEXT_ARCHS as JLONG
from repro.models import common as JC
from repro.models import get_model as jget_model
from repro.models import rwkv6 as JR
from repro_torch import configs as tconfigs
from repro_torch import device as tdevice
from repro_torch.models import SHAPES as TSHAPES, LONG_CONTEXT_ARCHS as TLONG
from repro_torch.models import common as TC
from repro_torch.models import get_model as tget_model
from repro_torch.models import rwkv6 as TR
from repro_torch.models.arch import ArchConfig as TArch
from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)


def close(got, want, tol=F32):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


def pair(dtype="float32"):
    """(JAX cfg, port cfg, JAX params, port params) for the smoke config in
    ``dtype``, the port's weights carried from the reference's PRNGKey(0)."""
    jcfg = dataclasses.replace(jget_smoke("rwkv6-7b"), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke("rwkv6-7b"), dtype=dtype)
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = TR.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def smoke():
    return pair()


def tokens(seed, b, t, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def layer(jparams, tparams, i):
    return jax.tree.map(lambda a: a[i], jparams["blocks"]), tparams.blocks[i]


def test_time_mix_and_channel_mix(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    rng = np.random.default_rng(1)
    b, t, d = 3, 7, tcfg.d_model
    h, hs = d // tcfg.rwkv_head_size, tcfg.rwkv_head_size
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    x_prev = rng.standard_normal((b, d)).astype(np.float32)
    state = rng.standard_normal((b, h, hs, hs)).astype(np.float32)
    for i in range(tcfg.num_layers):
        jl, tl = layer(jparams, tparams, i)
        jo, jx, js = JR.time_mix(jl["tm"], jnp.asarray(x), jnp.asarray(x_prev),
                                 jnp.asarray(state), jcfg)
        to, tx, ts = TR.time_mix(tl.tm, torch.from_numpy(x), torch.from_numpy(x_prev),
                                 torch.from_numpy(state), tcfg)
        close(to, jo)
        close(tx, jx)
        close(ts, js)
        jo, jx = JR.channel_mix(jl["cm"], jnp.asarray(x), jnp.asarray(x_prev))
        to, tx = TR.channel_mix(tl.cm, torch.from_numpy(x), torch.from_numpy(x_prev))
        close(to, jo)
        close(tx, jx)
    # the float32 decay with its LoRA, and the per-head norm
    xw = rng.standard_normal((b, t, d)).astype(np.float32)
    jl, tl = layer(jparams, tparams, 0)
    close(TR._decay(tl.tm, torch.from_numpy(xw)), JR._decay(jl["tm"], jnp.asarray(xw)))
    close(TR._group_norm(torch.from_numpy(x), tl.tm.gn_w, tl.tm.gn_b, h),
          JR._group_norm(jnp.asarray(x), jl["tm"]["gn_w"], jl["tm"]["gn_b"], h))


def jcache_equal(tcache, jcache, tol=F32):
    for name in ("tm_x", "cm_x", "wkv"):
        close(tcache[name], jcache[name], tol)
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_forward_prefill_decode_match_reference(dtype, tol):
    jcfg, tcfg, jparams, tparams = pair(dtype)
    toks = tokens(2, 3, 10, tcfg.vocab_size)
    jl, _ = JR.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, aux = TR.forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert tl.dtype == torch.float32 and tl.shape == (3, 10, tcfg.vocab_size)
    assert float(aux) == 0.0
    close(tl, jl, tol)
    jc = JR.init_cache(jcfg, 3, 32)
    tc = TR.init_cache(tcfg, 3, 32, "cpu")
    jcache_equal(tc, jc)
    jl, jc = JR.prefill(jparams, {"tokens": jnp.asarray(toks[:, :8])}, jcfg, jc)
    tl, tc = TR.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :8])}, tcfg, tc)
    close(tl, jl, tol)
    jcache_equal(tc, jc, tol)
    for i in (8, 9):
        jl, jc = JR.decode_step(jparams, jnp.asarray(toks[:, i:i + 1]), jcfg, jc)
        tl, tc = TR.decode_step(tparams, torch.from_numpy(toks[:, i:i + 1]), tcfg, tc)
        assert tl.shape == (3, 1, tcfg.vocab_size)
        close(tl, jl, tol)
        jcache_equal(tc, jc, tol)


def test_ragged_prefill_matches_reference(smoke):
    """Right-padded prompts with ``lens``: logits at each last real token,
    and the cache after the whole padded window, as the reference has it."""
    jcfg, tcfg, jparams, tparams = smoke
    toks = tokens(3, 3, 6, tcfg.vocab_size)
    lens = np.array([6, 3, 2], np.int32)
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    jl, jc = JR.prefill(jparams, {"tokens": jnp.asarray(toks), "lens": jnp.asarray(lens)},
                        jcfg, JR.init_cache(jcfg, 3, 16))
    tl, tc = TR.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                  "lens": torch.from_numpy(lens)},
                        tcfg, TR.init_cache(tcfg, 3, 16, "cpu"))
    close(tl, jl)
    jcache_equal(tc, jc)
    x = np.random.default_rng(4).standard_normal((3, 6, 5)).astype(np.float32)
    batch = {"tokens": toks, "lens": lens}
    close(TC.last_token_slice(torch.from_numpy(x), {k: torch.from_numpy(v)
                                                    for k, v in batch.items()}),
          JC.last_token_slice(jnp.asarray(x), {k: jnp.asarray(v) for k, v in batch.items()}))
    assert torch.equal(TC.last_token_slice(torch.from_numpy(x), {"tokens": toks}),
                       torch.from_numpy(x[:, -1:]))


def test_prefill_then_decode_reproduces_forward(smoke):
    """The analogue of ``tests/test_models.py:60-88`` on the port alone."""
    _, cfg, _, params = smoke
    seq = 12
    toks = torch.from_numpy(tokens(5, 2, seq, cfg.vocab_size))
    full, _ = TR.forward(params, {"tokens": toks}, cfg)
    cache = TR.init_cache(cfg, 2, 32, "cpu")
    lg, cache = TR.prefill(params, {"tokens": toks[:, :seq - 2]}, cfg, cache)
    close(lg[:, -1], full[:, seq - 3], dict(rtol=1e-3, atol=1e-3))
    for i in (seq - 2, seq - 1):
        lg, cache = TR.decode_step(params, toks[:, i:i + 1], cfg, cache)
        close(lg[:, 0], full[:, i], dict(rtol=1e-3, atol=1e-3))
    assert cache["pos"].tolist() == [seq, seq]


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((4, 5, 32)) * 3 + 1).astype(np.float32)
    w, b = rng.standard_normal(32).astype(np.float32), rng.standard_normal(32).astype(np.float32)
    close(TC.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)),
          JC.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = TC.layer_norm(xb, torch.from_numpy(w), torch.from_numpy(b))
    assert out.dtype == torch.bfloat16
    close(out, JC.layer_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w),
                             jnp.asarray(b)), BF16)


def test_init_params_has_the_reference_tree():
    """Keys, shapes and float32 dtypes of ``init_params`` equal the
    reference's (its ``blocks`` stacked on a leading layer axis), and the
    initialisers' scales match."""
    jcfg, tcfg = jget_smoke("rwkv6-7b"), tconfigs.get_smoke("rwkv6-7b")
    shapes = jax.eval_shape(lambda k: jget_model(jcfg).init(k, jcfg), jax.random.PRNGKey(0))
    params = TR.init_params(torch.Generator().manual_seed(0), tcfg)
    got = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            key = ("blocks", *parts[2:])
            if parts[1] == "0":
                got[key] = ((tcfg.num_layers, *p.shape), p.dtype)
            else:
                assert got[key] == ((tcfg.num_layers, *p.shape), p.dtype)
        else:
            got[tuple(parts)] = (tuple(p.shape), p.dtype)
        assert not p.requires_grad
    want = {tuple(k.key for k in path): (tuple(leaf.shape), torch.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    assert got == want
    assert torch.equal(params.blocks[1].tm.mu_r, torch.full((tcfg.d_model,), 0.5))
    assert torch.equal(params.blocks[0].tm.w0, torch.full((tcfg.d_model,), -0.6))
    d = tcfg.d_model
    assert abs(float(params.blocks[0].tm.w_r.std()) * d ** 0.5 - 1.0) < 0.1
    assert abs(float(params.embed.std()) / 0.02 - 1.0) < 0.1
    assert abs(float(params.lm_head.std()) / 0.02 - 1.0) < 0.1
    same = TR.init_params(torch.Generator().manual_seed(0), tcfg)
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), same.parameters()))


def test_compute_weight_copies():
    """``ParamTree.mat`` gives the parameter rounded to the compute dtype,
    made once, the parameter itself where rounding changes nothing, and
    fresh copies, in every subtree, after the tree is moved."""
    params = TR.ParamTree({"w": torch.randn(8, 4), "sub": {"v": torch.randn(3)},
                           "blocks": [{"x": torch.ones(2)}]})
    w = params.w
    assert params.mat("w", torch.float32) is w
    c = params.mat("w", torch.bfloat16)
    assert c.dtype == torch.bfloat16 and torch.equal(c, w.to(torch.bfloat16))
    assert params.mat("w", torch.bfloat16) is c
    cv = params.sub.mat("v", torch.bfloat16)
    params.to(torch.float64)
    again = params.mat("w", torch.bfloat16)
    assert again is not c and torch.equal(again, w.to(torch.bfloat16))
    assert params.sub.mat("v", torch.bfloat16) is not cv
    assert params.mat("w", torch.float64) is params.w
    assert params.sub.v.shape == (3,) and params.blocks[0].x.shape == (2,)


def test_arch_config_copy_and_registry():
    """The port's ArchConfig is the reference's (every field, the derived
    counts, the shape cells); its registry holds rwkv6-7b, the dense, vlm
    and MoE archs and recurrentgemma (``tests/test_torch_transformer.py``),
    with the reference's configs, and not whisper, whose family waits."""
    assert [f.name for f in dataclasses.fields(TArch)] == \
        [f.name for f in dataclasses.fields(jget_config("rwkv6-7b"))]
    assert "rwkv6-7b" in tconfigs.ARCH_NAMES
    for get_t, get_j in ((tconfigs.get_config, jget_config), (tconfigs.get_smoke, jget_smoke)):
        t, j = get_t("rwkv6-7b"), get_j("rwkv6-7b")
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    assert {k: dataclasses.asdict(v) for k, v in TSHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert TLONG == JLONG
    for arch in ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b", "recurrentgemma-2b"):
        assert dataclasses.asdict(tconfigs.get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
    with pytest.raises(KeyError):
        tconfigs.get_config("whisper-large-v3")


def test_get_model_dispatch():
    from repro_torch.models import recurrentgemma as TG
    from repro_torch.models import transformer as TT
    model = tget_model(tconfigs.get_smoke("rwkv6-7b"))
    assert model.prefill is TR.prefill and model.init is TR.init_params
    for family, module in (("moe", TT), ("hybrid", TG)):
        cfg = dataclasses.replace(tconfigs.get_smoke("rwkv6-7b"), family=family)
        assert tget_model(cfg).prefill is module.prefill
    cfg = dataclasses.replace(tconfigs.get_smoke("rwkv6-7b"), family="audio")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tget_model(cfg)
    with pytest.raises(ValueError):
        tget_model(dataclasses.replace(tconfigs.get_smoke("rwkv6-7b"), family="x"))


def test_cuda_device_keeps_tf32_off(monkeypatch):
    """``resolve_device`` turns TF32 off for the card (the decay's float32
    LoRA and the float32 checks need full float32 matmuls) and keeps bf16
    matmuls' reductions in float32 (the reference's bf16 dots accumulate in
    float32)."""
    mm = torch.backends.cuda.matmul
    prev = (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
            mm.allow_bf16_reduced_precision_reduction)
    try:
        mm.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        mm.allow_bf16_reduced_precision_reduction = True
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert tdevice.resolve_device(None).type == "cuda"
        assert mm.allow_tf32 is False and torch.backends.cudnn.allow_tf32 is False
        assert mm.allow_bf16_reduced_precision_reduction is False
    finally:
        (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = prev


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke("rwkv6-7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.params_from_numpy({}, cfg)
    assert TR.init_cache(cfg, 2, 8, "cpu")["wkv"].shape == (2, 2, 4, 16, 16)
