"""Port vs reference: training (``repro_torch.train``): labels and loss,
the AdamW schedules, int8 moments and update, the train step's loss,
metrics and gradients, checkpoints both ways, the training CLI, and the
retrieval-LM example (``examples/torch_retrieval_lm.py``).

Weights come from the reference's ``init(PRNGKey(0))``, carried by
``params_from_numpy``; tokens, logits, gradients and moments are made with
numpy from a seed. Tolerances: float32 ``rtol = atol = 1e-4``; a gradient
within ``1e-4`` of its tensor's largest magnitude (and ``rtol = 1e-4``),
since a gradient's small entries are sums of terms that cancel. AdamW's
first update is about ``lr * sign(g)`` and flips wherever ``|g|`` is near
``eps``, so the optimizer is compared on shared gradients and moments and
the model's gradients apart from it. int8 moments: the blocks' scales
within 1e-6 relative and the codes within one step, since a moment within
float32 rounding of a half step rounds either way.
"""
import dataclasses
import functools
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core import BuildConfig as JBuild
from repro.core import HerculesIndex as JIndex
from repro.core import IndexConfig as JIndexConfig
from repro.core import SearchConfig as JSearch
from repro.core import brute_force_knn as jbrute
from repro.core.summaries import znormalize as jznorm
from repro.models import get_model as jget_model
from repro.train import checkpoint as JCK
from repro.train import loss as JL
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch.configs import get_smoke
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import common as TC
from repro_torch.models import get_model
from repro_torch.train import checkpoint as TCK
from repro_torch.train import loss as TL
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS
from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

F32 = dict(rtol=1e-4, atol=1e-4)
ROOT = Path(__file__).resolve().parents[1]


def close(got, want, tol=F32):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


def close_grad(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * max(float(np.abs(want).max()), 1e-30))


def leaves(tree):
    """{path: leaf} of a reference-layout tree (numpy, JAX or torch)."""
    out = {}

    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, (*path, k))
            else:
                out[(*path, k)] = v

    walk(tree)
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch):
    jcfg = jget_smoke(arch)
    return jcfg, jax.jit(jget_model(jcfg).init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)


def pair(arch):
    jcfg, jparams = _reference(arch)
    tcfg = get_smoke(arch)
    return jcfg, tcfg, jparams, get_model(tcfg).params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def batches(cfg, seed, b, t, loss_mask=False):
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.family == "vlm":
        arrays["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_patch)).astype(np.float32)
    if loss_mask:
        arrays["loss_mask"] = (rng.random((b, t)) < 0.7).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def port_tree(np_tree, cfg):
    """A reference-layout tree of arrays as a port tree (``blocks`` a list)."""
    return TC.params_from_numpy(np_tree, cfg.num_layers, "cpu", stacked=True).tree()


# ---------------------------------------------------------------------------
# labels, loss, schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,loss_mask", [("minicpm-2b", False), ("minicpm-2b", True),
                                            ("phi-3-vision-4.2b", False)])
def test_make_labels_matches_reference(arch, loss_mask):
    cfg = get_smoke(arch)
    jb, tb = batches(cfg, 1, 3, 7, loss_mask)
    jl, jm = JL.make_labels(jb, jget_smoke(arch))
    tl, tm = TL.make_labels(tb, cfg)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    if cfg.family == "vlm":
        assert tm.shape == (3, cfg.num_patches + 7)
        assert float(tm.sum()) == 3 * 7          # the text targets only


@pytest.mark.parametrize("z_loss", [0.0, 1e-4, 0.5])
def test_cross_entropy_matches_reference(z_loss):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, 6, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 40, (3, 6)).astype(np.int32)
    labels[0, :3] = logits[0, :3].argmax(-1)
    mask = (rng.random((3, 6)) < 0.8).astype(np.float32)
    jloss, jmet = JL.cross_entropy(*map(jnp.asarray, (logits, labels, mask)), z_loss)
    tloss, tmet = TL.cross_entropy(*map(torch.from_numpy, (logits, labels, mask)), z_loss)
    close(tloss, jloss)
    assert set(tmet) == set(jmet)
    for k in jmet:
        close(tmet[k], jmet[k])
    _, empty = TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                torch.zeros(3, 6))
    assert float(empty["tokens"]) == 1.0 and float(empty["ce"]) == 0.0


@pytest.mark.parametrize("schedule", ["cosine", "constant", "wsd"])
def test_lr_schedules_match_reference(schedule):
    kw = dict(learning_rate=3e-3, warmup_steps=7, total_steps=50, schedule=schedule)
    jcfg, tcfg = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    for step in (0, 1, 6, 7, 8, 30, 40, 41, 45, 50, 60):
        close(TO.lr_at(tcfg, torch.tensor(step, dtype=torch.int32)),
              JO.lr_at(jcfg, jnp.int32(step)), dict(rtol=1e-6, atol=0))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("shape", [(3, 512), (2, 3, 256), (72,), (2, 72), (300,), ()])
def test_int8_quantize_matches_reference(shape):
    """Blockwise along the last dim where it divides 256, else the padded
    single-row fallback; the codes and scales equal, and the round trip."""
    x = np.asarray(np.random.default_rng(3).standard_normal(shape) ** 3, dtype=np.float32)
    jq, tq = JO._quantize(jnp.asarray(x)), TO._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    assert tq["q"].dtype == torch.int8
    size = int(np.prod(shape))
    close(TO._dequantize(tq, shape, size), JO._dequantize(jq, shape, size), dict(rtol=0, atol=0))
    zero = TO._quantize(torch.zeros(shape))
    assert not bool(zero["q"].any()) and not bool(zero["scale"].any())


# ---------------------------------------------------------------------------
# the optimizer on shared gradients
# ---------------------------------------------------------------------------

jadamw_update = jax.jit(JO.adamw_update, static_argnums=3)


def shared_grads(jparams, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
                        jparams)


@pytest.mark.parametrize("clip", [1.0, 0.0, 100.0])
def test_adamw_update_float32_matches_reference(clip):
    """Two updates on the same gradients: parameters, moments, step and
    metrics (clipping active at 1.0, off at 0, idle at 100)."""
    jcfg, tcfg, jparams, tparams = pair("granite-34b")
    kw = dict(learning_rate=1e-2, warmup_steps=2, grad_clip=clip)
    jo_cfg, to_cfg = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jstate, tstate = JO.adamw_init(jparams, jo_cfg), TO.adamw_init(tparams, to_cfg)
    assert {p: tuple(v.shape) for p, v in leaves(tstate["m"]).items()} == \
        {p: tuple(v.shape) for p, v in leaves(jstate["m"]).items()}
    for seed in (4, 5):
        g = shared_grads(jparams, seed)
        jparams, jstate, jmet = jadamw_update(jparams, g, jstate, jo_cfg)
        tparams, tstate, tmet = TO.adamw_update(tparams, port_tree(g, tcfg), tstate, to_cfg)
        for k in ("grad_norm", "lr"):
            close(tmet[k], jmet[k], dict(rtol=1e-6, atol=0))
        assert int(tstate["step"]) == int(jstate["step"])
        for name in ("m", "v"):
            want = leaves(jstate[name])
            for path, t in leaves(tstate[name]).items():
                close(t, want[path], dict(rtol=1e-5, atol=1e-9))
        want = leaves(jparams)
        for path, t in leaves(TC.stack_tree(tparams.tree(), True)).items():
            close(t, want[path], dict(rtol=1e-5, atol=1e-6))


def test_adamw_update_int8_matches_reference():
    """From the reference's int8 state after one update, one more update on
    the same gradients in both packages: parameters, scales within 1e-6
    relative, codes within one step."""
    jcfg, tcfg, jparams, tparams = pair("minicpm-2b")
    ocfg_j = JO.AdamWConfig(learning_rate=1e-2, warmup_steps=1, moment_dtype="int8")
    ocfg_t = TO.AdamWConfig(learning_rate=1e-2, warmup_steps=1, moment_dtype="int8")
    jparams, jstate, _ = jadamw_update(jparams, shared_grads(jparams, 6),
                                         JO.adamw_init(jparams, ocfg_j), ocfg_j)
    tparams = get_model(tcfg).params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tstate = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jstate)
    g = shared_grads(jparams, 7)
    jparams, jstate, _ = jadamw_update(jparams, g, jstate, ocfg_j)
    tparams, tstate, _ = TO.adamw_update(tparams, port_tree(g, tcfg), tstate, ocfg_t)
    want = leaves(jparams)
    for path, t in leaves(TC.stack_tree(tparams.tree(), True)).items():
        close(t, want[path], dict(rtol=1e-5, atol=1e-6))
    for name in ("m", "v"):
        want = leaves(jstate[name])
        got = leaves(tstate[name])
        assert set(got) == set(want)
        for path, t in got.items():
            if path[-1] == "q":
                assert t.dtype == torch.int8
                diff = np.abs(t.numpy().astype(np.int32) - np.asarray(want[path], np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            else:
                close(t, want[path], dict(rtol=1e-6, atol=0))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def jax_loss_fn(model, cfg, tcfg):
    """The reference's train-step loss (``repro/train/train_step.py``)."""

    def loss_fn(params, batch):
        logits, _ = model.forward(params, batch, cfg)
        labels, mask = JL.make_labels(batch, cfg)
        loss, metrics = JL.cross_entropy(logits, labels, mask, tcfg.z_loss)
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


@pytest.mark.parametrize("arch", ["minicpm-2b", "codeqwen1.5-7b", "granite-34b",
                                  "llama3-405b", "phi-3-vision-4.2b"])
def test_gradients_match_jax_value_and_grad(arch):
    jcfg, tcfg, jparams, tparams = pair(arch)
    jt, tt = JS.TrainConfig(), TS.TrainConfig()
    jb, tb = batches(tcfg, 8, 2, 9)
    (_, jmet), jgrads = jax.jit(jax.value_and_grad(
        jax_loss_fn(jget_model(jcfg), jcfg, jt), has_aux=True))(jparams, jb)
    tmet, tgrads = TS.make_grad_fn(get_model(tcfg), tcfg, tt)(tparams, tb)
    assert set(tmet) == set(jmet)
    for k in jmet:
        close(tmet[k], jmet[k])
    want = leaves(jgrads)
    got = leaves(TC.stack_tree(tgrads, True))
    assert set(got) == set(want)
    for path, g in got.items():
        close_grad(g, want[path])


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_train_step_matches_reference(microbatches, moments):
    """One ``make_train_step`` step in each package: loss and every metric,
    and the gradients the step used, read from the first moments (m =
    (1 - b1) g after one step; the step's order of microbatch sums is the
    reference's)."""
    jcfg, tcfg, jparams, tparams = pair("llama3-405b")
    ocfg = dict(learning_rate=1e-3, warmup_steps=2, grad_clip=0.0)
    jt = JS.TrainConfig(optimizer=JO.AdamWConfig(**ocfg), microbatches=microbatches)
    tt = TS.TrainConfig(optimizer=TO.AdamWConfig(**ocfg), microbatches=microbatches)
    jb, tb = batches(tcfg, 9, 4, 8)
    jstate = JO.adamw_init(jparams, jt.optimizer)
    jgrads_from = jax.jit(JS.make_train_step(jget_model(jcfg), jcfg, jt))
    _, jstate, jmet = jgrads_from(jparams, jstate, jb)
    tt = dataclasses.replace(tt, optimizer=dataclasses.replace(tt.optimizer,
                                                               moment_dtype=moments))
    tparams, tstate, tmet = TS.make_train_step(get_model(tcfg), tcfg, tt)(
        tparams, TO.adamw_init(tparams, tt.optimizer), tb)
    assert set(tmet) == set(jmet)
    for k in jmet:
        close(tmet[k], jmet[k])
    assert int(tstate["step"]) == 1
    got = leaves(tstate["m"])
    for path, want in leaves(jstate["m"]).items():
        if moments == "int8":
            shape = tuple(want.shape)
            m = TO._dequantize(TC.get_path(tstate["m"], path), shape, int(np.prod(shape)))
            q = got[(*path, "scale")]
            step = float(q.max())             # at most one code step off
            np.testing.assert_allclose(m.numpy(), np.asarray(want), atol=step * 1.001, rtol=0)
        else:
            close_grad(got[path], want)


def test_port_loss_falls_over_twenty_steps():
    """The retrieval example's training (20 steps on one batch, constant lr
    1e-3 after a 5-step warmup): the loss falls and stays finite, and the
    first step's loss is the reference's on the same batch and weights."""
    jcfg, tcfg, jparams, tparams = pair("minicpm-2b")
    kw = dict(learning_rate=1e-3, warmup_steps=5, total_steps=50, schedule="constant")
    tt = TS.TrainConfig(optimizer=TO.AdamWConfig(**kw))
    jt = JS.TrainConfig(optimizer=JO.AdamWConfig(**kw))
    jb, tb = batches(tcfg, 10, 8, 32)
    step = TS.make_train_step(get_model(tcfg), tcfg, tt)
    opt = TO.adamw_init(tparams, tt.optimizer)
    losses = []
    for _ in range(20):
        tparams, opt, met = step(tparams, opt, tb)
        losses.append(float(met["loss"]))
    _, _, jmet = jax.jit(JS.make_train_step(jget_model(jcfg), jcfg, jt))(
        jparams, JO.adamw_init(jparams, jt.optimizer), jb)
    close(losses[0], jmet["loss"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0] - 1.0
    ev = TS.make_eval_step(get_model(tcfg), tcfg)(tparams, tb)
    assert abs(float(ev["ce"]) - losses[-1]) < 0.5 and "z_loss" not in ev


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_checkpoints_cross_load_both_ways(tmp_path, moments):
    """The reference writes, the port reads; the port writes, the reference
    reads: the same keys, shapes and values, params and optimizer state."""
    jcfg, tcfg, jparams, tparams = pair("granite-34b")
    ocfg = dict(moment_dtype=moments, warmup_steps=1)
    jstate = jadamw_update(jparams, shared_grads(jparams, 11),
                             JO.adamw_init(jparams, JO.AdamWConfig(**ocfg)),
                             JO.AdamWConfig(**ocfg))
    jparams, jopt = jstate[0], jstate[1]
    JCK.save_checkpoint(str(tmp_path / "j"), 3, {"params": jparams, "opt": jopt}, {"seed": 5})
    state, meta = TCK.load_checkpoint(str(tmp_path / "j"), device="cpu")
    assert meta == {"step": 3, "seed": 5}
    params = get_model(tcfg).params_from_numpy(state["params"], tcfg, "cpu")
    want = leaves(jparams)
    for path, t in leaves(TC.stack_tree(params.tree(), True)).items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[path]))
    jflat = leaves(jopt["m"]) | {("step",): jopt["step"]}
    tflat = leaves(state["opt"]["m"]) | {("step",): state["opt"]["step"]}
    assert set(tflat) == set(jflat)
    for path, t in tflat.items():
        assert t.dtype == getattr(torch, str(np.asarray(jflat[path]).dtype))
        np.testing.assert_array_equal(t.numpy(), np.asarray(jflat[path]))
    # the port writes (a ParamTree in the stacked layout), the reference reads
    path = TCK.save_checkpoint(str(tmp_path / "t"), 4, {"params": params,
                                                        "opt": state["opt"]})
    assert path.endswith("step_00000004.npz") and TCK.latest_step(str(tmp_path / "t")) == 4
    assert not [f for f in os.listdir(tmp_path / "t") if f.endswith(".tmp")]
    jback, jmeta = JCK.load_checkpoint(str(tmp_path / "t"))
    assert jmeta == {"step": 4}
    assert jax.tree.structure(jback["params"]) == jax.tree.structure(jparams)
    assert jax.tree.structure(jback["opt"]) == jax.tree.structure(jopt)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves({"params": jparams, "opt": jopt})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert TCK.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        TCK.load_checkpoint(str(tmp_path / "none"), device="cpu")


def test_restart_gives_the_same_run(tmp_path):
    """Four steps straight against two, a checkpoint, a reload and two
    more: the same parameters and moments, bit for bit (the batches from
    ``synth_batch(seed, t)``)."""
    cfg = get_smoke("phi-3-vision-4.2b")
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
    for a, b in zip(straight[0].parameters(), resumed[0].parameters()):
        assert torch.equal(a, b)
    for a, b in zip(TC.tree_leaves(straight[1]), TC.tree_leaves(resumed[1])):
        assert torch.equal(a, b)


def test_synth_batch_depends_only_on_seed_and_step():
    cfg = get_smoke("phi-3-vision-4.2b")
    a = train_cli.synth_batch(0, 5, cfg, 2, 8, "cpu")
    b = train_cli.synth_batch(0, 5, cfg, 2, 8, "cpu")
    c = train_cli.synth_batch(0, 6, cfg, 2, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert a["tokens"].dtype == torch.int32 and a["patch_embeds"].shape == (2, 8, 32)


# ---------------------------------------------------------------------------
# the CLIs and the example
# ---------------------------------------------------------------------------

def test_train_cli_runs_and_resumes(tmp_path, capsys):
    args = ["--arch", "minicpm-2b", "--smoke", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "8", "--log-every", "2"]
    train_cli.main(args)
    out = capsys.readouterr().out
    assert "step     4 loss" in out and "done: 4 steps" in out
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    train_cli.main(args[:6] + ["2"] + args[7:] + ckpt)
    assert TCK.latest_step(str(tmp_path)) == 2
    train_cli.main(args + ckpt)
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "done: 2 steps" in out
    assert TCK.latest_step(str(tmp_path)) == 4


def test_cli_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "minicpm-2b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "codeqwen1.5-7b", "--smoke"])


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "phi-3-vision-4.2b"])
def test_serve_cli_runs_dense_and_vlm_on_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                    "--prompt-len", "5", "--new-tokens", "3", "--slots", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens in" in out and "tok/s" in out


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_retrieval_lm", ROOT / "examples" / "torch_retrieval_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_retrieval_example_matches_the_reference_example():
    """The reference example's steps (its training, corpus and prompts,
    ``examples/retrieval_lm.py``) against the port example's functions on
    the reference's weights after its 20 steps: embeddings within 1e-4,
    kNN ids equal, dists within 1e-4, and both exact against brute force."""
    ex = _example()
    jcfg = jget_smoke("minicpm-2b")
    model = jget_model(jcfg)
    key = jax.random.PRNGKey(0)
    tcfg = JS.TrainConfig(optimizer=JO.AdamWConfig(learning_rate=1e-3, warmup_steps=5,
                                                   total_steps=50, schedule="constant"))
    params, opt = JS.init_train_state(model, jcfg, tcfg, key)
    step = jax.jit(JS.make_train_step(model, jcfg, tcfg))
    batch = {"tokens": jax.random.randint(key, (8, 32), 0, jcfg.vocab_size)}
    for _ in range(20):
        params, opt, _ = step(params, opt, batch)

    @jax.jit
    def embed(tokens):
        logits, _ = model.forward(params, {"tokens": tokens}, jcfg)
        return jnp.mean(logits, axis=1)

    corpus = jax.random.randint(jax.random.PRNGKey(1), (2048, 32), 0, jcfg.vocab_size)
    prompts = jax.random.randint(jax.random.PRNGKey(2), (5, 32), 0, jcfg.vocab_size)
    vecs, qvecs = jznorm(embed(corpus)), jznorm(embed(prompts))
    idx = JIndex.build(vecs, JIndexConfig(build=JBuild(leaf_capacity=64),
                                          search=JSearch(k=3, l_max=8, chunk=256,
                                                         scan_block=256)))
    jres = idx.knn(qvecs)
    bf_d, _ = jbrute(vecs, qvecs, 3)
    assert np.allclose(np.asarray(jres.dists), np.asarray(bf_d), rtol=1e-3, atol=1e-3)

    tparams = get_model(ex.CFG).params_from_numpy(jax.tree.map(np.asarray, params),
                                                  ex.CFG, "cpu")
    tvecs = ex.embed(tparams, torch.tensor(np.asarray(corpus)))
    tq = ex.embed(tparams, torch.tensor(np.asarray(prompts)))
    close(tvecs, vecs)
    close(tq, qvecs)
    _, tres, tbf_d, tbf_i = ex.retrieve(tvecs, tq)
    np.testing.assert_array_equal(tres.ids.numpy(), np.asarray(jres.ids))
    close(tres.dists, jres.dists)
    np.testing.assert_array_equal(tbf_i.numpy(), tres.ids.numpy())
    assert torch.allclose(tres.dists, tbf_d, rtol=1e-3, atol=1e-3)


def test_retrieval_example_runs_on_cpu(capsys):
    _example().main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "trained 20 steps" in out and "retrieval exact" in out
