"""Port vs reference: LM serving (``repro_torch.serve.engine``) and its CLI.

Both packages serve ``rwkv6-7b-smoke`` (float32) with the reference's
``model.init(PRNGKey(0))`` weights, carried into the port by
``params_from_numpy``; the prompts are numpy arrays. Greedy tokens must be
equal, which the float32 logits (within 1e-4 of each other,
``tests/test_torch_models.py``) give wherever the top two logits are not
within that of each other; the seeds here have no such near-tie.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import get_model as jget_model
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.analysis.sanitize import ThreadOwnershipError
from repro_torch.configs import get_smoke
from repro_torch.launch import serve as cli
from repro_torch.models import get_model
from repro_torch.models import rwkv6 as TR
from repro_torch.serve import ServeConfig, ServeEngine, greedy_sample
from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jget_smoke("rwkv6-7b"), get_smoke("rwkv6-7b")
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tparams = TR.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return (jmodel, jcfg, jparams), (get_model(tcfg), tcfg, tparams)


def serve_both(models, prompts, **scfg):
    (jmodel, jcfg, jparams), (tmodel, tcfg, tparams) = models
    out = []
    for engine, config, model, cfg, params in (
            (JServeEngine, JServeConfig, jmodel, jcfg, jparams),
            (ServeEngine, ServeConfig, tmodel, tcfg, tparams)):
        eng = engine(model, cfg, params, config(max_seq=64, **scfg))
        rids = [eng.submit(p) for p in prompts]
        res = eng.run()
        out.append([res[r] for r in rids])
    return out


def test_equal_length_waves_match_reference(models):
    """Six 5-token prompts through 4 slots: two waves, the second partial."""
    prompts = list(np.random.default_rng(0).integers(0, 256, (6, 5)))
    jax_out, port_out = serve_both(models, prompts, batch_slots=4, max_new_tokens=6)
    assert port_out == jax_out
    assert all(len(o) == 6 for o in port_out)


def test_ragged_wave_matches_reference(models):
    """Prompts of 6, 3 and 2 tokens in one 4-slot wave. The port keeps the
    reference's behaviour: the state after the padded prefill has also run
    over the pad tokens, so the shorter prompts' tokens after the first
    differ from their solo runs (ROADMAP.md section 3). This pins the port
    to the reference's post-pad state, and the first token to the solo one."""
    prompts = [np.arange(1, 7), np.array([7, 8, 9]), np.array([4, 5])]
    jax_out, port_out = serve_both(models, prompts, batch_slots=4, max_new_tokens=6)
    assert port_out == jax_out
    assert port_out[1] == [128, 30, 53, 5, 130, 55]
    solo = [serve_both(models, [p], batch_slots=1, max_new_tokens=6)[1][0] for p in prompts]
    assert port_out[0] == solo[0]
    assert all(p[0] == s[0] for p, s in zip(port_out, solo))
    assert port_out[1] != solo[1] and port_out[2] != solo[2]


def test_greedy_matches_manual_decode(models):
    """The analogue of ``tests/test_distributed.py:159-179``."""
    _, (model, cfg, params) = models
    prompt = np.asarray([1, 2, 3, 4])
    eng = ServeEngine(model, cfg, params, ServeConfig(max_seq=32, batch_slots=1,
                                                      max_new_tokens=4))
    rid = eng.submit(prompt)
    out = eng.run()[rid]
    cache = model.init_cache(cfg, 1, 32, "cpu")
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None]}, cfg, cache)
    toks = [int(torch.argmax(lg[0, -1]))]
    for _ in range(3):
        lg, cache = model.decode_step(params, torch.tensor([[toks[-1]]], dtype=torch.int32),
                                      cfg, cache)
        toks.append(int(torch.argmax(lg[0, 0])))
    assert out == toks


def test_eos_stops_rows_as_the_reference_does(models):
    prompts = list(np.random.default_rng(1).integers(0, 256, (3, 4)))
    free = serve_both(models, prompts, batch_slots=3, max_new_tokens=8)[1]
    eos = free[0][2]                              # row 0 ends at its third token
    jax_out, port_out = serve_both(models, prompts, batch_slots=3, max_new_tokens=8,
                                   eos_token=eos)
    assert port_out == jax_out
    assert port_out[0] == free[0][:3]
    for full, cut in zip(free, port_out):
        assert cut == full[:len(cut)] and (len(cut) == 8 or cut[-1] == eos)


def test_results_are_claimed_once(models):
    _, (model, cfg, params) = models
    eng = ServeEngine(model, cfg, params, ServeConfig(max_seq=32, batch_slots=2,
                                                      max_new_tokens=2))
    rids = [eng.submit(np.array([3, 4, 5])) for _ in range(3)]
    assert rids == [0, 1, 2] and eng.pending() == 3
    assert eng.poll(rids[0]) is None                 # still queued
    out = eng.run()
    assert sorted(out) == rids and eng.pending() == 0
    assert eng.poll(rids[0]) is None                 # run() handed it out
    assert eng.run() == {}
    eng._complete(7, [1])
    assert eng.poll(7) == [1] and eng.poll(7) is None


def test_sampling_is_greedy_only(models):
    _, (model, cfg, params) = models
    with pytest.raises(ValueError, match="greedy"):
        ServeEngine(model, cfg, params, ServeConfig(temperature=0.7))
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 0.0, 0.0, 0.0]])
    assert greedy_sample(logits).tolist() == [1, 0]        # ties: lowest index
    with pytest.raises(ValueError, match="Generator"):
        greedy_sample(logits, temperature=1.0)
    drawn = greedy_sample(logits[:, None], torch.Generator().manual_seed(0), temperature=1.0)
    assert drawn.shape == (2, 1) and bool(((drawn >= 0) & (drawn < 4)).all())


def test_single_owner_queue_under_sanitize(models, monkeypatch):
    """Under REPRO_SANITIZE=1 the queue binds to its first thread; a touch
    from another raises, until the owner hands it over."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    _, (model, cfg, params) = models
    eng = ServeEngine(model, cfg, params, ServeConfig(max_seq=32, max_new_tokens=1))
    eng.submit(np.array([1, 2]))
    caught = []

    def foreign():
        try:
            eng.submit(np.array([3]))
        except ThreadOwnershipError as e:
            caught.append(e)

    th = threading.Thread(target=foreign)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive() and len(caught) == 1
    eng.rebind_owner()
    th = threading.Thread(target=lambda: eng.submit(np.array([3])))
    th.start()
    th.join(timeout=30)
    assert not th.is_alive() and eng.pending() == 2


def test_cli_runs_on_cpu(capsys):
    cli.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu", "--requests", "5",
              "--prompt-len", "6", "--new-tokens", "3", "--slots", "2"])
    out = capsys.readouterr().out
    assert "served 5 requests, 15 tokens in" in out and "tok/s" in out


def test_cli_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--arch", "rwkv6-7b", "--smoke"])
