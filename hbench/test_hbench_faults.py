"""A whole run on the CPU at a small size, the look for a card skipped: the
sound program comes out correct, and each fault that a served cell can
have, planted under the timed path, makes ``correct`` false.

The runs use a copy of the checkout whose ``BENCHMARK.json`` also holds
the cells that are kept as files but left out of the benchmark (the scan
baseline's ``pscan-ctrl5``), so their files are run too."""
import json
import shutil
import time

import pytest
import torch

from hbench import run, spec
from repro_torch.core import engine as core_engine
from repro_torch.serve import engine as serve_engine

SMALL = {"config": {"num_series": 8192, "build": {"leaf_capacity": 256},
                    "search": {"chunk": 256, "scan_block": 1024}},
         "traffic": {"clients": 8, "slots": 4, "pool": 48}}


LEFT_OUT = [{"name": "pscan-ctrl5", "config": "synth256-pscan", "traffic": "ctrl5",
             "chips": 1, "why": "the scan baseline"}]
LEFT_OUT_CONFIGS = [{"name": "synth256-pscan", "source": "test",
                     "file": "hbench/configs/synth256-pscan.json", "reduced": ["num_series"],
                     "why": "the scan baseline"}]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(spec.ROOT / "hbench", root / "hbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    bench["configs"] += LEFT_OUT_CONFIGS
    bench["workloads"] += LEFT_OUT
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "src").symlink_to(spec.ROOT / "src")
    return root


def _run(root, cell="index-ctrl1", seed=2**31 + 11):
    return run.run_cell(cell, seed, 0.4, 0, device="cpu", root=root, overrides=SMALL,
                        t_start=time.perf_counter())


@pytest.mark.parametrize("cell", ["index-ctrl1", "pscan-ctrl5", "index-mixed"])
def test_the_sound_program_is_correct(root, cell):
    res = _run(root, cell)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= SMALL["traffic"]["clients"]
    assert list(res)[-1] == "check"


def test_an_answer_altered_where_it_is_produced(root, monkeypatch):
    knn = core_engine.QueryEngine.knn

    def altered(self, *args, **kwargs):
        res = knn(self, *args, **kwargs)
        ids = res.ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % SMALL["config"]["num_series"]
        return res._replace(ids=ids)

    monkeypatch.setattr(core_engine.QueryEngine, "knn", altered)
    res = _run(root)
    assert not res["correct"] and res["check"]["gap"]["value"] > 1e-2


def test_a_distance_altered_where_it_is_produced(root, monkeypatch):
    knn = core_engine.QueryEngine.knn

    def altered(self, *args, **kwargs):
        res = knn(self, *args, **kwargs)
        return res._replace(dists=res.dists * (1 + 1e-3))

    monkeypatch.setattr(core_engine.QueryEngine, "knn", altered)
    res = _run(root, "pscan-ctrl5")
    assert not res["correct"] and res["check"]["gap"]["value"] > 1e-4


def test_a_step_that_returns_its_state_unchanged(root, monkeypatch):
    """Every wave after the first answers with the first wave's results."""
    knn = core_engine.QueryEngine.knn
    first = {}

    def stale(self, *args, **kwargs):
        res = knn(self, *args, **kwargs)
        key = (id(self), res.ids.shape[1])
        return first.setdefault(key, res)

    monkeypatch.setattr(core_engine.QueryEngine, "knn", stale)
    res = _run(root)
    assert not res["correct"]


def test_half_of_each_wave_left_out(root, monkeypatch):
    serve = serve_engine.KnnServeEngine._serve

    def half(self, wave):
        return serve(self, wave[:max(1, len(wave) // 2)])

    monkeypatch.setattr(serve_engine.KnnServeEngine, "_serve", half)
    res = _run(root)
    assert not res["correct"] and res["check"]["unanswered"]["value"] > 0
    assert res["failed"] == res["check"]["unanswered"]["value"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "index-ctrl1", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_names():
    clean = ["repro_torch", "repro_torch.core.engine", "jaxtyping", "reprox", "flaxen"]
    assert run.forbidden_modules(clean) == []
    assert run.forbidden_modules(clean + ["repro.core.search", "jax.numpy", "jaxlib",
                                          "flax.linen"]) == ["flax", "jax", "jaxlib", "repro"]
