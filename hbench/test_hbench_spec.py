"""Cells, configurations, traffic mixes and metrics are found by name, and a
new one is taken in by adding files and entries, with no file edited."""
import json
import re
import shutil
import time

import pytest
import torch

from hbench import gen, run, spec

SMALL = {"config": {"num_series": 8192, "build": {"leaf_capacity": 256},
                    "search": {"chunk": 256, "scan_block": 1024}},
         "traffic": {"clients": 8, "slots": 4, "pool": 48}}
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def test_config_and_traffic_load_by_name():
    bench = spec.load_benchmark()
    cell = spec.cell(bench, "index-ctrl1")
    cfg = spec.config(bench, cell["config"])
    assert cfg["backend"] == "local" and cfg["num_series"] == 7 * 2 ** 21
    assert cfg["build"]["leaf_capacity"] == 4096 and cfg["search"]["l_max"] == 80
    assert spec.traffic(cell["traffic"])["difficulty"] == ["1%"]
    with open(spec.ROOT / "hbench" / "configs" / "synth256-pscan.json") as f:
        assert json.load(f)["backend"] == "scan"     # kept as a file, out of the benchmark
    with pytest.raises(KeyError):
        spec.cell(bench, "no-such-cell")
    with pytest.raises(ValueError):
        spec.traffic("../configs/synth256-index")


def test_benchmark_file_keeps_its_shape():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "hbench/run.py"] and bench["paths"] == ["hbench"]
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[key]]
    assert len(names) == len(set(names)) and all(_NAME.fullmatch(n) for n in names)
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("hbench/configs/")
        assert spec.config(bench, c["name"])["reduced"] == c["reduced"]
    assert {w["config"] for w in bench["workloads"]} == configs
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert e2e == {"qps", "latency_p95_ms", "build_s", "peak_mem_gib", "setup_s"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        spec.traffic(w["traffic"])
        reported = {m["name"] for m in spec.end_to_end(bench, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = spec.per_layer(bench, w["name"])
        assert layer and all(m["moves"] in reported for m in layer)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]).read)
        if m["name"].endswith("_roofline"):
            spec.roofline(m["name"][:-len("_roofline")])
    for m in bench["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def _copy_checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.ROOT / "hbench", root / "hbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "src").symlink_to(spec.ROOT / "src")
    return root


def test_a_config_sets_any_field_of_the_program():
    """The builder hands the configuration's groups to the program's own
    config classes whole: a field that no file of the harness names (the
    paper's NoSAX ablation, the top-k refinement) reaches the index."""
    cfg = dict(spec.config(spec.load_benchmark(), "synth256-index"), num_series=4096,
               build={"leaf_capacity": 256},
               search={"use_sax": False, "refine_select": "topk", "scan_block": 1024})
    dev = torch.device("cpu")
    data = gen.random_walks(cfg["num_series"], cfg["series_len"], gen.generator(3, "c", dev),
                            dev)
    backend, build_s = spec.builder(cfg["builder"]).build(cfg, data, dev)
    search = backend.index.config.search
    assert not search.use_sax and search.refine_select == "topk"
    assert search.l_max == 80 and backend.index.config.build.leaf_capacity == 256
    assert build_s > 0


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """A new configuration (with a program field the harness does not
    name), traffic mix, end-to-end and per-layer metric (reading a counter
    the harness does not name) and cell, added as new files and new
    entries: the harness runs the cell and reports the metrics, and no
    existing file changed."""
    root = _copy_checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "hbench").rglob("*") if p.is_file()}
    base = spec.config(spec.load_benchmark(), "synth256-index")
    (root / "hbench" / "configs" / "synth128-nosax.json").write_text(json.dumps(
        dict(base, name="synth128-nosax", series_len=128,
             search=dict(base["search"], use_sax=False))))
    (root / "hbench" / "traffic" / "ctrl2-k3.json").write_text(json.dumps(
        {"clients": 6, "slots": 4, "wave": True, "pack": "fifo", "k": [1, 3],
         "difficulty": ["2%"], "pool": 32}))
    (root / "hbench" / "metrics" / "engine.plan_hits.py").write_text(
        "def read(ctx):\n    return float(ctx.delta('window', 'plan_cache', 'hits'))\n")
    (root / "hbench" / "metrics" / "answers.py").write_text(
        "def read(ctx):\n    return float(ctx.run['answered'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "synth128-nosax", "source": "test",
                             "file": "hbench/configs/synth128-nosax.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "nosax128-ctrl2", "config": "synth128-nosax",
                               "traffic": "ctrl2-k3", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "answers", "unit": "queries", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["nosax128-ctrl2"]})
    bench["per_layer"].append({"name": "engine.plan_hits", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "query engine", "moves": "qps",
                               "workloads": ["nosax128-ctrl2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    ov = {"config": SMALL["config"]}
    res0 = run.run_cell("nosax128-ctrl2", 7, 0.5, 0, device="cpu", root=root,
                        overrides=ov, t_start=time.perf_counter())
    assert res0["correct"] and res0["attempted"] > 0
    # every end-to-end metric without a list of cells (no allocator peak on
    # the CPU) and the one that lists the cell; build_s and latency_p95_ms
    # list their cells
    assert set(res0["metrics"]) == {"qps", "setup_s", "answers"}
    assert res0["metrics"]["answers"]["value"] >= 1
    res1 = run.run_cell("nosax128-ctrl2", 8, 0.5, 1, device="cpu", root=root,
                        overrides=ov, t_start=time.perf_counter(), trace_min_seconds=0.1)
    assert res1["correct"] and res1["metrics"]["engine.plan_hits"]["value"] >= 1
    assert set(res1["metrics"]) == {"engine.plan_hits"}     # only what lists the cell
    assert all(p.read_bytes() == data for p, data in before.items())
