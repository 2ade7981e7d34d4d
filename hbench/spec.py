"""Find a cell, its configuration, its traffic mix and its metrics by name.

Every lookup starts from a checkout root (the directory that holds
``BENCHMARK.json``), so a test can point it at a copy with files added.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def check_name(name: str) -> str:
    """A name as ``BENCHMARK.json`` allows it: no slash, no space, so it
    can never point outside its folder."""
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise ValueError(f"not a valid benchmark name: {name!r}")
    return name


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], check_name(name), "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _by_name(bench["configs"], check_name(name), "config")
    with open(Path(root) / entry["file"]) as f:
        return json.load(f)


def traffic(name: str, root: Path = ROOT) -> dict:
    with open(Path(root) / "hbench" / "traffic" / f"{check_name(name)}.json") as f:
        return json.load(f)


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s entries, groups merged key by key."""
    out = dict(base)
    for key, val in over.items():
        out[key] = merged(base.get(key, {}), val) if isinstance(val, dict) else val
    return out


def _in_cell(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"] if _in_cell(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    out = []
    for m in bench["per_layer"]:
        listed = "workloads" in m
        if (listed and cell_name in m["workloads"]) or \
                (not listed and m["moves"] in e2e):
            out.append(m)
    return out


def _load_file(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The module ``hbench/metrics/<name>.py`` of an end-to-end or a
    per-layer metric; its ``read(ctx)`` returns the metric's value, or None
    where the cell gives it nothing to read."""
    path = Path(root) / "hbench" / "metrics" / f"{check_name(name)}.py"
    return _load_file(path, "hbench_metric_" + name.replace(".", "_").replace("-", "_"))


def builder(name: str, root: Path = ROOT):
    """The module ``hbench/builders/<name>.py``: ``build(cfg, data,
    device)`` -> (the configuration's backend over ``data``, its build
    seconds)."""
    path = Path(root) / "hbench" / "builders" / f"{check_name(name)}.py"
    return _load_file(path, "hbench_builder_" + name.replace(".", "_").replace("-", "_"))


def roofline(kernel: str, root: Path = ROOT):
    """The module ``hbench/roofline/<kernel>.py``: ``NAMES`` (substrings of
    the kernel's names in a profiler trace) and ``cost(**shape)`` ->
    (bytes, operations) of one launch."""
    path = Path(root) / "hbench" / "roofline" / f"{check_name(kernel)}.py"
    return _load_file(path, "hbench_roofline_" + kernel.replace(".", "_").replace("-", "_"))
