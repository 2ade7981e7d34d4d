"""Dry-run of every (architecture x input-shape x mesh) cell and of the
distributed Hercules search step: the roofline terms of each on the H100
(the twin of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for its production mesh and
asks XLA. PyTorch has nothing to compile, so each cell here is a cost
model (``launch/cost_analysis.py``) over a trace on ``meta`` tensors:

* ``launch/specs.py``'s ``meta`` stand-ins (no allocation) for params,
  optimizer state, batch and cache;
* the right step (``make_train_step``, ``prefill`` or ``decode_step``)
  traced under a :class:`~repro_torch.launch.cost_analysis.CostCounter`
  at 1 and 2 layers (whisper: encoder and decoder depth apart;
  recurrentgemma: whole periods of its rec/rec/attn pattern), each count
  extrapolated linearly to full depth as the reference's
  ``_corrected_costs`` does. The recurrences give shapes only on ``meta``
  (``kernels/ops.py``) and are added analytically
  (:func:`_recurrence_correction`, the reference's), their FLOPs as
  element operations: they run outside the tensor cores;
* the collectives of the port's placements (``distributed/sharding.py``)
  by the rules of ``cost_analysis``'s docstring;
* argument bytes a chip exactly from the shard shapes, and an estimate of
  the peak bytes of live activations from the trace, over the chips;
* a record in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json`` with
  the reference's keys where they mean the same (``compile_s`` becomes
  ``trace_s``). A failing cell is a bug: the run exits non-zero.

It runs on the CPU and uses no device: it is the one entry point of the
port that needs no card. It sets no ``XLA_FLAGS``: the production mesh is
one of ``meta`` devices (``launch/mesh.py``).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --hercules
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import cost_analysis as H
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (cache_specs, input_specs, opt_specs, param_specs,
                                      tree_bytes)
from repro_torch.models import LONG_CONTEXT_ARCHS, SHAPES, get_model
from repro_torch.models import common as C
from repro_torch.models.arch import ArchConfig, ShapeConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainConfig, make_train_step

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "../../../artifacts/dryrun_torch")

# per-arch optimizer memory policy: 8-bit moments for the models where fp32
# moments cannot fit a single pod (the reference's DESIGN.md §5)
_INT8_MOMENT_ARCHS = ("llama3-405b", "granite-34b", "moonshot-v1-16b-a3b")


def arch_train_config(name: str) -> TrainConfig:
    moment = "int8" if name in _INT8_MOMENT_ARCHS else "float32"
    sched = "wsd" if name == "minicpm-2b" else "cosine"
    return TrainConfig(optimizer=AdamWConfig(moment_dtype=moment,
                                             schedule=sched))


def cell_is_skipped(arch: str, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return ("full-attention arch: 512k dense KV/attention is O(S^2) with "
                "no sub-quadratic path (DESIGN.md shape/skip matrix)")
    return None


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _opt_sharding_tree(opt_spec, params_spec, mesh):
    """Moments mirror their param's sharding. int8-packed moments use the
    blockwise-last-dim layout (optimizer.py): q (..., D/256, 256) inherits
    the param's leading-dim shardings and keeps the split dim's axis when the
    block count still divides — no resharding between gradient and moment
    update."""
    param_sh = SH.shard_params_tree(params_spec, mesh)

    def mirror(spec_sub, param_sh_sub):
        if isinstance(spec_sub, dict) and set(spec_sub) == {"q", "scale"}:
            q_shape = spec_sub["q"].shape
            pspec = tuple(param_sh_sub.spec)
            pspec = pspec + (None,) * (len(q_shape) - 1 - len(pspec))
            lead = pspec[: len(q_shape) - 2]
            last_ax = pspec[len(q_shape) - 2]
            ok = SH._fits(q_shape[-2], last_ax, mesh)
            q_spec = SH.P(*lead, last_ax if ok else None, None)
            return {"q": SH.NamedSharding(mesh, q_spec),
                    "scale": SH.NamedSharding(mesh, q_spec)}
        if isinstance(spec_sub, dict):
            return {k: mirror(v, param_sh_sub[k]) for k, v in spec_sub.items()}
        if isinstance(spec_sub, (list, tuple)):
            return type(spec_sub)(mirror(v, param_sh_sub[i])
                                  for i, v in enumerate(spec_sub))
        return param_sh_sub

    return {
        "m": mirror(opt_spec["m"], param_sh),
        "v": mirror(opt_spec["v"], param_sh),
        "step": SH.NamedSharding(mesh, SH.P()),
    }


def _recurrence_correction(cfg, shape: ShapeConfig) -> tuple[float, float]:
    """Analytic (flops, bytes) of the time recurrences (the reference's
    term, which it adds for the scan bodies XLA counts once; here the
    ``meta`` trace counts none of them).

    rwkv6 WKV step: ~4 flops per (h, k, v) element; RG-LRU step: ~6 flops per
    rnn channel. Train multiplies by 4 (fwd + remat recompute + 2x bwd).
    Bytes: the fp32 state is read+written every step.
    """
    t = 1 if shape.kind == "decode" else shape.seq_len
    if t <= 1:
        return 0.0, 0.0
    b = shape.global_batch
    mult = 4.0 if shape.kind == "train" else 1.0
    if cfg.family == "ssm":
        h = cfg.d_model // cfg.rwkv_head_size
        per_step = h * cfg.rwkv_head_size ** 2
        flops = 4.0 * per_step * (t - 1) * b * cfg.num_layers * mult
        bytes_ = 8.0 * per_step * (t - 1) * b * cfg.num_layers * mult
        return flops, bytes_
    if cfg.family == "hybrid":
        n_rec = sum(1 for k in cfg._pattern() if k == "rec")
        rnn = cfg.d_rnn or cfg.d_model
        flops = 6.0 * rnn * (t - 1) * b * n_rec * mult
        bytes_ = 8.0 * rnn * (t - 1) * b * n_rec * mult
        return flops, bytes_
    return 0.0, 0.0


# ---------------------------------------------------------------------------
# one traced step
# ---------------------------------------------------------------------------

def _step_specs(cfg: ArchConfig, shape: ShapeConfig, tcfg: TrainConfig | None) -> dict:
    """The ``meta`` arguments of the cell's step."""
    out = {"params": param_specs(cfg), "batch": input_specs(cfg, shape)}
    if shape.kind == "train":
        out["opt"] = opt_specs(out["params"], tcfg.optimizer)
    else:
        out["cache"] = cache_specs(cfg, shape)
    return out


def _run_step(cfg, shape: ShapeConfig, tcfg, args: dict):
    model = get_model(cfg)
    if shape.kind == "train":
        return make_train_step(model, cfg, tcfg)(args["params"], args["opt"], args["batch"])
    with torch.no_grad():
        if shape.kind == "prefill":
            return model.prefill(args["params"], args["batch"], cfg, args["cache"])
        return model.decode_step(args["params"], args["batch"]["tokens"], cfg, args["cache"])


def _tag_params(counter: H.CostCounter, params: C.ParamTree, mesh) -> None:
    """Mark every parameter with its placement for the TP rule and the
    parameter reads (a stacked leaf's spec without its layer axis for each
    layer's tensor), and each compute-dtype copy a frozen tree keeps of
    one (``ParamTree.mat``) with its parameter's: a serving step reads the
    copies, not the parameters."""
    for path, shape, tensors in SH._param_groups(params):
        spec = tuple(SH.param_spec(path, shape, mesh))
        if len(shape) == tensors[0].dim() + 1:      # one tensor a layer
            spec = spec[1:]
        for t in tensors:
            counter.tag_param(t, spec)
    for tree in params.modules():
        if isinstance(tree, C.ParamTree):
            for (name, _), (_, cast) in tree._casts.items():
                counter.tag_like(cast, getattr(tree, name))


def trace_costs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                tcfg: TrainConfig | None = None) -> tuple[H.Costs, float]:
    """(whole-job costs, peak live bytes) of one step of ``cfg`` at
    ``shape``, traced on ``meta`` at ``cfg``'s depth. A serving step runs
    once untraced first: the frozen tree's compute-dtype copies
    (``ParamTree.mat``) are made once, not a step."""
    args = _step_specs(cfg, shape, tcfg)
    if shape.kind != "train":
        _run_step(cfg, shape, tcfg, {**args, "cache": cache_specs(cfg, shape)})
    counter = H.CostCounter(mesh)
    _tag_params(counter, args["params"], mesh)
    C.set_shard_hook(counter.shard_hook)
    try:
        with counter:
            out = _run_step(cfg, shape, tcfg, args)
        del out
    finally:
        C.set_shard_hook(None)
    return counter.total, counter.peak


def _probes(cfg: ArchConfig) -> list[tuple[dict, float]]:
    """(depth overrides, weight a probe) such that the weighted sum of the
    probes' counts is the full depth's: cost(L) = c(a) + n (c(a+P) - c(a))
    with P the layer pattern's period and L = a + n P; whisper takes its
    encoder and decoder depths apart."""
    if cfg.family == "audio":
        e, d = cfg.encoder_layers, cfg.num_layers
        return [({"encoder_layers": 1, "num_layers": 1}, 1.0 - (e - 1) - (d - 1)),
                ({"encoder_layers": 2, "num_layers": 1}, float(e - 1)),
                ({"encoder_layers": 1, "num_layers": 2}, float(d - 1))]
    period = (len(cfg.block_pattern) or 3) if cfg.family == "hybrid" else 1
    a = cfg.num_layers % period or period
    n = (cfg.num_layers - a) // period
    if n == 0:
        return [({"num_layers": a}, 1.0)]
    return [({"num_layers": a}, 1.0 - n), ({"num_layers": a + period}, float(n))]


def probe_costs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                tcfg: TrainConfig | None = None) -> tuple[H.Costs, float, str]:
    """(costs, peak live bytes, how) of the traced part of a full-depth
    step, extrapolated from the probes of :func:`_probes`."""
    total, peak = H.Costs(), 0.0
    plan = _probes(cfg)
    for over, weight in plan:
        costs, pk = trace_costs(dataclasses.replace(cfg, **over), shape, mesh, tcfg)
        total.add(costs, weight)
        peak += weight * pk
    how = ("one full-depth trace" if len(plan) == 1 else "probe extrapolation over " + ", ".join(
        "(" + ", ".join(f"{k}={v}" for k, v in o.items()) + ")" for o, _ in plan))
    return total, peak, how


def step_costs(cfg: ArchConfig, shape: ShapeConfig, mesh,
               tcfg: TrainConfig | None = None) -> dict:
    """The costs of one step at full depth (whole-job, and collectives a
    device): the probe traces extrapolated, the recurrences' analytic
    term, the placements' collectives."""
    tcfg = tcfg or (arch_train_config(cfg.name) if shape.kind == "train" else None)
    total, peak, how = probe_costs(cfg, shape, mesh, tcfg)
    rflops, rbytes = _recurrence_correction(cfg, shape)
    total.other_ops += rflops           # not matmuls: the recurrence kernels' arithmetic
    total.bytes += rbytes
    for kind, nbytes in placement_collectives(cfg, shape, mesh).items():
        total.coll[kind] += nbytes
    return {"costs": total, "peak_bytes": peak, "tcfg": tcfg, "recurrence_flops": rflops,
            "note": how}


# ---------------------------------------------------------------------------
# collectives of the placements
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def param_collectives(params: C.ParamTree, mesh, train: bool, remat: bool) -> dict:
    """Bytes a device of the FSDP all-gathers and reduce-scatters and of the
    DP and pod gradient all-reduces of ``params``' placements
    (``cost_analysis``'s rules)."""
    out = dict.fromkeys(H.COLLECTIVES, 0.0)
    size = mesh.shape
    for path, shp, tensors in SH._param_groups(params):
        used = [a for e in SH.param_spec(path, shp, mesh) for a in _axes(e)]
        whole = (math.prod(shp) * tensors[0].element_size()
                 / math.prod(size[a] for a in used if a == "model"))
        if {"pod", "data"} & set(used):
            out["all-gather"] += (2 + remat if train else 1) * whole
            if train:
                piece = whole / size["data"]
                out["reduce-scatter"] += piece
                if "pod" in size:
                    out["all-reduce"] += piece
        elif train:
            out["all-reduce"] += whole
    return out


def placement_collectives(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """Bytes a device of the collectives of the full-depth placements: the
    parameters' (:func:`param_collectives`) and the prefill's SP cache
    all-to-all."""
    out = param_collectives(param_specs(cfg), mesh, shape.kind == "train", cfg.remat)
    if shape.kind == "prefill":
        cache = cache_specs(cfg, shape)
        shards = SH.flatten_paths(SH.cache_sharding(cache, mesh))
        for path, leaf in SH.flatten_paths(cache).items():
            spec = tuple(shards[path].spec)
            if path.split("/")[-1] in ("k", "v") and spec[leaf.dim() - 3] == "model":
                out["all-to-all"] += (math.prod(shards[path].shard_shape(leaf.shape))
                                      * leaf.element_size())
    return out


def argument_bytes(args: dict, mesh, opt_shardings=None) -> int:
    """Bytes one chip holds of the step's arguments, exactly from the
    shard shapes of their placements."""
    total = 0
    p_sh = SH.flatten_paths(SH.shard_params_tree(args["params"], mesh))
    for path, leaf in SH.flatten_paths(args["params"]).items():
        total += math.prod(p_sh[path].shard_shape(leaf.shape)) * leaf.element_size()
    rest = [(args["batch"], SH.batch_sharding(args["batch"], mesh))]
    if "opt" in args:
        rest.append((args["opt"], opt_shardings))
    if "cache" in args:
        rest.append((args["cache"], SH.cache_sharding(args["cache"], mesh)))
    for tree, shardings in rest:
        flat_sh = SH.flatten_paths(shardings)
        for path, leaf in SH.flatten_paths(tree).items():
            total += math.prod(flat_sh[path].shard_shape(leaf.shape)) * leaf.element_size()
    return total


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------

def _model_flops(cfg: ArchConfig, shape: ShapeConfig) -> tuple[float, int]:
    n_flops_params = max(cfg.active_param_count() - cfg.vocab_size * cfg.d_model, 1)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_flops_params * tokens, tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_flops_params * tokens, tokens
    tokens = shape.global_batch          # one new token per sequence
    return 2.0 * n_flops_params * tokens, tokens


def lower_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """Cost one cell. Returns the result record (dict)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = _mesh_name(multi_pod)
    skip = cell_is_skipped(arch, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": skip}
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    t0 = time.time()
    res = step_costs(cfg, shape, mesh)
    t_trace = time.time() - t0
    costs = res["costs"]

    args = _step_specs(cfg, shape, res["tcfg"])
    o_sh = (_opt_sharding_tree(args["opt"], args["params"], mesh)
            if shape.kind == "train" else None)
    state_bytes = tree_bytes(args["params"]) + tree_bytes(args.get("opt", args.get("cache")))
    mem_info = {
        "argument_bytes": argument_bytes(args, mesh, o_sh),
        "temp_bytes_estimate": res["peak_bytes"] / chips,
        "note": ("argument_bytes: exact, from the shard shapes; temp_bytes_estimate: the "
                 "peak bytes of the trace's live tensors over the chips, an estimate"),
    }
    flops, bytes_accessed = costs.flops / chips, costs.bytes_per_device(chips)
    coll = {k: {"bytes": costs.coll[k]} for k in H.COLLECTIVES}
    coll["total_bytes"] = sum(costs.coll.values())
    rf = H.roofline_terms(costs.flops, bytes_accessed * chips, coll["total_bytes"] * chips,
                          chips, other_ops=costs.other_ops)
    model_flops, tokens = _model_flops(cfg, shape)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": chips, "status": "ok", "kind": shape.kind,
        "trace_s": round(t_trace, 2),
        "param_count": cfg.param_count(), "active_param_count": cfg.active_param_count(),
        "state_bytes_global": state_bytes,
        "state_bytes_per_chip": state_bytes / chips,
        "memory_analysis": mem_info,
        "cost_analysis": {"flops_per_device": flops,
                          "bytes_per_device": bytes_accessed,
                          "other_ops_per_device": costs.other_ops / chips,
                          "recurrence_flops_per_device": res["recurrence_flops"] / chips,
                          "correction": res["note"],
                          "param_bytes_per_device": costs.param_bytes_device,
                          "bytes_note": ("eager, unfused traffic: an upper bound; a matmul's "
                                         "parameter operand read whole on every replica")},
        "collectives_per_device": coll,
        "roofline": {"compute_s": rf.compute_s, "memory_s": rf.memory_s,
                     "collective_s": rf.collective_s, "dominant": rf.dominant,
                     "bound_s": rf.bound_s},
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / max(costs.flops, 1.0),
        "tokens": tokens,
    }


# ---------------------------------------------------------------------------
# the Hercules search step
# ---------------------------------------------------------------------------
#
# The port's search cannot run whole on ``meta``: its refinement branches on
# values (``core/search.py::_refine_path``'s exit test, ``_finish_one``'s
# access path). The parts that do not branch are traced as they are, on
# ``meta`` copies of the index at the cell's shapes: ``_prune`` (phases 1-3)
# and ``_refine_order`` (the candidate sort) once a query, ``_refine_chunk``
# once a chunk, as many chunks as are counted.

_META = torch.device("meta")


def _to_meta(tree, layout) -> tuple:
    """``meta`` copies of an index's tree and layout (shapes, no storage)."""
    return (type(tree)(*(t.to(_META) for t in tree)),
            dataclasses.replace(layout, **{
                f.name: getattr(layout, f.name).to(_META) for f in dataclasses.fields(layout)
                if isinstance(getattr(layout, f.name), torch.Tensor)}))


def search_query_costs(tree, layout, cfg, max_depth: int, chunks: int) -> dict:
    """Whole costs of ``exact_knn`` for one query over ``layout`` (one chip's
    shard) on the refinement path, traced on ``meta``: ``prune`` (phases
    1-3: the l_max + 1 leaf visits, the leaf and series bounds), ``lb_sax``
    (its LB_SAX pass, apart: the plain version's element operations and
    the ``lb_sax_matrix`` kernel's bytes, codes and PAA read once and
    bounds written once) and ``refine`` (the candidate sort and ``chunks``
    chunks). The exit tests between chunks and the access-path choice are
    left out: a few element operations a query."""
    from repro_torch.core import lower_bounds as LB
    from repro_torch.core import search as SR
    from repro_torch.core import summaries as S

    tree, layout = _to_meta(tree, layout)
    q = torch.empty((layout.series_len,), dtype=layout.lrd.dtype, device=_META)
    prune, plain, refine = H.CostCounter(), H.CostCounter(), H.CostCounter()
    with prune:
        d_top, p_top, _, cand_lb, _, _, _ = SR._prune(q, tree, layout, cfg, max_depth)
    q_paa = S.paa(q[None], layout.lsd.shape[1])[0]
    with plain:                         # the pass _prune runs, alone
        lb = LB.lb_sax(q_paa, layout.lsd, layout.series_len)
    slack = torch.empty((), dtype=lb.dtype, device=_META)
    with refine:
        sorted_lb, order, _ = SR._refine_order(cand_lb, cfg)
        for c in range(chunks):
            sl = slice(c * cfg.chunk, (c + 1) * cfg.chunk)
            d_top, p_top, _ = SR._refine_chunk(q, layout, order[sl], sorted_lb[sl], slack,
                                               d_top, p_top, cfg.k)
    kernel = H.Costs(other_ops=plain.total.other_ops,
                     bytes=sum(t.numel() * t.element_size() for t in (q_paa, layout.lsd, lb)))
    prune.total.add(plain.total, -1)
    return {"prune": prune.total, "lb_sax": kernel, "refine": refine.total}


def _search_index(per: int, n: int, m: int, tau: int, n_pad: int, max_nodes: int,
                  nleaves: int) -> tuple:
    """A chip's tree and layout as ``meta`` tensors at the reference's
    shapes and the port's dtypes (``core/tree.py``, ``core/layout.py``)."""
    from repro_torch.core.layout import HerculesLayout
    from repro_torch.core.tree import HerculesTree

    i32, f32 = torch.int32, torch.float32

    def e(*shape, dtype=i32):
        return torch.empty(shape, dtype=dtype, device=_META)

    tree = HerculesTree(
        parent=e(max_nodes), left=e(max_nodes), right=e(max_nodes),
        is_leaf=e(max_nodes, dtype=torch.bool), no_split=e(max_nodes, dtype=torch.bool),
        depth=e(max_nodes), endpoints=e(max_nodes, m), num_segs=e(max_nodes),
        split_lo=e(max_nodes), split_hi=e(max_nodes),
        split_use_std=e(max_nodes, dtype=torch.bool), split_value=e(max_nodes, dtype=f32),
        synopsis=e(max_nodes, m, 4, dtype=f32), count=e(max_nodes), num_nodes=e())
    layout = HerculesLayout(
        lrd=e(n_pad, n, dtype=f32), lsd=e(n_pad, m, dtype=torch.uint8), perm=e(per),
        inv_perm=e(per), leaf_rank=e(max_nodes), leaf_node=e(nleaves),
        leaf_start=e(nleaves), leaf_count=e(nleaves), leaf_synopsis=e(nleaves, m, 4, dtype=f32),
        leaf_endpoints=e(nleaves, m), leaf_seg_lens=e(nleaves, m, dtype=f32),
        series_leaf_rank=e(n_pad), series_len=n, max_leaf=tau, num_leaves=nleaves,
        num_series=per)
    return tree, layout


def lower_hercules(multi_pod: bool, tau: int = 100_000, l_max: int = 80,
                   tag: str = "") -> dict:
    """The paper's own system at production scale: the distributed
    Hercules search step over 2M series x 256 a chip (0.5B series / ~2 TB
    on one pod, 1B / ~4 TB on two; the paper's Deep dataset is 0.27B x 96),
    100 queries, each chip answering all of them on its shard, then the
    chips' top-k all-gathered. Refinement is counted at one chunk a query,
    as the reference counts it: the chunks a query needs depend on its
    hardness, so flops and bytes are a lower bound there."""
    from repro_torch.core.search import SearchConfig

    mesh_name = _mesh_name(multi_pod)
    chips = make_production_mesh(multi_pod=multi_pod).size
    per, n, m, n_queries = 1 << 21, 256, 16, 100
    cfg = SearchConfig(k=1, l_max=l_max, chunk=4096, scan_block=8192)
    blk = cfg.pad_multiple()
    n_pad = -(-(per + tau) // blk) * blk
    max_nodes = 8 * math.ceil(per / tau) + 64
    nleaves = 2 * math.ceil(per / tau)
    max_depth = 32
    tree, layout = _search_index(per, n, m, tau, n_pad, max_nodes, nleaves)
    t0 = time.time()
    phases = search_query_costs(tree, layout, cfg, max_depth, chunks=1)
    per_chip = H.Costs()
    for c in phases.values():
        per_chip.add(c, n_queries)
    # each chip's (Q, k) answers, distances and ids, gathered to every chip
    per_chip.coll["all-gather"] = chips * n_queries * cfg.k * (
        layout.lrd.element_size() + layout.perm.element_size())
    t_model = time.time() - t0
    coll = {kind: {"bytes": per_chip.coll[kind]} for kind in H.COLLECTIVES}
    coll["total_bytes"] = sum(per_chip.coll.values())
    rf = H.roofline_terms(per_chip.flops * chips, per_chip.bytes * chips,
                          coll["total_bytes"] * chips, chips,
                          other_ops=per_chip.other_ops * chips)
    state_bytes = (tree_bytes(tree._asdict()) + tree_bytes({
        f.name: getattr(layout, f.name) for f in dataclasses.fields(layout)
        if isinstance(getattr(layout, f.name), torch.Tensor)})) * chips
    queries_bytes = n_queries * n * layout.lrd.element_size()
    scan_flops = 3.0 * n_queries * (per * chips) * n
    total_ops = (per_chip.flops + per_chip.other_ops) * chips
    return {
        "arch": "hercules-search" + tag,
        "shape": f"{per * chips}x{n}_q{n_queries}_tau{tau}_L{l_max}",
        "mesh": mesh_name, "chips": chips,
        "status": "ok", "kind": "search",
        "trace_s": round(t_model, 2),
        "state_bytes_global": state_bytes,
        "state_bytes_per_chip": state_bytes / chips,
        "memory_analysis": {"argument_bytes": state_bytes / chips + queries_bytes,
                            "note": "argument_bytes: the layout, tree and queries a chip"},
        "cost_analysis": {"flops_per_device": per_chip.flops,
                          "bytes_per_device": per_chip.bytes,
                          "other_ops_per_device": per_chip.other_ops,
                          "by_phase_per_device": {
                              p: {"other_ops": c.other_ops * n_queries,
                                  "bytes": c.bytes * n_queries} for p, c in phases.items()}},
        "collectives_per_device": coll,
        "roofline": {"compute_s": rf.compute_s, "memory_s": rf.memory_s,
                     "collective_s": rf.collective_s,
                     "dominant": rf.dominant, "bound_s": rf.bound_s},
        "model_flops": scan_flops,
        "useful_flops_ratio": scan_flops / max(total_ops, 1.0),
        "note": ("exact_knn's own phases traced on meta at a chip's shapes (the search "
                 "branches on values between them); model_flops = PSCAN-equivalent "
                 "exact-scan FLOPs, ratio > 1 quantifies index pruning; refinement counted "
                 "at one chunk a query (lower bound)"),
        "tokens": n_queries,
    }


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _write(out_dir: str, tag: str, rec: dict) -> None:
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--hercules", action="store_true",
                    help="dry-run the distributed Hercules search step")
    ap.add_argument("--herc-tau", type=int, default=100_000)
    ap.add_argument("--herc-lmax", type=int, default=80)
    ap.add_argument("--herc-tag", default="")
    ap.add_argument("--herc-refine", default="argsort", choices=("argsort", "topk"),
                    help="the reference's refine_select; no effect here: the port sorts "
                         "every candidate either way and one chunk is counted")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)
    meshes = {"single": (False,), "multi": (True,), "both": (False, True)}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    t_all = time.time()

    if args.hercules:
        if args.herc_refine != "argsort":
            print(f"[note] --herc-refine {args.herc_refine} has no effect on the port's "
                  f"costs: it sorts every candidate either way", flush=True)
        for mp in meshes:
            tag = f"hercules-search{args.herc_tag}__{'multi' if mp else 'single'}"
            try:
                rec = lower_hercules(mp, tau=args.herc_tau, l_max=args.herc_lmax,
                                     tag=args.herc_tag)
            except Exception as e:      # a failing cell is reported, the run goes on
                traceback.print_exc()
                rec = {"arch": "hercules-search", "shape": "search", "mesh": _mesh_name(mp),
                       "status": "error", "error": f"{type(e).__name__}: {e}"}
                failures += 1
            _write(args.out, tag, rec)
            extra = ""
            if rec["status"] == "ok":
                r = rec["roofline"]
                extra = (f" dominant={r['dominant']} bound={r['bound_s']:.4g}s"
                         f" prune_ratio={rec['useful_flops_ratio']:.1f}x")
            print(f"[{rec['status']:7s}] {tag}{extra}", flush=True)
    else:
        archs = ARCH_NAMES if (args.all or not args.arch) else (args.arch,)
        shapes = tuple(SHAPES) if (args.all or not args.shape) else (args.shape,)
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                    try:
                        rec = lower_cell(arch, shape, mp)
                    except Exception as e:      # a failing cell is reported, the run goes on
                        traceback.print_exc()
                        rec = {"arch": arch, "shape": shape, "mesh": _mesh_name(mp),
                               "status": "error", "error": f"{type(e).__name__}: {e}"}
                        failures += 1
                    _write(args.out, tag, rec)
                    extra = ""
                    if rec["status"] == "ok":
                        r = rec["roofline"]
                        extra = (f" dominant={r['dominant']} bound={r['bound_s']:.4g}s"
                                 f" state/chip={rec['state_bytes_per_chip'] / 2**30:.2f}GiB"
                                 f" trace={rec['trace_s']:.1f}s")
                    print(f"[{rec['status']:7s}] {tag}{extra}", flush=True)
    print(f"[done] {time.time() - t_all:.1f}s, {failures} failed", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
