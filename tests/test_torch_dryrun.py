"""Port vs reference: the dry-run's cost model (``repro_torch.launch.dryrun``
and ``launch/cost_analysis.py``) and the ``meta`` recurrences it relies on.

The reference's matmul FLOPs are the ``dot_general`` FLOPs of
``jax.make_jaxpr`` of the same step (``2 |out| K`` each, times every
enclosing ``scan``'s length); the port's are ``CostCounter``'s over
``meta`` tensors. They must be equal, apart from two gaps pinned here by
closed formulas:

* RWKV-6: the port's trace has no WKV recurrence on ``meta`` (the dry-run
  adds it analytically), where the reference's jaxpr has its per-step
  ``einsum`` (``2 B T H K V`` a layer) and, in training, its two
  transposed products (and remat's recompute);
* whisper's prefill: the reference projects the cross-attention K/V twice
  a decoder layer (``repro/models/whisper.py``'s ``layer`` and again in
  ``_dec_layer_full``), the port once: ``2 x 2 B F d^2`` a layer.

And one gap of the port's plain backward (CPU tensors, outside the
dry-run): ``kernels/ref.py::wkv6_bwd_ref`` takes dk and dv as two products
with the state gradient a step where the reference's ``jax.vjp`` has one
outer product, ``2 B T H K V`` a layer more.

Collective rules are held to hand-computed cases on 2 x 2 (and 2 x 2 x 2)
meshes of ``meta`` devices; the search model (``exact_knn``'s own phases
traced on ``meta``) to ``CostCounter`` over a real CPU ``exact_knn``:
distance terms equal, the others within 0.1%.
"""
import dataclasses
import json
import math
import os
import time

import jax
import jax.extend.core
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_smoke as jget_smoke
from repro.configs import get_config as jget_config
from repro.launch import specs as JSPEC
from repro.models import get_model as jget_model
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import search as SR
from repro_torch.core import lower_bounds as LB
from repro_torch.core.index import HerculesIndex, IndexConfig
from repro_torch.data.synthetic import make_query_workload, random_walks
from repro_torch.kernels import ops
from repro_torch.launch import cost_analysis as H
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as TSPEC
from repro_torch.launch.mesh import Mesh
from repro_torch.models import SHAPES, get_model
from repro_torch.models import common as TC
from repro_torch.models.arch import ShapeConfig
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import TrainConfig, make_train_step
from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

B, S = 2, 64                        # the smoke batch and sequence
META = torch.device("meta")


def _meta_mesh(**axes) -> Mesh:
    devs = np.empty(math.prod(axes.values()), dtype=object)
    devs[:] = [META] * devs.size
    return Mesh(devs.reshape(tuple(axes.values())), tuple(axes))


ONE = _meta_mesh(data=1, model=1)
MESH22 = _meta_mesh(data=2, model=2)


# ---------------------------------------------------------------------------
# the recurrences on meta
# ---------------------------------------------------------------------------

def _wkv_inputs(device, dtype, grad):
    rng = np.random.default_rng(0)
    b, t, h, k = 2, 5, 3, 4

    def a(*shape, scale=1.0):
        x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
        return x.to(device)

    r, kk, v = a(b, t, h, k).to(dtype), a(b, t, h, k).to(dtype), a(b, t, h, k).to(dtype)
    w = torch.sigmoid(a(b, t, h, k))
    xs = (r, kk, v, w, a(h, k), a(b, h, k, k))
    return tuple(x.requires_grad_(grad) for x in xs)


def _shapes(ts):
    return [(tuple(t.shape), t.dtype) for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_recurrences_have_the_plain_versions_shapes(dtype):
    for grad in (False, True):
        cpu, meta = _wkv_inputs("cpu", dtype, grad), _wkv_inputs(META, dtype, grad)
        outs = [ops.wkv6(*xs) for xs in (cpu, meta)]
        assert _shapes(outs[0]) == _shapes(outs[1]) and all(t.is_meta for t in outs[1])
        if grad:
            grads = [torch.autograd.grad([o[0].float().sum(), o[1].sum()], xs)
                     for o, xs in zip(outs, (cpu, meta))]
            assert _shapes(grads[0]) == _shapes(grads[1])
            assert all(g.is_meta for g in grads[1])
        a, g, h0 = (x for x in _wkv_inputs("cpu", torch.float32, grad)[3:6])
        a, g, h0 = a[:, :, 0], g[0].expand(2, 5, 4), h0[:, 0, 0]
        cpu = tuple(x.detach().requires_grad_(grad) for x in (a, g, h0))
        meta = tuple(x.detach().to(META).requires_grad_(grad) for x in (a, g, h0))
        outs = [ops.rg_lru_scan(*xs) for xs in (cpu, meta)]
        assert _shapes(outs[0]) == _shapes(outs[1]) and all(t.is_meta for t in outs[1])
        if grad:
            grads = [torch.autograd.grad([o[0].sum(), o[1].sum()], xs)
                     for o, xs in zip(outs, (cpu, meta))]
            assert _shapes(grads[0]) == _shapes(grads[1])


def test_meta_prefill_at_32k_loops_over_no_step():
    cfg = dataclasses.replace(get_config("rwkv6-7b"), num_layers=1)
    model = get_model(cfg)

    def run(shape):
        args = D._step_specs(cfg, shape, None)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = model.prefill(args["params"], args["batch"], cfg, args["cache"])
        assert logits.is_meta
        return time.perf_counter() - t0

    run(ShapeConfig("warm", 8, 2, "prefill"))       # PyTorch's first meta kernels
    assert run(SHAPES["prefill_32k"]) < 1.0


# ---------------------------------------------------------------------------
# matmul FLOPs against the reference's jaxpr
# ---------------------------------------------------------------------------

def _dot_flops(jaxpr, times: int = 1) -> int:
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lhs_contract, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            k = math.prod(lhs[i] for i in lhs_contract)
            total += times * 2 * math.prod(eqn.outvars[0].aval.shape) * k
        inner = times * (eqn.params["length"] if eqn.primitive.name == "scan" else 1)
        for val in eqn.params.values():
            for sub in (val if isinstance(val, (list, tuple)) else (val,)):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    total += _dot_flops(sub.jaxpr, inner)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    total += _dot_flops(sub, inner)
    return total


def _reference_flops(cfg, shape) -> int:
    model = jget_model(cfg)
    params, batch = JSPEC.param_specs(cfg), JSPEC.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = JSPEC.opt_specs(params, JO.AdamWConfig())
        step = JS.make_train_step(model, cfg, JS.TrainConfig())
        return _dot_flops(jax.make_jaxpr(step)(params, opt, batch).jaxpr)
    cache = JSPEC.cache_specs(cfg, shape)
    if shape.kind == "prefill":
        fn = jax.make_jaxpr(lambda p, b, c: model.prefill(p, b, cfg, c))(params, batch, cache)
    else:
        fn = jax.make_jaxpr(lambda p, t, c: model.decode_step(p, t, cfg, c))(
            params, batch["tokens"], cache)
    return _dot_flops(fn.jaxpr)


def _wkv_products(cfg, b: int, t: int) -> int:
    """2 B T H K V a layer: one per-step ``einsum`` of the recurrence."""
    h = cfg.d_model // cfg.rwkv_head_size
    return 2 * b * t * h * cfg.rwkv_head_size ** 2 * cfg.num_layers


def _documented_gap(cfg, kind: str, remat: bool) -> int:
    """The reference's dot FLOPs minus the port's meta trace's."""
    t = 1 if kind == "decode" else S
    if cfg.family == "ssm":
        # forward; training adds the two transposed products and the recompute
        per = {"prefill": 1, "decode": 1, "train": 3 + remat}[kind]
        return per * _wkv_products(cfg, B, t)
    if cfg.family == "audio" and kind == "prefill":
        return 2 * 2 * B * cfg.num_frames * cfg.d_model ** 2 * cfg.num_layers
    return 0


FLOP_CASES = [(arch, kind, remat) for arch in ARCH_NAMES
              for kind, remat in (("prefill", False), ("decode", False),
                                  ("train", False), ("train", True))]


@pytest.mark.parametrize("arch,kind,remat", FLOP_CASES)
def test_matmul_flops_match_the_reference(arch, kind, remat):
    cfg = dataclasses.replace(get_smoke(arch), remat=remat)
    jcfg = dataclasses.replace(jget_smoke(arch), remat=remat)
    shape = ShapeConfig("smoke", S, B, kind)
    port, _ = D.trace_costs(cfg, shape, ONE, TrainConfig())
    want = _reference_flops(jcfg, shape) - _documented_gap(cfg, kind, remat)
    assert port.flops == want, (arch, kind, remat, port.flops, want)


def test_the_plain_wkv6_backward_has_one_product_a_step_more():
    """On CPU tensors the port's train step runs the plain recurrences, and
    its backward ``wkv6_bwd_ref`` has three products a step where the
    reference's vjp has two: 524,288 FLOPs more at the smoke config."""
    cfg = get_smoke("rwkv6-7b")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    tcfg = TrainConfig()
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    counter = H.CostCounter()
    with counter:
        make_train_step(model, cfg, tcfg)(params, adamw_init(params, tcfg.optimizer),
                                          {"tokens": torch.from_numpy(tokens)})
    shape = ShapeConfig("smoke", S, B, "train")
    gap = _wkv_products(cfg, B, S)
    assert gap == 524_288
    assert counter.total.flops == _reference_flops(jget_smoke("rwkv6-7b"), shape) + gap


# ---------------------------------------------------------------------------
# extrapolation, the recurrence term, the roofline, the specs
# ---------------------------------------------------------------------------

PROBE_CASES = [("codeqwen1.5-7b", {"num_layers": 4}),
               ("granite-moe-1b-a400m", {"num_layers": 4}),
               ("whisper-large-v3", {"num_layers": 4, "encoder_layers": 3}),
               ("rwkv6-7b", {"num_layers": 4}),
               ("recurrentgemma-2b", {"num_layers": 7})]


@pytest.mark.parametrize("arch,depth", PROBE_CASES)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_probe_extrapolation_equals_the_full_depth_trace(arch, depth, kind):
    cfg = dataclasses.replace(get_smoke(arch), remat=True, **depth)
    shape = ShapeConfig("smoke", 32, 4, kind)
    probed, _, how = D.probe_costs(cfg, shape, MESH22, TrainConfig())
    full, _ = D.trace_costs(cfg, shape, MESH22, TrainConfig())
    assert len(D._probes(cfg)) > 1 and how.startswith("probe")
    assert dataclasses.asdict(probed) == dataclasses.asdict(full)
    assert probed.flops > 0 and probed.param_bytes_device > 0


def _reference_dryrun():
    """``repro.launch.dryrun`` sets XLA_FLAGS when imported: put it back."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as JD
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return JD


def test_recurrence_term_and_cell_policy_are_the_references():
    JD = _reference_dryrun()
    for arch in ARCH_NAMES:
        for name, shape in SHAPES.items():
            assert (D._recurrence_correction(get_config(arch), shape)
                    == JD._recurrence_correction(jget_config(arch), shape)), (arch, name)
            assert D.cell_is_skipped(arch, shape) == JD.cell_is_skipped(arch, shape)
        ours, theirs = D.arch_train_config(arch), JD.arch_train_config(arch)
        assert dataclasses.asdict(ours.optimizer) == dataclasses.asdict(theirs.optimizer)


def test_roofline_terms_with_h100_constants():
    r = H.roofline_terms(flops=1e15, bytes_accessed=1e12, coll_bytes=1e9, chips=256)
    assert r.compute_s == pytest.approx(1e15 / (256 * 989e12))
    assert r.memory_s == pytest.approx(1e12 / (256 * 3.35e12))
    assert r.collective_s == pytest.approx(1e9 / (256 * 450e9))
    assert r.dominant == "compute" and r.bound_s == r.compute_s
    r2 = H.roofline_terms(flops=1e12, bytes_accessed=1e15, coll_bytes=0, chips=256)
    assert r2.dominant == "memory"
    r3 = H.roofline_terms(flops=0, bytes_accessed=0, coll_bytes=0, chips=2, other_ops=134e12)
    assert r3.compute_s == pytest.approx(1.0) and r3.dominant == "compute"


def test_full_size_spec_and_argument_bytes():
    cfg = get_config("llama3-405b")
    params = TSPEC.param_specs(cfg)
    n = cfg.param_count()
    assert abs(TSPEC.tree_bytes(params) - 2 * n) / (2 * n) < 0.1
    # a chip's parameter bytes on 16 x 16: every leaf over its shards
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    shape = SHAPES["decode_32k"]
    args = {"params": params, "batch": TSPEC.input_specs(cfg, shape),
            "cache": TSPEC.cache_specs(cfg, shape)}
    want = 0
    for path, rshape, tensors in SH._param_groups(params):
        spec = SH.param_spec(path, rshape, mesh)
        shards = math.prod(mesh.shape[a] for e in spec if e is not None
                           for a in (e if isinstance(e, tuple) else (e,)))
        want += math.prod(rshape) * tensors[0].element_size() // shards
    cache = args["cache"]
    want += (TSPEC.tree_bytes(cache) - 128 * 4) // 256   # k and v over data x model
    want += 128 * 4 + 128 * 4 // 16                      # pos (replicated), tokens
    assert D.argument_bytes(args, mesh) == want


# ---------------------------------------------------------------------------
# collectives: hand-computed cases
# ---------------------------------------------------------------------------

def _tiny_params():
    """A stacked ``blocks/attn/wq`` (1, 8, 4) (rule: fsdp, model) and a
    replicated ``ln`` (8,), float32 on meta."""
    return TC.ParamTree({"blocks": [{"attn": {"wq": torch.empty(8, 4, device=META)}}],
                         "ln": torch.empty(8, device=META)}, stacked=True)


def test_fsdp_and_gradient_collectives_by_hand():
    p = _tiny_params()
    # wq: 128 bytes over 2 model shards = 64 a device, gathered once a
    # forward; train: again for the backward and the recompute
    got = D.param_collectives(p, MESH22, train=False, remat=True)
    assert got == {**dict.fromkeys(H.COLLECTIVES, 0.0), "all-gather": 64.0}
    got = D.param_collectives(p, MESH22, train=True, remat=True)
    # reduce-scatter over data: 64 / 2; ln's gradient all-reduced whole (32)
    assert got == {**dict.fromkeys(H.COLLECTIVES, 0.0), "all-gather": 192.0,
                   "reduce-scatter": 32.0, "all-reduce": 32.0}
    assert D.param_collectives(p, MESH22, train=True, remat=False)["all-gather"] == 128.0
    # two pods: wq on (pod, data) x model; the data piece (32) once more over pod
    got = D.param_collectives(p, _meta_mesh(pod=2, data=2, model=2), train=True, remat=False)
    assert got == {**dict.fromkeys(H.COLLECTIVES, 0.0), "all-gather": 128.0,
                   "reduce-scatter": 32.0, "all-reduce": 32.0 + 32.0}


def test_tp_all_reduce_and_parameter_reads_by_hand():
    counter = H.CostCounter(MESH22)
    row = torch.empty(4, 8, device=META)      # contraction dim sharded on model
    col = torch.empty(4, 8, device=META)      # output dim sharded on model
    table = torch.empty(16, 4, device=META)   # a lookup into a row-sharded table
    counter.tag_param(row, ("model", None))
    counter.tag_param(col, (None, "model"))
    counter.tag_param(table, ("model", None))
    x = torch.empty(6, 4, device=META, requires_grad=True)
    with counter:
        y = x @ row.to(torch.bfloat16).float()      # followed through the casts
        # (6, 8) float32 = 192 bytes over the 2 data shards of its 6 rows
        assert counter.total.coll["all-reduce"] == 96.0
        z = x @ col                                 # no all-reduce forward
        assert counter.total.coll["all-reduce"] == 96.0
        torch.autograd.grad(z.sum(), x)             # dx = dz col^T contracts model
        assert counter.total.coll["all-reduce"] == 96.0 + 6 * 4 * 4 / 2
        table[torch.zeros(3, dtype=torch.long)]     # (3, 4): 48 bytes, 3 rows: 1 shard
        assert counter.total.coll["all-reduce"] == 96.0 + 48.0 + 48.0
    del y
    # every matmul read of a parameter: whole, and a device's (over model)
    assert counter.total.param_bytes == 3 * 128
    assert counter.total.param_bytes_device == 3 * 64


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_at_bf16_reads_the_parameters_copies_as_parameters(kind):
    """A serving step at bf16 over float32 parameters reads the frozen
    tree's bf16 copies (``ParamTree.mat``, made by the untraced first run):
    they keep their parameters' placement, so the step reads and
    all-reduces what it does at float32, in half the bytes but for the
    float32 head."""
    cfg32 = dataclasses.replace(get_smoke("codeqwen1.5-7b"), dtype="float32",
                                param_dtype="float32")
    shape = ShapeConfig("smoke", 32, 4, kind)
    c32, _ = D.trace_costs(cfg32, shape, MESH22)
    c16, _ = D.trace_costs(dataclasses.replace(cfg32, dtype="bfloat16"), shape, MESH22)
    head = cfg32.d_model * cfg32.vocab_size * 4
    assert c16.param_bytes > 0 and c16.coll["all-reduce"] > 0
    assert c16.param_bytes == (c32.param_bytes - head) / 2 + head
    # every matmul weight is sharded on model: a device reads its half
    assert c16.param_bytes_device == c16.param_bytes / 2
    assert c32.param_bytes_device == c32.param_bytes / 2
    assert c16.coll["all-reduce"] == c32.coll["all-reduce"] / 2


def test_all_to_all_by_hand():
    counter = H.CostCounter(MESH22)
    disp = torch.empty(2, 4, 3, 8, device=META)     # (B, E, C, d) float32: 768 bytes
    with counter:
        counter.shard_hook(disp, "moe_dispatch")    # on (data, model): 192 a device
        assert counter.total.coll["all-to-all"] == 2 * 192.0
        counter.shard_hook(disp.requires_grad_(True), "moe_dispatch")   # + transposes
        assert counter.total.coll["all-to-all"] == 2 * 192.0 + 4 * 192.0
        counter.shard_hook(disp, "act_heads")
        assert counter.total.coll["all-to-all"] == 6 * 192.0
    # a prefill's KV cache: (L, B, S, G, hd) k and v sequence-sharded on model
    cfg = get_smoke("codeqwen1.5-7b")
    shape = ShapeConfig("smoke", 16, 2, "prefill")
    k = TSPEC.cache_specs(cfg, shape)["k"]
    got = D.placement_collectives(cfg, shape, MESH22)
    assert got["all-to-all"] == 2 * k.numel() * k.element_size() / 4
    assert got["collective-permute"] == 0.0
    decode = D.placement_collectives(cfg, dataclasses.replace(shape, kind="decode"), MESH22)
    assert decode["all-to-all"] == 0.0


# ---------------------------------------------------------------------------
# the search model against the counter
# ---------------------------------------------------------------------------

SEARCH_CASES = [(4096, 64, 4, False), (8192, 128, 8, True)]


@pytest.mark.parametrize("num,n,l_max,force_refine", SEARCH_CASES)
def test_search_model_against_the_counter(num, n, l_max, force_refine, monkeypatch):
    """The model (``exact_knn``'s own phases traced on ``meta``) against the
    counter over a real CPU ``exact_knn`` on the refinement path, at the
    chunks each query ran."""
    x = random_walks(num, n, seed=0, device="cpu")
    scfg = SR.SearchConfig(chunk=256, scan_block=512, l_max=l_max, adaptive=not force_refine)
    idx = HerculesIndex.build(x, IndexConfig(search=scfg), device="cpu")
    lay = idx.layout
    queries = make_query_workload(x, 3, "5%")
    inner = {p: H.CostCounter() for p in ("distance", "lb_sax")}
    calls = []

    def counted(name, fn, record=False):
        def run(*args, **kwargs):
            if record:                  # (query, rows) of each distance call
                calls.append((args[0].data_ptr(),
                              (args[2] if len(args) > 2 and args[2] is not None
                               else args[1]).shape[0]))
            with inner[name]:           # nested: counted by both counters
                return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(SR, "_row_dists", counted("distance", SR._row_dists, record=True))
    monkeypatch.setattr(LB, "lb_sax", counted("lb_sax", LB.lb_sax))
    counter = H.CostCounter()
    with counter:
        res = SR.exact_knn(idx.tree, lay, queries, scfg, idx.max_depth)
    assert (res.path == 2).all()
    ran = {p: c.total for p, c in inner.items()}
    by_query = {}
    for ptr, rows in calls:
        by_query.setdefault(ptr, []).append(rows)
    assert len(by_query) == len(queries)
    # the model, query by query at the chunks it ran; its own distance
    # calls counted apart as the run's were
    inner.update((p, H.CostCounter()) for p in inner)
    model = {p: H.Costs() for p in ("prune", "lb_sax", "refine")}
    for rows, visits in zip(by_query.values(), res.visited_leaves.tolist()):
        assert visits == min(l_max, lay.num_leaves) + 1 and rows[0] == visits * lay.max_leaf
        for p, c in D.search_query_costs(idx.tree, lay, scfg, idx.max_depth,
                                         chunks=len(rows) - 1).items():
            model[p].add(c)
    assert dataclasses.asdict(inner["distance"].total) == dataclasses.asdict(ran["distance"])
    # LB_SAX: the plain version's operations; the kernel's bytes, at most
    # what the plain version moves
    assert model["lb_sax"].other_ops == ran["lb_sax"].other_ops
    assert 0 < model["lb_sax"].bytes <= ran["lb_sax"].bytes
    # the rest: what the model leaves out (the exit tests between chunks,
    # the access-path choice, the answers' assembly) is within 0.1%
    rest = H.Costs()
    rest.add(counter.total)
    rest.add(ran["lb_sax"], -1)
    for f in ("other_ops", "bytes"):
        got = getattr(model["prune"], f) + getattr(model["refine"], f)
        want = getattr(rest, f)
        assert abs(got - want) <= 0.001 * want, (f, got, want)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_writes_one_cell_and_the_search_cell(tmp_path, capsys):
    assert D.main(["--arch", "rwkv6-7b", "--shape", "decode_32k", "--mesh", "single",
                   "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "rwkv6-7b__decode_32k__single.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["kind"] == "decode"
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant",
                                    "bound_s"}
    assert rec["cost_analysis"]["flops_per_device"] > 0 and rec["trace_s"] >= 0
    assert D.main(["--hercules", "--mesh", "multi", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "hercules-search__multi.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 512 and rec["useful_flops_ratio"] > 0
    assert rec["collectives_per_device"]["all-gather"]["bytes"] == 512 * 100 * 8
    assert "[ok     ]" in capsys.readouterr().out
