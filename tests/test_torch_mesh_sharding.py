"""Port vs reference: the mesh (``repro_torch.launch.mesh``), the
shape-level specs on ``meta`` (``launch/specs.py``), the sharding rules
with placement (``distributed/sharding.py``), the ``maybe_shard`` hook in
every family, and ``reshard_checkpoint``.

The reference's specs come from ``jax.eval_shape`` (no allocation); its
rules take the ``_FakeMesh`` of ``tests/test_distributed.py`` (axis sizes
only), and its ``NamedSharding`` and ``with_sharding_constraint`` are
replaced, where a test needs the spec they are handed, by recorders. Shapes,
dtypes, bytes and specs must be equal; placed tensors must gather back bit
for bit. Host arrays come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.distributed import sharding as JSH
from repro.launch import mesh as JMESH
from repro.launch import specs as JSPEC
from repro.models import SHAPES
from repro.models import common as JCOMMON
from repro.models import get_model as jget_model
from repro.models import moe as JMOE
from repro.train import checkpoint as JCK
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro_torch.configs import get_config, get_smoke
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import specs as TSPEC
from repro_torch.models import common as TC
from repro_torch.models import get_model
from repro_torch.train import checkpoint as TCK
from repro_torch.train.optimizer import AdamWConfig
from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

PROD = {"data": 16, "model": 16}
PROD_POD = {"pod": 2, "data": 16, "model": 16}


class _FakeMesh:
    """Mesh stand-in for rule unit tests (shape lookup only)."""
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _ref_shapes(tree) -> dict:
    return {p: (tuple(x.shape), _dtype_name(x.dtype))
            for p, x in JSH._flatten_paths(tree).items()}


def _port_shapes(tree) -> dict:
    return {p: (tuple(x.shape), _dtype_name(x.dtype))
            for p, x in TSH.flatten_paths(tree).items()}


class _NoStorage(TorchDispatchMode):
    """Records every operation whose output is not a ``meta`` tensor."""

    def __init__(self):
        super().__init__()
        self.real = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and not t.is_meta:
                self.real.append(str(func))
        return out


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_production_mesh_is_meta_at_the_reference_shapes():
    for multi_pod, shape in ((False, PROD), (True, PROD_POD)):
        mesh = TMESH.make_production_mesh(multi_pod=multi_pod)
        assert dict(mesh.shape) == shape and list(mesh.shape) == list(shape)
        assert mesh.size == int(np.prod(list(shape.values())))
        assert {d.type for d in mesh.devices.flat} == {"meta"}
        fake = _FakeMesh(shape)
        assert TMESH.data_axes(mesh) == JMESH.data_axes(fake)
        assert TMESH.all_axes(mesh) == JMESH.all_axes(fake)


def test_host_mesh_over_a_device_list_with_repeats():
    mesh = TMESH.make_host_mesh(2, devices=["cpu"] * 4)
    assert dict(mesh.shape) == {"data": 2, "model": 2}
    assert mesh.axis_names == ("data", "model")
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert dict(TMESH.make_host_mesh(devices=["cpu"] * 3).shape) == {"data": 3, "model": 1}
    with pytest.raises(ValueError):
        TMESH.make_host_mesh(3, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        TMESH.Mesh(np.array([torch.device("cpu")] * 4, dtype=object), ("data", "model"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_host_mesh_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMESH.make_host_mesh(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMESH.make_host_mesh(1, devices=["cuda:0"] * 2)


# ---------------------------------------------------------------------------
# specs on meta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_opt_specs_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    with _NoStorage() as mode:
        spec = TSPEC.param_specs(cfg)
        opt32 = TSPEC.opt_specs(spec, AdamWConfig())
        opt8 = TSPEC.opt_specs(spec, AdamWConfig(moment_dtype="int8"))
        flat = _port_shapes(spec)
    assert not mode.real, f"{arch}: operations made real tensors: {sorted(set(mode.real))}"
    jspec = JSPEC.param_specs(jcfg)
    assert flat == _ref_shapes(jspec)
    assert TSPEC.tree_bytes(spec) == JSPEC.tree_bytes(jspec)
    for opt, jopt_cfg in ((opt32, JAdamWConfig()), (opt8, JAdamWConfig(moment_dtype="int8"))):
        jopt = JSPEC.opt_specs(jspec, jopt_cfg)
        assert _port_shapes(opt) == _ref_shapes(jopt)
        assert TSPEC.tree_bytes(opt) == JSPEC.tree_bytes(jopt)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_and_cache_specs_match_the_reference(shape):
    for arch in ARCH_NAMES:
        cfg, jcfg = get_config(arch), jget_config(arch)
        with _NoStorage() as mode:
            inputs = TSPEC.input_specs(cfg, SHAPES[shape])
            cache = TSPEC.cache_specs(cfg, SHAPES[shape])
        assert not mode.real, f"{arch}: {sorted(set(mode.real))}"
        assert _port_shapes(inputs) == _ref_shapes(JSPEC.input_specs(jcfg, SHAPES[shape]))
        jcache = JSPEC.cache_specs(jcfg, SHAPES[shape])
        assert _port_shapes(cache) == _ref_shapes(jcache), arch
        assert TSPEC.tree_bytes(cache) == JSPEC.tree_bytes(jcache)


def test_405b_param_spec_bytes_and_smoke_shapes():
    cfg = get_config("llama3-405b")
    b, n = TSPEC.tree_bytes(TSPEC.param_specs(cfg)), cfg.param_count()
    assert cfg.param_dtype == "bfloat16"
    assert abs(b - 2 * n) / (2 * n) < 0.1
    # the meta tree has the real init's shapes and dtypes
    smoke = get_smoke("codeqwen1.5-7b")
    real = get_model(smoke).init(torch.Generator().manual_seed(0), smoke)
    assert _port_shapes(TSPEC.param_specs(smoke)) == _port_shapes(real)


def test_meta_is_accepted_only_where_shapes_are_asked_for():
    from repro_torch.device import resolve_device
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("meta", shapes=True).type == "meta"


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

RULE_CASES = [
    ("blocks/attn/wq", (32, 4096, 4096), PROD, (None, "data", "model")),
    ("blocks/attn/wo", (32, 4096, 4096), PROD, (None, "model", "data")),
    ("blocks/mlp/w_gate", (4096, 16384), PROD, ("data", "model")),
    ("blocks/mlp/w_down", (16384, 4096), PROD, ("model", "data")),
    ("blocks/moe/w_gate", (24, 32, 1024, 512), PROD, (None, "model", "data", None)),
    ("embed", (49155, 1024), PROD, (None, "data")),
    ("blocks/ln_attn", (32, 1024), PROD, ()),
    ("blocks/mlp/w_down", (8192, 1024), PROD_POD, ("model", ("pod", "data"))),
]


@pytest.mark.parametrize("path,shape,axes,want", RULE_CASES)
def test_rule_cases(path, shape, axes, want):
    got = TSH.param_spec(path, shape, _FakeMesh(axes))
    assert tuple(got) == want == tuple(JSH.param_spec(path, shape, _FakeMesh(axes)))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_spec_of_every_leaf_matches_the_reference(arch):
    spec = TSPEC.param_specs(get_config(arch))
    jflat = JSH._flatten_paths(JSPEC.param_specs(jget_config(arch)))
    for axes in (PROD, PROD_POD):
        fake = _FakeMesh(axes)
        got = {p: tuple(s.spec) for p, s in
               JSH._flatten_paths(TSH.shard_params_tree(spec, fake)).items()}
        want = {p: tuple(JSH.param_spec(p, x.shape, fake)) for p, x in jflat.items()}
        assert got == want, arch


def test_batch_and_cache_shardings_match_the_reference(monkeypatch):
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    for axes in (PROD, PROD_POD, {"data": 2, "model": 4}):
        fake = _FakeMesh(axes)
        for arch in ARCH_NAMES:
            cfg, jcfg = get_config(arch), jget_config(arch)
            for shape in ("train_4k", "decode_32k"):
                got = TSH.batch_sharding(TSPEC.input_specs(cfg, SHAPES[shape]), fake)
                want = JSH.batch_sharding(JSPEC.input_specs(jcfg, SHAPES[shape]), fake)
                assert ({p: tuple(s.spec) for p, s in TSH.flatten_paths(got).items()}
                        == {p: tuple(s) for p, s in JSH._flatten_paths(want).items()})
            got = TSH.cache_sharding(TSPEC.cache_specs(cfg, SHAPES["decode_32k"]), fake)
            want = JSH.cache_sharding(JSPEC.cache_specs(jcfg, SHAPES["decode_32k"]), fake)
            assert ({p: tuple(s.spec) for p, s in TSH.flatten_paths(got).items()}
                    == {p: tuple(s) for p, s in JSH._flatten_paths(want).items()}), arch


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

PLACE_CASES = [
    ((2, 2), ("data", "model"), (None, "data", "model"), (3, 8, 12)),
    ((2, 2), ("data", "model"), ("model", "data"), (8, 6)),
    ((2, 2), ("data", "model"), (), (5, 7)),
    ((1, 4), ("data", "model"), (None, "data", "model"), (2, 4, 8)),
    ((2, 2, 2), ("pod", "data", "model"), ("model", ("pod", "data")), (6, 8)),
    ((4,), ("stage",), ("stage", None), (8, 3)),
]


@pytest.mark.parametrize("grid,axes,spec,shape", PLACE_CASES)
def test_place_and_gather_round_trip_bit_for_bit(grid, axes, spec, shape):
    rng = np.random.default_rng(7)
    host = rng.standard_normal(shape).astype(np.float32)
    host[0, 0] = -0.0
    devs = np.empty(int(np.prod(grid)), dtype=object)
    devs[:] = [torch.device("cpu")] * devs.size
    mesh = TMESH.Mesh(devs.reshape(grid), axes)
    sh = TSH.NamedSharding(mesh, TSH.P(*spec))
    placed = sh.place(host)
    assert placed.pieces.shape == grid
    for pos in np.ndindex(grid):
        piece = placed.pieces[pos]
        assert tuple(piece.shape) == sh.shard_shape(shape)
        assert not np.shares_memory(piece.numpy(), host)
        want = host[sh._slices(shape, pos)]
        assert piece.numpy().tobytes() == np.ascontiguousarray(want).tobytes()
    got = placed.gather("cpu")
    assert got.numpy().tobytes() == host.tobytes()
    tplaced = sh.place(torch.from_numpy(host.copy()))
    assert tplaced.gather().numpy().tobytes() == host.tobytes()


def test_shard_shape_refuses_what_does_not_divide():
    mesh = TMESH.make_host_mesh(2, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        TSH.NamedSharding(mesh, TSH.P("model")).shard_shape((3, 4))
    with pytest.raises(ValueError):
        TSH.NamedSharding(mesh, TSH.P("model", "model")).shard_shape((4, 4))
    with pytest.raises(ValueError):
        TSH.NamedSharding(mesh, TSH.P("stage")).shard_shape((4,))
    assert TSH.NamedSharding(mesh, TSH.P(None, ("data", "model"))).shard_shape((3, 8)) == (3, 2)


def test_reshard_checkpoint_round_trips(tmp_path):
    cfg = get_smoke("rwkv6-7b")
    params = get_model(cfg).init(torch.Generator().manual_seed(3), cfg)
    TCK.save_checkpoint(str(tmp_path), 5, {"params": params})
    state, meta = TCK.load_checkpoint(str(tmp_path), device="cpu")
    host = TSH.flatten_paths(state)
    assert meta == {"step": 5}
    for grid in ((2, 2), (1, 4)):
        mesh = TMESH.make_host_mesh(grid[1], devices=["cpu"] * 4)

        def rules(path, leaf):
            if path.endswith("ln0_w"):
                return None
            return TSH.NamedSharding(mesh, TSH.param_spec(path[len("params/"):], leaf.shape,
                                                          mesh))

        numpy_state = {p: v.numpy() for p, v in host.items()}
        placed = TSH.flatten_paths(TCK.reshard_checkpoint(
            TCK._unflatten(numpy_state), mesh, rules))
        assert set(placed) == set(host)
        for p, leaf in placed.items():
            if isinstance(leaf, torch.Tensor):
                assert p.endswith("ln0_w") and torch.equal(leaf, host[p])
                continue
            for piece in leaf.pieces.flat:
                assert tuple(piece.shape) == leaf.sharding.shard_shape(leaf.shape)
            assert leaf.gather("cpu").numpy().tobytes() == numpy_state[p].tobytes()
        sharded = [leaf for leaf in placed.values()
                   if not isinstance(leaf, torch.Tensor) and any(leaf.sharding.spec)]
        assert sharded, "no leaf was sharded"
    # the reference reads the same file and agrees
    jstate, _ = JCK.load_checkpoint(str(tmp_path))
    for p, v in JSH._flatten_paths(jstate).items():
        assert np.asarray(v).tobytes() == host[p].numpy().tobytes()


# ---------------------------------------------------------------------------
# the maybe_shard hook
# ---------------------------------------------------------------------------

HOOK_ARCHS = ["codeqwen1.5-7b", "granite-moe-1b-a400m", "phi-3-vision-4.2b", "rwkv6-7b",
              "recurrentgemma-2b", "whisper-large-v3"]


def _batch(cfg, rng, b=2, s=16):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((b, cfg.num_patches, cfg.d_patch)
                                                    ).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((b, cfg.num_frames, cfg.d_model)
                                              ).astype(np.float32)
    return batch


@pytest.fixture
def recorders(monkeypatch):
    """Installs the reference's activation hook and the port's for one
    mesh, the reference's with_sharding_constraint and NamedSharding
    replaced by recorders. Yields (reference record, port hook)."""
    fake = _FakeMesh({"data": 2, "model": 4})
    jseen = {}

    def constrain(x, spec):
        jseen[tuple(x.shape)] = spec
        return x

    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", constrain)
    names = {}
    orig = JCOMMON.maybe_shard

    def jmaybe(x, logical):
        out = orig(x, logical)
        names[(logical, tuple(x.shape))] = jseen.pop(tuple(x.shape), None)
        return out

    JSH.install_activation_hook(fake)
    # the reference's layers call common's maybe_shard; moe.py imported its own name
    monkeypatch.setattr(JCOMMON, "maybe_shard", jmaybe)
    monkeypatch.setattr(JMOE, "maybe_shard", jmaybe)
    hook = TSH.install_activation_hook(fake)
    try:
        yield names, hook
    finally:
        JSH.clear_activation_hook()
        TSH.clear_activation_hook()


@pytest.mark.parametrize("arch", HOOK_ARCHS)
def test_hook_sees_the_reference_names_and_shapes(arch, recorders):
    jnames, hook = recorders
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    rng = np.random.default_rng(11)
    batch = _batch(cfg, rng)
    jmodel, model = jget_model(jcfg), get_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    jmodel.forward(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        model.forward(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert hook.seen and set(hook.seen) == set(jnames), arch
    assert {k: tuple(v) for k, v in hook.seen.items()} == \
        {k: tuple(v) for k, v in jnames.items()}, arch


def test_hook_at_decode_sees_the_reference_names_and_shapes(recorders):
    jnames, hook = recorders
    arch = "codeqwen1.5-7b"
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    jmodel, model = jget_model(jcfg), get_model(cfg)
    batch = _batch(cfg, np.random.default_rng(2))
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    jcache = jmodel.init_cache(jcfg, 2, 32)
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(batch["tokens"])}, jcfg, jcache)
    jmodel.decode_step(jparams, jnp.asarray(batch["tokens"][:, :1]), jcfg, jcache)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        cache = model.init_cache(cfg, 2, 32, "cpu")
        _, cache = model.prefill(params, {"tokens": torch.from_numpy(batch["tokens"])}, cfg,
                                 cache)
        model.decode_step(params, torch.from_numpy(batch["tokens"][:, :1]), cfg, cache)
    assert {k: tuple(v) for k, v in hook.seen.items()} == \
        {k: tuple(v) for k, v in jnames.items()}
    assert {name for name, _ in hook.seen} >= {"kv_seq", "decode_scores", "act_btd"}


def test_no_hook_hands_back_the_same_tensor():
    TC.set_shard_hook(None)
    x = torch.zeros(2, 3)
    assert TC.maybe_shard(x, "act_btd") is x
    seen = []
    TC.set_shard_hook(lambda t, name: seen.append(name) or t)
    try:
        assert TC.maybe_shard(x, "act_ff") is x and seen == ["act_ff"]
    finally:
        TC.set_shard_hook(None)


def test_hook_does_not_change_values():
    cfg = get_smoke("granite-moe-1b-a400m")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        plain, _ = model.forward(params, {"tokens": tokens}, cfg)
        hook = TSH.install_activation_hook(TMESH.make_host_mesh(2, devices=["cpu"] * 4))
        try:
            hooked, _ = model.forward(params, {"tokens": tokens}, cfg)
        finally:
            TSH.clear_activation_hook()
    assert hook.seen and torch.equal(plain, hooked)
