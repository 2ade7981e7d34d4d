"""Sharding in the port: the stacked index and ``sharded``, ``dist-ooc``
over the store's shard plan, the lockdep checks, and the launch counters
under threads, held against the JAX package in one process on the CPU.

Tolerances: within the port every sharded answer equals ``LocalBackend``'s
bit for bit (dists, ids, and for ``dist-ooc`` positions too). Against the
reference, ids and positions are equal and dists within
``rtol = atol = 1e-4`` (fp32 sums in another order); pruning ratios within
1e-6. The stacked index equals the reference's field by field: the integer
arrays, LRD and LSD exactly, synopses and split values within 1e-4 (the
build's documented exception).
"""
import dataclasses
import sys
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import engine as JE
from repro.core.index import IndexConfig as JIndexConfig
from repro.core.search import SearchConfig as JSearchConfig
from repro.core.tree import BuildConfig as JBuildConfig
from repro.distributed import ooc as JD
from repro.distributed.search import build_distributed_index as jax_build_dist
from repro.storage import open_index as jax_open_index
from repro.storage.partition import shard_plan as jax_shard_plan
from repro_torch import api
from repro_torch.analysis import sanitize as SZ
from repro_torch.core import engine as E
from repro_torch.core.index import IndexConfig
from repro_torch.core.layout import LAYOUT_TENSORS
from repro_torch.core.search import SearchConfig
from repro_torch.core.tree import BuildConfig
from repro_torch.device import shard_devices
from repro_torch.distributed import ooc as TD
from repro_torch.distributed.search import (build_distributed_index,
                                            distributed_knn)
from repro_torch.kernels import ed as ked
from repro_torch.kernels import lb_sax as klb
from repro_torch.kernels import wkv6 as kwkv
from repro_torch.kernels.compat import count_launch
from repro_torch.launch import build_index as cli
from repro_torch.launch import serve_knn
from repro_torch.storage import Hercules, open_index, shard_plan
from _torch_threads import one_torch_thread  # noqa: F401

NUM, LEN = 4096, 64
SHARDS = (1, 2, 4, 8)
BUDGET_MB = 0.25                 # 512-row blocks; the collection is 4 MiB
SEARCH = SearchConfig(k=5, l_max=2, chunk=128, scan_block=256)
CFG = IndexConfig(build=BuildConfig(leaf_capacity=128), search=SEARCH)
JCFG = JIndexConfig(build=JBuildConfig(leaf_capacity=128),
                    search=JSearchConfig(k=5, l_max=2, chunk=128, scan_block=256,
                                         kernel_mode="ref"))
STRUCTURE = ("parent", "left", "right", "is_leaf", "no_split", "depth", "endpoints",
             "num_segs", "split_lo", "split_hi", "split_use_std", "count", "num_nodes")
ANSWER = ("dists", "positions", "ids")


def walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=1)
    return ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)).astype(np.float32)


def assert_same(want, got, fields=ANSWER):
    for f in fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def assert_near_reference(got, want, fields=("positions", "ids")):
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def data():
    return walks(21, NUM, LEN)


@pytest.fixture(scope="module")
def queries(data):
    rng = np.random.default_rng(22)
    q = (data[rng.integers(0, NUM, 6)]
         + rng.standard_normal((6, LEN)) * np.sqrt(0.05)).astype(np.float32)
    return np.concatenate([q, walks(23, 2, LEN)])


@pytest.fixture(scope="module")
def local(data):
    return E.make_backend("local", data, index_config=CFG, device="cpu")


@pytest.fixture(scope="module")
def stacked(data):
    """The port's and the reference's stacked indexes, by shard count."""
    return {n: (build_distributed_index(data, n, CFG, device="cpu"),
                jax_build_dist(jnp.asarray(data), n, JCFG)) for n in SHARDS}


@pytest.fixture(scope="module")
def stores(data, tmp_path_factory):
    """One store a codec, with 200 journal rows pending, and each store's
    ``local`` answer over base + journal."""
    root = tmp_path_factory.mktemp("dist")
    out = {}
    for codec in ("raw", "bf16"):
        hx = Hercules.create(str(root / codec), CFG, data=data, codec=codec,
                             device="cpu")
        hx.append(walks(24, 200, LEN))
        out[codec] = hx
    yield out
    for hx in out.values():
        hx.close()


@pytest.fixture(scope="module")
def pending_answers(stores, queries):
    return {codec: hx.query(queries, backend="local") for codec, hx in stores.items()}


# ---------------------------------------------------------------------------
# the stacked index and the sharded backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", SHARDS)
def test_stacked_index_matches_reference(stacked, shards):
    got, want = stacked[shards]
    assert got.num_shards == want.num_shards == shards
    assert got.max_depth == want.max_depth
    np.testing.assert_array_equal(got.shard_offsets.numpy(),
                                  np.asarray(want.shard_offsets))
    for f in STRUCTURE:
        np.testing.assert_array_equal(getattr(got.tree, f).numpy(),
                                      np.asarray(getattr(want.tree, f)), err_msg=f)
    for f in ("split_value", "synopsis"):
        np.testing.assert_allclose(getattr(got.tree, f).numpy(),
                                   np.asarray(getattr(want.tree, f)), rtol=0,
                                   atol=1e-4, err_msg=f)
    for f in LAYOUT_TENSORS:
        g, w = getattr(got.layout, f).numpy(), np.asarray(getattr(want.layout, f))
        assert g.shape == w.shape, f
        if f == "leaf_synopsis":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)
    for f in ("series_len", "max_leaf", "num_leaves", "num_series"):
        assert getattr(got.layout, f) == getattr(want.layout, f), f


def test_sharded_one_shard_matches_reference(stacked, queries):
    got_idx, want_idx = stacked[1]
    for k in (1, 5):
        got = E.ShardedBackend(got_idx).knn(queries, k=k)
        want = JE.ShardedBackend(want_idx).knn(jnp.asarray(queries), k=k)
        assert_near_reference(got, want)
        assert bool((got.positions == -1).all())


@pytest.mark.parametrize("shards", SHARDS[1:])
def test_sharded_equals_local(stacked, local, data, queries, shards):
    """Several shards answer as the port's ``local`` bit for bit and as the
    reference's ``local`` within tolerance; ``distributed_knn`` gives the
    same answer, and ``wave=True`` serves through the regular plan."""
    jlocal = JE.make_backend("local", jnp.asarray(data), index_config=JCFG)
    idx = stacked[shards][0]
    sharded = E.ShardedBackend(idx)
    for k in (1, 5):
        want = local.knn(queries, k=k)
        eng = E.QueryEngine(sharded)
        for wave in (False, True):
            got = eng.knn(queries, k=k, wave=wave)
            assert torch.equal(got.dists, want.dists) and torch.equal(got.ids, want.ids)
        d, gid = distributed_knn(idx, queries, dataclasses.replace(SEARCH, k=k))
        assert torch.equal(d, want.dists) and torch.equal(gid, want.ids)
        assert_near_reference(got, jlocal.knn(jnp.asarray(queries), k=k), ("ids",))


def test_make_backend_sharded_and_its_errors(data, queries, local):
    sh = E.make_backend("sharded", data, index_config=CFG, num_shards=4, device="cpu")
    assert sh.describe()["num_shards"] == 4 and sh.stats()["num_series"] == NUM
    assert_same(local.knn(queries), sh.knn(queries), ("dists", "ids"))
    with pytest.raises(ValueError, match="not divisible into 3 shards"):
        E.make_backend("sharded", data, num_shards=3, device="cpu")
    with pytest.raises(ValueError, match="one entry per shard"):
        E.make_backend("sharded", data, num_shards=2, devices=["cpu"], device="cpu")
    with pytest.raises(ValueError, match="one entry per shard"):
        E.ShardedBackend(sh.stacked, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="one entry per shard"):
        distributed_knn(sh.stacked, queries, devices=["cpu"])


def test_shard_devices():
    cpu = torch.device("cpu")
    assert shard_devices(device="cpu") == [cpu]
    assert shard_devices(3, device="cpu") == [cpu] * 3
    assert shard_devices(devices=["cpu", "cpu"]) == [cpu, cpu]
    with pytest.raises(ValueError, match="one entry per shard"):
        shard_devices(2, ["cpu"])
    with pytest.raises(ValueError, match=">= 1"):
        shard_devices(0, device="cpu")


# ---------------------------------------------------------------------------
# dist-ooc: the range views, each shard against the reference's, the whole
# ---------------------------------------------------------------------------

class TestShardRows:
    def _rows(self, lo=10, hi=20):
        base = np.arange(100, dtype=np.float32).reshape(50, 2)
        audit = [hi, lo]
        return TD._ShardRows(base, lo, hi, audit), base, audit

    def test_slice_translates_and_audits(self):
        view, base, audit = self._rows()
        np.testing.assert_array_equal(view[2:5], base[12:15])
        assert view.shape == (10, 2) and len(view) == 10
        assert audit == [12, 15]
        np.testing.assert_array_equal(view[0:10], base[10:20])
        assert audit == [10, 20]

    def test_escape_raises(self):
        view, _, _ = self._rows()
        with pytest.raises(IndexError, match="escape"):
            view.take(np.array([11]))
        with pytest.raises(IndexError, match="contiguous"):
            view[0:10:2]
        with pytest.raises(TypeError):
            view[3]

    def test_take_copies_and_stays_local(self):
        view, base, audit = self._rows()
        out = np.take(view, np.array([0, 9, 3]), axis=0)
        np.testing.assert_array_equal(out, base[[10, 19, 13]])
        out[0, 0] = -1.0           # a copy: the base must not see this
        assert base[10, 0] != -1.0
        assert audit == [10, 20]


@pytest.mark.parametrize("shards", SHARDS[1:])
@pytest.mark.parametrize("codec", ["raw", "bf16"])
def test_each_shard_matches_reference(stores, queries, shards, codec):
    """Shard by shard, the port's ``OutOfCoreLocalBackend`` over its range
    view answers as the reference's over the reference's view of the same
    saved index: the same plan, positions, ids, pruning and counters."""
    path = stores[codec].path
    with open_index(path) as saved, jax_open_index(path) as jsaved:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            plan, jplan = shard_plan(saved, shards), jax_shard_plan(jsaved, shards)
        assert (plan.leaf_bounds, plan.row_bounds) == (jplan.leaf_bounds,
                                                       jplan.row_bounds)
        jsearch = JSearchConfig(k=5, l_max=2, chunk=128, scan_block=256,
                                kernel_mode="ref")
        for s in range(shards):
            view = TD._ShardView.of(saved, plan, s)
            got_b = E.OutOfCoreLocalBackend(view, SEARCH, BUDGET_MB, device="cpu")
            want_b = JE.OutOfCoreLocalBackend(JD._ShardView.of(jsaved, jplan, s),
                                              jsearch, memory_budget_mb=BUDGET_MB)
            got, want = got_b.knn(queries), want_b.knn(jnp.asarray(queries))
            assert_near_reference(got, want)
            for f in ("eapca_pr", "sax_pr"):
                np.testing.assert_allclose(getattr(got, f).numpy(),
                                           np.asarray(getattr(want, f)), atol=1e-6)
            np.testing.assert_array_equal(got.visited_leaves.numpy(),
                                          np.asarray(want.visited_leaves))
            for key in ("rows_streamed", "sax_rows_read", "codec_refine_rows",
                        "codec_fallbacks"):
                assert got_b.stats()[key] == want_b.stats()[key], (s, key)
            lo, hi = view.rows_touched()
            assert plan.row_range(s)[0] <= lo and hi <= plan.row_range(s)[1]


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("codec", ["raw", "bf16"])
@pytest.mark.parametrize("prefetch", ["sync", "thread"])
@pytest.mark.parametrize("wave", [False, True])
def test_dist_ooc_equals_local_with_journal(stores, pending_answers, queries, shards,
                                            codec, prefetch, wave):
    """The merged answer over base + pending journal equals ``local``'s bit
    for bit, and every shard reader stayed inside its row range."""
    hx = stores[codec]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = hx.query(queries, backend="dist-ooc", shards=shards,
                       memory_budget_mb=BUDGET_MB, prefetch=prefetch, wave=wave)
    assert_same(pending_answers[codec], got)
    assert (got.ids >= NUM).any()                  # the journal rows merged
    eng = hx.engine("dist-ooc", shards=shards, memory_budget_mb=BUDGET_MB)
    d = eng.telemetry().dist
    assert d.shards == shards and sum(d.rows_streamed) > 0
    for (lo, hi), touched in zip(d.row_range, d.rows_touched):
        assert touched is None or (lo <= touched[0] and touched[1] <= hi)
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith(TD.THREAD_PREFIX)]


@pytest.mark.parametrize("codec", ["raw", "bf16"])
def test_dist_ooc_one_shard_matches_reference(stores, queries, codec):
    path = stores[codec].path
    with jax_open_index(path) as jsaved:
        jsearch = dataclasses.replace(jsaved.config.search, kernel_mode="ref")
        want = JD.DistOutOfCoreBackend(jsaved, jsearch, memory_budget_mb=BUDGET_MB,
                                       shards=1).knn(jnp.asarray(queries), k=5)
    got = E.make_disk_backend("dist-ooc", path, memory_budget_mb=BUDGET_MB,
                              shards=1, device="cpu").knn(queries, k=5)
    assert_near_reference(got, want)


def test_dist_telemetry_and_cache_keys(stores, queries):
    hx = stores["raw"]
    eng = hx.engine("dist-ooc", shards=4, memory_budget_mb=BUDGET_MB)
    before = eng.telemetry().ooc.rows_streamed
    eng.knn(queries, k=3)
    t = eng.telemetry()
    d = t.dist
    assert isinstance(d, E.DistTelemetry) and t.ooc is not None
    assert d.shards == 4 and len(d.read_wait_seconds) == len(d.bytes_streamed) == 4
    assert sum(d.plan_rows) == NUM and not d.balance_warning
    assert d.imbalance >= 1.0 and d.plan_imbalance >= 1.0
    assert t.ooc.rows_streamed == sum(d.rows_streamed) > before
    assert hx.engine("ooc-local").telemetry().dist is None
    # the budget and the shard count key dist-ooc's engines; other
    # backends ignore the shard count
    assert hx.engine("dist-ooc", shards=4, memory_budget_mb=BUDGET_MB) is eng
    assert hx.engine("dist-ooc", shards=2, memory_budget_mb=BUDGET_MB) is not eng
    assert hx.engine("dist-ooc", shards=4, memory_budget_mb=0.5) is not eng
    assert hx.engine("ooc-local", shards=4) is hx.engine("ooc-local")
    # plan_signature is part of every plan key
    sig = eng.backend.plan_signature
    assert sig == ("dist-ooc", 4, ("cpu",) * 4)
    assert all(key[-1] == sig for key in eng._plans)
    assert getattr(hx.engine("ooc-local").backend, "plan_signature", None) is None
    sh = E.ShardedBackend(build_distributed_index(hx.saved.original_data(), 2, CFG,
                                                  device="cpu"))
    sh_eng = E.QueryEngine(sh)
    sh_eng.knn(queries)
    assert [key[-1] for key in sh_eng._plans] == [sh.plan_signature]
    assert sh.plan_signature[:3] == ("sharded", 2, ("cpu", "cpu"))
    with pytest.raises(ValueError, match="one entry per shard"):
        E.make_disk_backend("dist-ooc", hx.path, shards=2, devices=["cpu"] * 3)
    scores = eng.estimate_difficulty(queries)
    assert scores.shape == (queries.shape[0],) and ((0 <= scores) & (scores <= 1)).all()


def test_knn_serving_over_dist_ooc(stores, queries):
    """``KnnServeEngine`` serves mixed-k waves over a 4-shard ``dist-ooc``
    engine (wave plans, difficulty packing from the per-shard scores): every
    answer is the base ``local`` answer of its query."""
    hx = stores["bf16"]
    eng = hx.engine("dist-ooc", shards=4, memory_budget_mb=BUDGET_MB)
    local = hx.engine("local")
    serve = api.KnnServeEngine(eng, api.KnnServeConfig(batch_slots=4, wave=True,
                                                       pack="difficulty"))
    reqs = [(i % queries.shape[0], 1 + 4 * (i % 2)) for i in range(10)]
    rids = [serve.submit(queries[i], k=k) for i, k in reqs]
    got = serve.drain()
    for rid, (i, k) in zip(rids, reqs):
        want = local.knn(queries[i:i + 1], k=k)
        np.testing.assert_array_equal(got[rid].dists, want.dists[0].numpy())
        np.testing.assert_array_equal(got[rid].ids, want.ids[0].numpy())
    assert serve.telemetry().serving["difficulty_scored"] > 0


def test_a_failed_shard_raises_on_the_caller(stores, queries):
    be = E.make_disk_backend("dist-ooc", stores["raw"].path, memory_budget_mb=BUDGET_MB,
                             shards=4, device="cpu")

    def boom(q, cfg):
        raise RuntimeError("shard 2 failed")

    be._subs[2]._stream_knn = boom
    with pytest.raises(RuntimeError, match="shard 2 failed"):
        be.knn(queries)
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith(TD.THREAD_PREFIX)]


# ---------------------------------------------------------------------------
# duplicated rows: every top-k is ties, resolved as local resolves them
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dup_store(tmp_path_factory):
    """Rows duplicated 5x: duplicates share summaries, so they land in one
    leaf at adjacent file positions, the tie order every exact path must
    reproduce."""
    base = walks(25, 80, 32)
    path = str(tmp_path_factory.mktemp("dup") / "idx")
    with Hercules.create(path, IndexConfig(), data=np.repeat(base, 5, axis=0),
                         device="cpu") as hx:
        yield hx, base


@pytest.mark.parametrize("shards", SHARDS)
def test_duplicated_rows_same_ids_as_local(dup_store, shards):
    hx, base = dup_store
    q = (base[:4] + 1e-3 * np.random.default_rng(26).standard_normal((4, 32))
         ).astype(np.float32)
    want = hx.engine("local").knn(q, k=10)
    dref = want.dists.numpy()
    assert any((dref[i, :-1] == dref[i, 1:]).any() for i in range(dref.shape[0]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = hx.engine("dist-ooc", shards=shards, memory_budget_mb=8).knn(q, k=10)
    assert_same(want, got)


@settings(max_examples=10, deadline=None)
@given(row=st.integers(min_value=0, max_value=79),
       scale=st.floats(min_value=1e-4, max_value=1e-2))
def test_property_tie_merge_matches_local(dup_store, row, scale):
    hx, base = dup_store
    q = (base[row:row + 1] + np.float32(scale)).astype(np.float32)
    want = hx.engine("local").knn(q, k=10)
    got = hx.engine("dist-ooc", shards=2, memory_budget_mb=8).knn(q, k=10)
    assert_same(want, got)


# ---------------------------------------------------------------------------
# lockdep, and the launch counters under threads
# ---------------------------------------------------------------------------

@pytest.fixture
def sanitize(monkeypatch):
    monkeypatch.setenv(SZ.ENV_VAR, "1")
    SZ.LOCKDEP.reset()
    yield
    SZ.LOCKDEP.reset()


def test_lockdep_is_a_passthrough_when_off(monkeypatch):
    monkeypatch.delenv(SZ.ENV_VAR, raising=False)
    lock = threading.Lock()
    assert SZ.wrap_lock(lock, "a") is lock

    def fn():
        return 7

    assert SZ.lockdep_task(fn) is fn


def test_lockdep_task_holds_work_items_lock_free(sanitize):
    lock = SZ.wrap_lock(threading.Lock(), "slot")
    assert isinstance(lock, SZ.LockdepLock)
    assert SZ.lockdep_task(lambda x: x + 1, name="ok")(1) == 2
    with pytest.raises(SZ.HeldLockError, match="returned while still holding"):
        SZ.lockdep_task(lock.acquire, name="leaks")()
    lock.release()
    with lock:
        with pytest.raises(SZ.HeldLockError, match="entered while holding"):
            SZ.lockdep_task(lambda: None, name="carried")()


def test_lockdep_raises_on_an_abba_order(sanitize):
    a = SZ.wrap_lock(threading.Lock(), "a")
    b = SZ.wrap_lock(threading.RLock(), "b")
    with a, b:
        pass
    with b:
        with pytest.raises(SZ.LockOrderError, match="lock-order cycle"):
            a.acquire()
    assert SZ.LOCKDEP.held() == []


def test_dist_ooc_under_the_sanitizer(sanitize, stores, queries, pending_answers):
    """The shard fan-out runs through ``lockdep_task``; with the checks
    armed the answers are unchanged."""
    got = stores["bf16"].query(queries, backend="dist-ooc", shards=4,
                               memory_budget_mb=0.125, prefetch="thread")
    assert_same(pending_answers["bf16"], got)


@pytest.mark.parametrize("wrapper", [klb.lb_sax_matrix, ked.ed_min, ked.ed_matrix,
                                     ked.decode_bf16_ed_matrix, kwkv.wkv6],
                         ids=lambda w: w.__name__)
def test_launch_counters_are_exact_under_threads(wrapper):
    """8 threads add 1,000 launches each to one kernel's counter, with the
    interpreter switching threads as often as it can: exactly 8,000."""
    before = wrapper.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [count_launch(wrapper) for _ in range(1000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert wrapper.launches - before == 8000
    finally:
        sys.setswitchinterval(interval)
        wrapper.launches = before


# ---------------------------------------------------------------------------
# the entry points: the api, the CLIs
# ---------------------------------------------------------------------------

def test_api_exports():
    for name in ("ShardedBackend", "DistOutOfCoreBackend", "DistTelemetry",
                 "StackedIndex", "build_distributed_index", "distributed_knn"):
        assert hasattr(api, name), name
    assert api.backend_names("memory")[-1] == "sharded"
    assert api.backend_names("disk")[-1] == "dist-ooc"


def test_cli_dist_ooc_and_sharded_parity(tmp_path, capsys):
    idx = str(tmp_path / "idx")
    cli.main(["build", "--out", idx, "--num", "2048", "--length", "64",
              "--codec", "bf16", "--device", "cpu"])
    cli.main(["query", "--index", idx, "--backend", "dist-ooc", "--shards", "4",
              "--k", "3", "--memory-budget-mb", "0.25", "--prefetch", "thread",
              "--verify", "parity", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "dist-ooc: 4 shards streamed" in out
    assert "every shard reader stayed inside its row range" in out
    assert "dist-ooc prefetch thread==sync: bit-identical" in out
    assert "sharded (shards=4): bit-identical" in out


def test_serve_knn_cli_offers_sharded(capsys):
    serve_knn.main(["--device", "cpu", "--smoke", "--backend", "sharded", "--wave"])
    out = capsys.readouterr().out
    assert "'backend': 'sharded'" in out
    assert "smoke exactness vs brute force: OK" in out
