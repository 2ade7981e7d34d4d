"""The port's out-of-core backends (``ooc-scan``, ``ooc-local``) against the
reference and against the port's in-memory backends.

One seeded collection (2048 x 64 float32, 0.5 MiB) is written by the port
under each codec and served at a 0.125 MiB budget, so it streams in
budget-bounded blocks.

* Against the reference, both packages serve the same directory: positions
  and ids equal, distances within 1e-4 (the packages sum in different
  orders), and the streaming counters equal.
* Within the port (the exactness contract): ``ooc-local`` distances and
  ids are bit-identical to ``LocalBackend``; ``ooc-scan`` distances are
  bit-identical to ``ScanBackend`` (ids too on this workload, which has no
  exact ties); both for ``prefetch="sync"`` and ``"thread"`` and under every
  codec, also when the codec's certify guard falls back to the raw stream.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.engine import make_disk_backend as jax_disk_backend
from repro.storage import open_index as jax_open_index
from repro_torch.core import engine as E
from repro_torch.core.index import IndexConfig
from repro_torch.core.search import SearchConfig
from repro_torch.core.tree import BuildConfig
from repro_torch.data.pipeline import ArrayChunkSource
from repro_torch.storage import build_index_to_disk, open_index
from _torch_threads import one_torch_thread  # noqa: F401

NUM, LEN = 2048, 64
SEARCH = SearchConfig(k=3, l_max=4, chunk=256, scan_block=256)
CFG = IndexConfig(build=BuildConfig(leaf_capacity=64), search=SearchConfig(
    k=3, l_max=4, chunk=256, scan_block=512))
BUDGET_MB = 0.125
CODECS = ("raw", "bf16", "sax-residual")
COUNTERS = ("calls", "blocks", "rows_streamed", "bytes_streamed", "sax_rows_read",
            "codec_refine_rows", "codec_fallbacks")


def walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=1)
    return ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return walks(7, NUM, LEN)


@pytest.fixture(scope="module")
def queries(data):
    rng = np.random.default_rng(8)
    return (data[rng.integers(0, NUM, 5)]
            + rng.standard_normal((5, LEN)) * np.sqrt(0.05)).astype(np.float32)


@pytest.fixture(scope="module")
def dirs(data, tmp_path_factory):
    root = tmp_path_factory.mktemp("ooc")
    out = {}
    for codec in CODECS:
        out[codec] = str(root / codec)
        build_index_to_disk(ArrayChunkSource(data, 1024), out[codec], CFG,
                            codec=codec, device="cpu")
    return out


@pytest.fixture(scope="module")
def memory(data):
    return {"local": E.make_backend("local", data, index_config=CFG, device="cpu"),
            "scan": E.make_backend("scan", data, search=SEARCH, device="cpu")}


def test_collection_is_4x_the_budget():
    assert NUM * LEN * 4 >= 4 * BUDGET_MB * (1 << 20)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("name", ["ooc-scan", "ooc-local"])
@pytest.mark.parametrize("k", [1, 3])
def test_matches_reference(dirs, queries, codec, name, k):
    with open_index(dirs[codec]) as saved:
        b = E.make_disk_backend(name, saved, search=SEARCH, memory_budget_mb=BUDGET_MB,
                                device="cpu")
        got, t_st = b.knn(queries, k=k), b.stats()
    with jax_open_index(dirs[codec]) as saved:
        jsearch = dataclasses.replace(saved.config.search, scan_block=SEARCH.scan_block)
        b = jax_disk_backend(name, saved, search=jsearch, memory_budget_mb=BUDGET_MB)
        want, j_st = b.knn(queries, k=k), b.stats()
    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-4, atol=1e-4)
    for key in COUNTERS:
        assert t_st[key] == j_st[key], key
    np.testing.assert_array_equal(got.path.numpy(), np.asarray(want.path))
    np.testing.assert_array_equal(got.accessed.numpy(), np.asarray(want.accessed))
    np.testing.assert_array_equal(got.visited_leaves.numpy(),
                                  np.asarray(want.visited_leaves))
    np.testing.assert_allclose(got.eapca_pr.numpy(), np.asarray(want.eapca_pr),
                               atol=1e-6)
    np.testing.assert_allclose(got.sax_pr.numpy(), np.asarray(want.sax_pr), atol=1e-6)
    if name == "ooc-local":
        assert 0 < t_st["rows_streamed"] < NUM and t_st["sax_rows_read"] > 0


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("prefetch", ["sync", "thread"])
@pytest.mark.parametrize("k", [1, 3])
def test_bit_identical_to_memory_backends(dirs, queries, memory, codec, prefetch, k):
    for name, mem in (("ooc-local", "local"), ("ooc-scan", "scan")):
        eng = E.QueryEngine(E.make_disk_backend(
            name, dirs[codec], search=SEARCH, memory_budget_mb=BUDGET_MB,
            prefetch=prefetch, device="cpu"))
        got = eng.knn(queries, k=k)
        want = E.QueryEngine(memory[mem]).knn(queries, k=k)
        assert torch.equal(got.dists, want.dists), name
        assert torch.equal(got.ids.long(), want.ids.long()), name
        tele = eng.telemetry()
        assert tele.ooc is not None and tele.queries == queries.shape[0]
        assert tele.ooc.codec_fallbacks == 0
        assert tele.ooc.read_wait_seconds >= 0.0 and tele.ooc.blocks > 0
        assert (tele.ooc.codec_refine_rows > 0) == (codec != "raw")
    assert E.QueryEngine(memory["local"]).telemetry().ooc is None


@pytest.mark.parametrize("codec", ["bf16", "sax-residual"])
@pytest.mark.parametrize("name", ["ooc-scan", "ooc-local"])
def test_forced_guard_fallback_stays_exact(dirs, queries, memory, codec, name,
                                           monkeypatch):
    # a zero candidate margin makes the LB pool exactly k wide, which the
    # certify guard (kth LB >= kth UB) rejects under a lossy codec
    monkeypatch.setattr(E, "_CAND_MARGIN", 0)
    b = E.make_disk_backend(name, dirs[codec], search=SEARCH,
                            memory_budget_mb=BUDGET_MB, device="cpu")
    got = b.knn(queries, k=3)
    want = memory["local" if name == "ooc-local" else "scan"].knn(queries, k=3)
    assert torch.equal(got.dists, want.dists)
    assert b.stats()["codec_fallbacks"] > 0


def test_codec_selection_and_bytes(dirs, queries):
    raw = E.make_disk_backend("ooc-scan", dirs["raw"], search=SEARCH,
                              memory_budget_mb=BUDGET_MB, device="cpu")
    raw.knn(queries)
    for codec in ("bf16", "sax-residual"):
        enc = E.make_disk_backend("ooc-scan", dirs[codec], search=SEARCH,
                                  memory_budget_mb=BUDGET_MB, device="cpu")
        enc.knn(queries)
        # the encoded stream plus the float32 re-check stays well under raw
        assert enc.stats()["bytes_streamed"] < 0.62 * raw.stats()["bytes_streamed"]
        forced = E.make_disk_backend(
            "ooc-scan", dirs[codec], search=dataclasses.replace(SEARCH, codec="raw"),
            memory_budget_mb=BUDGET_MB, device="cpu")
        forced.knn(queries)
        assert forced.stats()["bytes_streamed"] == raw.stats()["bytes_streamed"]
    with pytest.raises(ValueError, match="encoded with"):
        E.make_disk_backend("ooc-scan", dirs["bf16"], memory_budget_mb=BUDGET_MB,
                            device="cpu").knn(queries, codec="sax-residual")
    with pytest.raises(ValueError, match="encoded with"):
        E.make_disk_backend("ooc-local", dirs["raw"], memory_budget_mb=BUDGET_MB,
                            device="cpu").knn(queries, codec="bf16")


def test_budget_rules_and_registry(dirs, queries, memory):
    with open_index(dirs["raw"]) as saved:
        # a base scan_block larger than the budget's blocks is shrunk; an
        # explicit per-call override still fails
        ooc = E.OutOfCoreScanBackend(saved, CFG.search, memory_budget_mb=0.03,
                                     device="cpu")
        assert ooc.base_config.scan_block == ooc.stream_rows() == 61
        assert torch.equal(ooc.knn(queries).dists, memory["scan"].knn(queries).dists)
        with pytest.raises(ValueError, match="memory_budget_mb"):
            ooc.knn(queries, scan_block=512)
        with pytest.raises(ValueError, match="leaf extent"):
            E.OutOfCoreLocalBackend(saved, memory_budget_mb=0.01,
                                    device="cpu").knn(queries)
        with pytest.raises(ValueError, match="positive"):
            E.OutOfCoreScanBackend(saved, memory_budget_mb=0, device="cpu")
    # the registry in the reference's order, the sharded names included
    assert E.backend_names("disk") == ("local", "scan", "ooc-scan", "ooc-local",
                                       "dist-ooc")
    assert E.backend_names("memory") == ("local", "scan", "scan-mxu", "sharded")
    assert E.resolve_backend_name("ooc-local", kind="disk").kinds == ("disk",)
    with pytest.raises(ValueError, match="unknown backend 'sharded'"):
        E.make_disk_backend("sharded", dirs["raw"], device="cpu")
    dist = E.make_disk_backend("dist-ooc", dirs["raw"], search=SEARCH,
                               memory_budget_mb=BUDGET_MB, shards=2, device="cpu")
    assert torch.equal(dist.knn(queries).dists, memory["local"].knn(queries).dists)
    with pytest.raises(ValueError, match="unknown backend"):
        E.make_backend("ooc-scan", np.zeros((4, 64), np.float32), device="cpu")


def test_valid_rows_and_padding(dirs, queries, memory):
    """A padded batch (the serving loop's slots) certifies on its real rows
    only, and answers them as an unpadded batch does."""
    eng = E.QueryEngine(E.make_disk_backend(
        "ooc-scan", dirs["bf16"], search=SEARCH, memory_budget_mb=BUDGET_MB,
        device="cpu"))
    padded = np.concatenate([queries, np.zeros((3, LEN), np.float32)])
    got = eng.knn(padded, k=3, valid_rows=queries.shape[0])
    assert got.dists.shape == (queries.shape[0], 3)
    assert torch.equal(got.dists, memory["scan"].knn(queries, k=3).dists)
    assert eng.telemetry().ooc.codec_fallbacks == 0
