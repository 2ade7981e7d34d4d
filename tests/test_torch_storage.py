"""The port's on-disk index: chunked build, format v3, and interchange with
the reference.

* The chunked build equals the port's one-shot build bit for bit (tree,
  node assignment, layout), for ragged and even chunks and both prefetch
  modes; so does a build straight to disk, loaded back.
* Broken directories (truncated, corrupted, missing files, a newer format)
  raise ``IndexFormatError``; a backend over a closed ``SavedIndex`` fails
  loudly instead of reading a dead map.
* Interchange: a directory the reference writes with the bf16 codec opens
  and serves in the port, and one the port writes opens and serves in the
  reference. Served by the two packages from the same directory, ``ooc-scan``
  and ``ooc-local`` give equal positions and ids, distances within 1e-4
  (the packages sum in different orders) and equal streaming counters. The
  two writers' manifests agree in everything but the creation time, the
  build timings and the checksums of ``tree.npz``/``layout.npz``: those hold
  split values and synopses, which the packages compute within 1e-4 of
  each other (``test_torch_tree.py``), not bit for bit.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core.engine import make_disk_backend as jax_disk_backend
from repro.core.index import IndexConfig as JIndexConfig
from repro.core.search import SearchConfig as JSearchConfig
from repro.core.tree import BuildConfig as JBuildConfig
from repro.data.pipeline import ArrayChunkSource as JArrayChunkSource
from repro.storage import build_index_to_disk as jax_build_to_disk
from repro.storage import open_index as jax_open_index
from repro.storage import partition as JPart
from repro_torch.core import engine as E
from repro_torch.core.index import HerculesIndex, IndexConfig
from repro_torch.core.search import SearchConfig
from repro_torch.core.tree import (BuildConfig, build_tree, build_tree_chunked,
                                   compute_synopses, compute_synopses_chunked)
from repro_torch.core import summaries as S
from repro_torch.data.pipeline import ArrayChunkSource
from repro_torch.storage import (FORMAT_VERSION, IndexFormatError,
                                 build_index_streaming, build_index_to_disk,
                                 load_index, open_index, save_index)
from repro_torch.storage import format as TF
from repro_torch.storage import partition as TPart
from _torch_threads import one_torch_thread  # noqa: F401

NUM, LEN = 2048, 64
CFG = IndexConfig(build=BuildConfig(leaf_capacity=64),
                  search=SearchConfig(k=3, l_max=4, chunk=256, scan_block=256))
JCFG = JIndexConfig(build=JBuildConfig(leaf_capacity=64),
                    search=JSearchConfig(k=3, l_max=4, chunk=256, scan_block=256))
BUDGET_MB = 0.125          # 2048 x 64 float32 = 0.5 MiB: 4x the budget


def walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=1)
    return ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return walks(0, NUM, LEN)


@pytest.fixture(scope="module")
def queries(data):
    rng = np.random.default_rng(1)
    return (data[rng.integers(0, NUM, 5)]
            + rng.standard_normal((5, LEN)) * np.sqrt(0.05)).astype(np.float32)


@pytest.fixture(scope="module")
def index(data):
    return HerculesIndex.build(data, CFG, device="cpu")


@pytest.fixture(scope="module")
def port_dir(data, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("port") / "idx")
    build_index_to_disk(ArrayChunkSource(data, 700), path, CFG, codec="bf16",
                        device="cpu")
    return path


@pytest.fixture(scope="module")
def jax_dir(data, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax") / "idx")
    jax_build_to_disk(JArrayChunkSource(data, 700), path, JCFG, codec="bf16")
    return path


def assert_same_tree(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# chunked build == one-shot build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,prefetch", [(700, "sync"), (512, "thread"),
                                            (NUM, "sync"), (333, "thread")])
def test_chunked_build_equals_oneshot(data, index, chunk, prefetch):
    tree, node_of = build_tree_chunked(ArrayChunkSource(data, chunk), CFG.build,
                                       prefetch=prefetch, device="cpu")
    one_tree, one_node = build_tree(torch.from_numpy(data), CFG.build)
    assert_same_tree(tree, one_tree)
    assert torch.equal(node_of, one_node)
    assert_same_tree(tree, index.tree)


def test_chunked_synopses_equal_oneshot(data, index):
    x = torch.from_numpy(data)
    _, node_of = build_tree(x, CFG.build)
    p, p2 = S.prefix_sums(x)
    one = compute_synopses(index.tree, node_of, p, p2, index.max_depth)
    chunked = compute_synopses_chunked(index.tree, node_of,
                                       ArrayChunkSource(data, 300), index.max_depth)
    assert torch.equal(one.synopsis, chunked.synopsis)


def test_streaming_index_equals_oneshot(data, index):
    idx = build_index_streaming(ArrayChunkSource(data, 700), CFG, device="cpu")
    assert_same_tree(idx.tree, index.tree)
    for f in dataclasses.fields(index.layout):
        a, b = getattr(index.layout, f.name), getattr(idx.layout, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name


@pytest.mark.parametrize("codec", ["raw", "bf16"])
def test_build_to_disk_equals_oneshot(data, index, tmp_path, codec):
    path = str(tmp_path / "idx")
    manifest = build_index_to_disk(ArrayChunkSource(data, 1024), path, CFG,
                                   codec=codec, prefetch="thread", device="cpu")
    assert manifest["version"] == FORMAT_VERSION == 3
    assert manifest["codec"]["name"] == codec
    assert manifest["extra"]["build"]["streaming"]
    loaded = load_index(path, device="cpu")
    assert_same_tree(loaded.tree, index.tree)
    for f in dataclasses.fields(index.layout):
        a, b = getattr(index.layout, f.name), getattr(loaded.layout, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name
    assert loaded.max_depth == index.max_depth
    assert loaded.config == CFG


def test_save_open_round_trip(index, tmp_path, queries):
    path = str(tmp_path / "saved")
    save_index(index, path)
    with open_index(path) as saved:
        assert saved.codec == "raw" and saved.n_pad == index.layout.lrd.shape[0]
        np.testing.assert_array_equal(saved.original_data(),
                                      index.layout.lrd[index.layout.inv_perm].numpy())
        for name in ("local", "scan"):
            got = E.make_disk_backend(name, saved, device="cpu").knn(queries)
            want = E.LocalBackend(index).knn(queries)
            assert torch.equal(got.dists, want.dists)
            assert torch.equal(got.ids.long(), want.ids.long())
    assert saved.closed


# ---------------------------------------------------------------------------
# broken files, closed handles
# ---------------------------------------------------------------------------

def _corrupt_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 16)


def _bump_version(path):
    mf = os.path.join(path, TF.MANIFEST_FILE)
    with open(mf) as f:
        m = json.load(f)
    m["version"] = FORMAT_VERSION + 1
    with open(mf, "w") as f:
        json.dump(m, f)


@pytest.mark.parametrize("damage,target,match", [
    (_corrupt_byte, TF.LRD_FILE, "checksum"),
    (_corrupt_byte, TF.ENC_FILE, "checksum"),
    (_truncate, TF.LSD_FILE, "bytes"),
    (os.remove, TF.TREE_FILE, "missing"),
    (_bump_version, None, "version"),
])
def test_broken_directory_raises(port_dir, tmp_path, damage, target, match):
    import shutil
    path = str(tmp_path / "copy")
    shutil.copytree(port_dir, path)
    damage(os.path.join(path, target) if target else path)
    with pytest.raises(IndexFormatError, match=match):
        open_index(path)


@pytest.mark.parametrize("version", [1, 2])
def test_older_versions_open_as_raw(index, tmp_path, queries, version):
    """Version-1/2 manifests (no codec, partition or journal sections) open
    unchanged, report codec ``raw`` and serve."""
    path = str(tmp_path / "old")
    save_index(index, path)
    m = _manifest(path)
    m["version"] = version
    for key in ("codec", "partition", "journal", "generation"):
        m.pop(key)
    with open(os.path.join(path, TF.MANIFEST_FILE), "w") as f:
        json.dump(m, f)
    with open_index(path) as saved:
        assert saved.codec == "raw" and saved.enc is None
        with pytest.raises(IndexFormatError, match="no encoded sidecar"):
            saved._mapped("enc")
        got = E.make_disk_backend("ooc-local", saved, memory_budget_mb=BUDGET_MB,
                                  device="cpu").knn(queries)
        assert torch.equal(got.dists, E.LocalBackend(index).knn(queries).dists)


def test_not_an_index_raises(tmp_path):
    with pytest.raises(IndexFormatError, match="not an index directory"):
        open_index(str(tmp_path))


@pytest.mark.parametrize("name", ["ooc-scan", "ooc-local"])
def test_closed_handle_fails_loudly(port_dir, queries, name):
    saved = open_index(port_dir)
    backend = E.make_disk_backend(name, saved, memory_budget_mb=BUDGET_MB,
                                  device="cpu")
    backend.knn(queries)
    saved.close()
    with pytest.raises(IndexFormatError, match="closed"):
        backend.knn(queries)


# ---------------------------------------------------------------------------
# interchange with the reference
# ---------------------------------------------------------------------------

def _manifest(path):
    with open(os.path.join(path, TF.MANIFEST_FILE)) as f:
        return json.load(f)


def test_manifests_match_reference(port_dir, jax_dir):
    port, ref = _manifest(port_dir), _manifest(jax_dir)
    assert set(port) == set(ref)
    for key in port:
        if key in ("created_unix", "files", "extra"):
            continue
        assert port[key] == ref[key], key
    assert set(port["files"]) == set(ref["files"])
    for name in (TF.LRD_FILE, TF.LSD_FILE, TF.ENC_FILE):
        assert port["files"][name] == ref["files"][name], name
    assert set(port["extra"]["build"]) == set(ref["extra"]["build"])


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8, 40])
def test_partition_plans_match_reference(port_dir, shards):
    with open_index(port_dir) as saved:
        start, count = saved.small["leaf_start"], saved.small["leaf_count"]
        got = TPart.partition_plan(start, count, shards, warn=False)
        want = JPart.partition_plan(start, count, shards, warn=False)
        assert got.to_manifest() == want.to_manifest()
        assert TPart.shard_plan(saved, shards, warn=False) == got
    assert TPart.partition_section(start, count) == JPart.partition_section(start, count)


def _serve_port(path, name, queries, k):
    with open_index(path) as saved:
        b = E.make_disk_backend(name, saved, memory_budget_mb=BUDGET_MB, device="cpu")
        r = b.knn(queries, k=k)
        return r, b.stats()


def _serve_jax(path, name, queries, k):
    with jax_open_index(path) as saved:
        b = jax_disk_backend(name, saved, memory_budget_mb=BUDGET_MB)
        r = b.knn(queries, k=k)
        return r, b.stats()


COUNTERS = ("blocks", "rows_streamed", "bytes_streamed", "sax_rows_read",
            "codec_refine_rows", "codec_fallbacks", "calls")


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", ["ooc-scan", "ooc-local"])
def test_served_by_both_packages(port_dir, jax_dir, queries, writer, name):
    path = jax_dir if writer == "jax" else port_dir
    t_res, t_st = _serve_port(path, name, queries, 3)
    j_res, j_st = _serve_jax(path, name, queries, 3)
    np.testing.assert_array_equal(t_res.positions.numpy(), np.asarray(j_res.positions))
    np.testing.assert_array_equal(t_res.ids.numpy(), np.asarray(j_res.ids))
    np.testing.assert_allclose(t_res.dists.numpy(), np.asarray(j_res.dists),
                               rtol=1e-4, atol=1e-4)
    for key in COUNTERS:
        assert t_st[key] == j_st[key], key
    assert t_st["codec"] == j_st["codec"] == "bf16"
    assert t_st["codec_refine_rows"] > 0


def test_jax_index_loads_in_port(jax_dir, queries, index):
    """The reference's directory materializes in the port and answers as
    the port's own index does (same layout; the tree differs from the
    port's build only in split values and synopses, within 1e-4)."""
    loaded = load_index(jax_dir, device="cpu")
    assert torch.equal(loaded.layout.lrd, index.layout.lrd)
    assert torch.equal(loaded.layout.perm, index.layout.perm)
    got = E.LocalBackend(loaded).knn(queries)
    want = E.LocalBackend(index).knn(queries)
    assert torch.equal(got.ids, want.ids)
    np.testing.assert_allclose(got.dists.numpy(), want.dists.numpy(), rtol=1e-4)
