"""Port vs reference: the tree build, its round primitives and the layout.

The same seeded numpy random walks go through ``repro.core.tree`` /
``repro.core.layout`` (JAX on the CPU) and their ports.

What must agree, and how closely:

* structure -- ``parent``, ``left``, ``right``, ``is_leaf``, ``no_split``,
  ``depth``, ``endpoints``, ``num_segs``, ``split_lo``, ``split_hi``,
  ``split_use_std``, ``count``, ``num_nodes`` -- and the layout's ``perm``,
  ``leaf_start``, ``leaf_count``, LRD and LSD: equal. The two packages'
  prefix sums round differently (see ``test_torch_summaries.py``), so a
  series within fp32 rounding of a split threshold could route the other
  way; none does on these seeds, so equality is asserted outright;
* ``split_value`` and ``synopsis`` (prefix-sum statistics): ``atol=1e-4``;
* primitives fed the *same* prefix sums and statistics: equal decisions;
  statistics within ``rtol=1e-5, atol=1e-6`` (XLA fuses the jitted round
  and may contract a multiply-add, which moves the last bit of a variance
  and, through the square root, a little more of a small std).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as JL
from repro.core import summaries as JS
from repro.core import tree as JT
from repro_torch.core import layout as TL
from repro_torch.core import tree as TT

STRUCTURE = ("parent", "left", "right", "is_leaf", "no_split", "depth", "endpoints",
             "num_segs", "split_lo", "split_hi", "split_use_std", "count", "num_nodes")


def walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=1)
    return ((x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)).astype(np.float32)


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def to_torch_tree(jt):
    return TT.HerculesTree(*[torch.from_numpy(np.array(a)) for a in jt])


def assert_trees_equal(jt, tt):
    for f in STRUCTURE:
        np.testing.assert_array_equal(np_(getattr(tt, f)), np_(getattr(jt, f)), err_msg=f)
    for f in ("split_value", "synopsis"):
        np.testing.assert_allclose(np_(getattr(tt, f)), np_(getattr(jt, f)),
                                   rtol=0, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("seed,num,length,cap", [(0, 2048, 64, 64), (1, 2048, 64, 64),
                                                 (2, 3000, 128, 100)])
def test_build_and_layout_match_reference(seed, num, length, cap):
    x = walks(seed, num, length)
    jt, jn = JT.build_tree(jnp.asarray(x), JT.BuildConfig(leaf_capacity=cap))
    tt, tn = TT.build_tree(torch.from_numpy(x), TT.BuildConfig(leaf_capacity=cap))
    assert_trees_equal(jt, tt)
    np.testing.assert_array_equal(np_(tn), np_(jn))
    assert TT.tree_stats(tt) == JT.tree_stats(jt)
    np.testing.assert_array_equal(TT.inorder_leaves(tt), JT.inorder_leaves(jt))

    jl = JL.build_layout(jt, jn, jnp.asarray(x), pad_series_to_multiple=256)
    tl = TL.build_layout(tt, tn, torch.from_numpy(x), pad_series_to_multiple=256)
    for f in ("lrd", "lsd", "perm", "inv_perm", "leaf_rank", "leaf_node", "leaf_start",
              "leaf_count", "leaf_endpoints", "leaf_seg_lens", "series_leaf_rank"):
        np.testing.assert_array_equal(np_(getattr(tl, f)), np_(getattr(jl, f)), err_msg=f)
    np.testing.assert_allclose(np_(tl.leaf_synopsis), np_(jl.leaf_synopsis), atol=1e-4)
    for f in ("series_len", "max_leaf", "num_leaves", "num_series"):
        assert getattr(tl, f) == getattr(jl, f)


def test_build_config_and_padding_options():
    # init_segments=3, not 2: with two equal halves of a z-normalized series
    # the two segment means are exact negatives, so both H-split scores tie
    # exactly and the prefix sums' last-bit rounding picks the winner --
    # the reference and the port then split a node on mirror-image segments
    x = walks(3, 600, 32)
    cfg = TT.BuildConfig(leaf_capacity=50, max_segments=8, init_segments=3, max_nodes=40)
    jt, jn = JT.build_tree(jnp.asarray(x), JT.BuildConfig(**vars(cfg)))
    tt, tn = TT.build_tree(torch.from_numpy(x), cfg)
    assert_trees_equal(jt, tt)
    assert int(tt.num_nodes) >= cfg.max_nodes - 1     # the node budget binds
    jl = JL.build_layout(jt, jn, jnp.asarray(x), sax_segments=8, pad_leaves_to=64)
    tl = TL.build_layout(tt, tn, torch.from_numpy(x), sax_segments=8, pad_leaves_to=64)
    for f in ("leaf_start", "leaf_count", "leaf_node", "lsd", "series_leaf_rank"):
        np.testing.assert_array_equal(np_(getattr(tl, f)), np_(getattr(jl, f)), err_msg=f)
    with pytest.raises(ValueError):
        TT.build_tree(torch.from_numpy(x), TT.BuildConfig(init_segments=20))


def test_round_primitives_on_shared_inputs():
    """One split round from the same prefix sums: stats, decisions, routing."""
    x = walks(4, 1500, 64)
    jp, jp2 = JS.prefix_sums(jnp.asarray(x))
    tp, tp2 = torch.from_numpy(np.array(jp)), torch.from_numpy(np.array(jp2))
    jt, jn = JT.build_tree(jnp.asarray(x), JT.BuildConfig(leaf_capacity=64, max_rounds=3))
    tt, tn = to_torch_tree(jt), torch.from_numpy(np.array(jn))

    jstats = jax.jit(JT._round_stats)(jt, jn, jp, jp2)
    tstats = TT._round_stats(tt, tn, tp, tp2)
    for name in JT.RoundStats._fields:
        np.testing.assert_allclose(np_(getattr(tstats, name)), np_(getattr(jstats, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)

    shared = TT.RoundStats(*[torch.from_numpy(np.array(a)) for a in jstats])
    jt2, jsplit = jax.jit(JT._round_decide, static_argnames=("tau",))(jt, jstats, tau=64)
    tt2, tsplit = TT._round_decide(tt, shared, tau=64)
    assert int(tsplit) == int(jsplit) > 0
    for f in STRUCTURE + ("split_value",):
        np.testing.assert_array_equal(np_(getattr(tt2, f)), np_(getattr(jt2, f)), err_msg=f)
    np.testing.assert_array_equal(np_(TT._route_members(to_torch_tree(jt2), tn, tp, tp2)),
                                  np_(jax.jit(JT._route_members)(jt2, jn, jp, jp2)))


def test_scatter_drop_and_segment_minmax_match_jax():
    arr = np.arange(6, dtype=np.int32)
    idx = np.array([2, 6, 0, 6, 5])                 # 6 == len(arr): dropped
    val = np.array([20, 60, 10, 61, 50], np.int32)
    want = np.asarray(jnp.asarray(arr).at[jnp.asarray(idx)].set(jnp.asarray(val), mode="drop"))
    got = TT._scatter_drop(torch.from_numpy(arr), torch.from_numpy(idx), torch.from_numpy(val))
    np.testing.assert_array_equal(got.numpy(), want)

    vals = np.random.default_rng(0).normal(size=(9, 3)).astype(np.float32)
    seg = np.array([0, 2, 2, 0, 4, 4, 4, 0, 2], np.int32)     # segments 1 and 3 empty
    jmn, jmx = JT._seg_minmax(jnp.asarray(vals), jnp.asarray(seg), 5)
    tmn, tmx = TT._seg_minmax(torch.from_numpy(vals), torch.from_numpy(seg), 5)
    np.testing.assert_array_equal(tmn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(tmx.numpy(), np.asarray(jmx))
    assert np.isposinf(tmn.numpy()[1]).all() and np.isneginf(tmx.numpy()[3]).all()


def test_route_to_leaf_matches_reference():
    x = walks(5, 2048, 64)
    jt, _ = JT.build_tree(jnp.asarray(x), JT.BuildConfig(leaf_capacity=64))
    depth = JT.tree_stats(jt)["max_depth"]
    q = walks(6, 40, 64)
    np.testing.assert_array_equal(
        np_(TT.route_to_leaf(to_torch_tree(jt), torch.from_numpy(q), depth)),
        np_(JT.route_to_leaf(jt, jnp.asarray(q), depth)))


def test_compute_layout_geometry_accepts_numpy_node_of():
    x = walks(7, 500, 32)
    tt, tn = TT.build_tree(torch.from_numpy(x), TT.BuildConfig(leaf_capacity=40))
    a = TL.compute_layout_geometry(tt, tn, 500, 32, pad_series_to_multiple=64)
    b = TL.compute_layout_geometry(tt, tn.numpy(), 500, 32, pad_series_to_multiple=64)
    assert a.n_pad % 64 == 0 and a.n_pad >= 500 + a.max_leaf
    np.testing.assert_array_equal(a.perm, b.perm)
