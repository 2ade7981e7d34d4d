"""The plain reference against a hand-computed k-NN, and its TF32 control
failing the comparison (CPU, small sizes)."""
import numpy as np
import pytest
import torch

from hbench import compare, control, gen, reference


def _walks(num, n, seed):
    return gen.random_walks(num, n, gen.generator(seed, "collection", "cpu"), "cpu")


def _hand_knn(x: np.ndarray, q: np.ndarray, k: int):
    """float64 difference form over every row, ties by row."""
    d = ((x[None, :, :].astype(np.float64) - q[:, None, :]) ** 2).sum(-1)
    order = np.lexsort((np.broadcast_to(np.arange(x.shape[0]), d.shape), d), axis=-1)[:, :k]
    return np.take_along_axis(d, order, 1), order


@pytest.mark.parametrize("k", [1, 10])
def test_reference_equals_a_hand_computed_knn(k):
    x = _walks(3000, 64, 5)
    q = gen.queries(x, ["1%", "10%", "rand"] * 4, 5, "pool")
    d, rows, _ = reference.knn(x, q, k, query_block=5, row_block=700)
    want_d, want_rows = _hand_knn(x.numpy(), q.double().numpy(), k)
    assert np.array_equal(rows.numpy(), want_rows)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=1e-12)


def test_reference_tie_goes_to_the_lower_row():
    x = _walks(500, 32, 9)
    x[400] = x[17]                       # two rows at one distance from any query
    q = x[17:18] + 0.01
    d, rows, _ = reference.knn(x, q, 2, row_block=128)
    assert rows[0].tolist() == [17, 400] and d[0, 0] == d[0, 1]


def test_reference_falls_back_to_the_full_scan_where_candidates_cannot_prove():
    # every row the same distance from the query: no candidate set can prove
    # that the rows left out are farther, so the full scan answers
    x = torch.ones((200, 16))
    x[:, 0] = torch.arange(200, dtype=torch.float32) % 2     # two equal halves
    q = torch.full((1, 16), 0.5)
    q[0, 1:] = 1.0
    old = reference.CANDIDATES
    try:
        reference.CANDIDATES = 4
        d, rows, scans = reference.knn(x, q, 3, row_block=64)
    finally:
        reference.CANDIDATES = old
    assert scans == 1
    assert rows[0].tolist() == [0, 1, 2] and torch.all(d == 0.25)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0e-3])
    r = reference.round_to_tf32(x)
    assert r[0] == x[0]                       # representable
    assert r[1] == 1.0                        # a tie goes to even
    assert r[2] == 1.0 + 2 * 2.0 ** -10       # a tie goes to even (up)
    assert abs(float(r[3] - x[3])) <= 2.0 ** -11 * 3.0e-3


def test_program_like_answers_pass_and_the_control_fails():
    """At 1% noise a float32 difference-form answer reads ~1e-7; the TF32
    control reads some 1e-3 and fails the limits."""
    x = _walks(4096, 256, 3)
    q = gen.queries(x, ["1%"] * 24, 3, "pool")
    ref_d, ref_rows, _ = reference.knn(x, q, 10)
    d32 = ((x[ref_rows] - q[:, None, :]) ** 2).sum(-1)       # float32, as served
    good = compare.gaps(x, q, d32, ref_rows, ref_d)
    assert compare.passes({"gap": max(good), "unanswered": 0})
    ctl_d, ctl_rows = reference.control_knn(x, q, 10, emulate_tf32=True)
    bad = compare.gaps(x, q, ctl_d, ctl_rows, ref_d)
    assert not compare.passes({"gap": max(bad), "unanswered": 0})
    assert bad[0] > 10 * compare.LIMITS["gap"]


def test_control_script_fails_the_limits_on_a_cell():
    ov = {"config": {"num_series": 4096}, "traffic": {"pool": 64}}
    for seed in (1, 2, 3):
        nums = control.control_numbers("index-ctrl1", seed, 64, device="cpu",
                                       emulate=True, overrides=ov)
        assert not compare.passes({"gap": nums["gap"], "unanswered": 0}), nums
