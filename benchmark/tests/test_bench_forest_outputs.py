"""The NumPy descent of forests whose leaves hold k outputs."""

import numpy as np

from benchmark.reference import forest


def _two_output_forest():
    """Two trees of depth 2 (S=7) with two outputs a leaf.  Tree 0:
    x0 <= 0.5 ? (x1 <= 0.2 ? (1, -1) : (2, -2)) : (3, -3).  Tree 1: a
    single leaf (10, 0.5)."""
    sv = np.full((2, 7), -1, np.int32)
    sl = np.zeros((2, 7), np.float32)
    lf = np.zeros((2, 7, 2), np.float32)
    sv[0, 0], sl[0, 0] = 0, 0.5
    sv[0, 1], sl[0, 1] = 1, 0.2
    lf[0, 3], lf[0, 4], lf[0, 2] = (1.0, -1.0), (2.0, -2.0), (3.0, -3.0)
    lf[0, 0] = (99.0, 99.0)        # an inner node's values are never reached
    lf[1, 0] = (10.0, 0.5)
    return sv, sl, lf


X = np.array([[0.1, 0.1], [0.5, 0.2], [0.5, 0.3], [0.9, 0.0]], np.float32)


def test_two_outputs_descend_to_k_rows_of_predictions():
    sv, sl, lf = _two_output_forest()
    got = forest.predict(sv, sl, lf, X)
    assert got.shape == (2, 4) and got.dtype == np.float64
    np.testing.assert_array_equal(got, [[11, 11, 12, 13],
                                        [-0.5, -0.5, -1.5, -2.5]])
    # each output is the one-output descent of its own leaf values
    for j in range(2):
        np.testing.assert_array_equal(got[j], forest.predict(
            sv, sl, lf[..., j], X))


def test_leading_axes_and_blocks_of_rows_keep_the_output_axis():
    sv, sl, lf = _two_output_forest()
    got = forest.predict(np.stack([sv, sv]), np.stack([sl, sl]),
                         np.stack([lf, 2 * lf]), X, block=3)
    assert got.shape == (2, 2, 4)
    np.testing.assert_array_equal(got[1], 2 * got[0])
    np.testing.assert_array_equal(got[0], forest.predict(sv, sl, lf, X))


def _walk(sv, sl, x):
    """The slot one row reaches in one tree, walked a level at a time."""
    slot, S = 0, len(sv)
    while 2 * slot + 2 < S and sv[slot] >= 0:
        slot = 2 * slot + (1 if x[sv[slot]] <= sl[slot] else 2)
    return slot


def test_descent_agrees_with_a_walk_of_each_row_in_each_tree():
    rng = np.random.default_rng(11)
    sv = rng.integers(-1, 4, size=(3, 6, 5, 31)).astype(np.int8)
    sv[:, 1:3] = sv[:, :1]            # forests that repeat their forerunner
    sv[1, 2, 4, 0] = 2                # ... but for one tree
    sl = rng.uniform(size=sv.shape).astype(np.float32)
    sl[:, 1:3] = sl[:, :1]
    sl[0, 2, 1, 0] = np.nan           # a split value that equals nothing
    Xq = rng.uniform(size=(9, 4)).astype(np.float32)
    Xq[2, 1] = np.nan                 # a NaN covariate goes right
    got = forest.leaf_slots(sv, sl, Xq)
    want = [[_walk(sv[idx], sl[idx], x) for x in Xq]
            for idx in np.ndindex(sv.shape[:-1])]
    np.testing.assert_array_equal(got.reshape(-1, len(Xq)), want)
    # a split on the last level of slots has no children: its rows stay
    assert (sv[..., 15:] >= 0).any() and got.max() <= 30
