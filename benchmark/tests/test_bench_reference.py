"""The frozen generator, the NumPy descent and the check's numbers."""

import numpy as np

from benchmark.reference import check, forest, friedman1


def test_friedman_true_function_by_hand():
    X = np.zeros((3, 10), np.float32)
    X[0, :5] = [0.5, 0.5, 0.5, 1.0, 1.0]
    X[1, :5] = [1.0, 0.5, 0.0, 0.0, 0.0]
    X[2, :5] = [0.0, 0.0, 1.0, 0.5, 0.25]
    want = [10 * np.sin(np.pi / 4) + 0 + 10 + 5,       # 22.0710678
            10 * np.sin(np.pi / 2) + 20 * 0.25,        # 15
            0 + 20 * 0.25 + 5 + 1.25]                  # 11.25
    np.testing.assert_allclose(friedman1.true_f(X), want, rtol=1e-12)
    np.testing.assert_allclose(want[0], 22.071067811865476)


def test_friedman_generate_draws_in_bench_order():
    X, Y, f = friedman1.generate(4, 10, seed=123)
    rng = np.random.default_rng(123)
    X0 = rng.uniform(size=(4, 10)).astype(np.float32)
    noise = rng.normal(0, 1.0, 4)
    np.testing.assert_array_equal(X, X0)
    np.testing.assert_array_equal(
        Y, (friedman1.true_f(X0) + noise).astype(np.float32))
    assert X.dtype == np.float32 and Y.dtype == np.float32 and f.shape == (4,)


def _hand_forest():
    """Two trees of depth 2 (S=7).  Tree 0: x0 <= 0.5 ? (x1 <= 0.2 ? 1 : 2)
    : 3.  Tree 1: a single leaf 10."""
    sv = np.full((2, 7), -1, np.int32)
    sl = np.zeros((2, 7), np.float32)
    lf = np.zeros((2, 7), np.float32)
    sv[0, 0], sl[0, 0] = 0, 0.5
    sv[0, 1], sl[0, 1] = 1, 0.2
    lf[0, 3], lf[0, 4], lf[0, 2] = 1.0, 2.0, 3.0
    lf[0, 0] = 99.0          # an inner node's value is never reached
    lf[1, 0] = 10.0
    return sv, sl, lf


def test_descent_on_hand_built_trees():
    sv, sl, lf = _hand_forest()
    X = np.array([[0.1, 0.1], [0.5, 0.2], [0.5, 0.3], [0.9, 0.0]],
                 np.float32)
    np.testing.assert_array_equal(forest.leaf_slots(sv, sl, X),
                                  [[3, 3, 4, 2], [0, 0, 0, 0]])
    np.testing.assert_array_equal(forest.predict(sv, sl, lf, X),
                                  [11.0, 11.0, 12.0, 13.0])
    # leading axes and a trailing output axis, in blocks of one row
    got = forest.predict(np.stack([sv, sv]), np.stack([sl, sl]),
                         np.stack([lf, 2 * lf])[..., None], X, block=1)
    np.testing.assert_array_equal(got, [[11, 11, 12, 13], [22, 22, 24, 26]])


def test_jitter_matches_the_program():
    from pymc_bart_tpu_torch.sampler.compound import _jitter_duplicate_values

    rng = np.random.default_rng(0)
    X = rng.uniform(size=(50, 3)).astype(np.float32)
    X[10:20, 1] = X[0, 1]
    X[30:33, 2] = X[5, 2]
    got = forest.jitter_duplicates(X, 77)
    np.testing.assert_array_equal(got[:, 0], X[:, 0])
    assert (got[10:20, 1] != X[0, 1]).any()
    np.testing.assert_array_equal(
        got, _jitter_duplicate_values(X, np.zeros(3, np.int32), 77))


def _outputs(chains=2, draws=3):
    sv, sl, lf = _hand_forest()
    X = np.array([[0.1, 0.1], [0.5, 0.3], [0.9, 0.0]], np.float32)
    tile = (chains, draws, 1, 1)
    out = {"split_var": np.tile(sv, tile), "split_val": np.tile(sl, tile),
           "leaf": np.tile(lf, tile)[..., None].copy(), "random_seed": 5}
    out["leaf"][1] += 0.5                       # chain 1: every leaf + 0.5
    mu = forest.predict(out["split_var"], out["split_val"], out["leaf"], X)
    out["mu"] = mu.astype(np.float32)
    out["sigma"] = np.ones((chains, draws), np.float32)
    return out, X


def test_check_numbers_of_consistent_and_broken_outputs():
    out, X = _outputs()
    f = out["mu"].mean(axis=(0, 1)).astype(np.float64)
    Y = f + np.array([1.0, -1.0, 1.0])
    idx = check.sample_draws(np.random.default_rng(0), 2, 3, 6)
    assert len(idx) == 6
    rows = check.sample_rows(np.random.default_rng(1), 3, 2)
    nums = check.fit_numbers(out, X, Y, f, idx, rows)
    assert nums["mu_gap"] == 0.0 and nums["rmse_f"] < 1e-6
    assert check.structure_errors(out, 2, 3, 3, 2) == 0
    out["mu"][1, 2, :] += 0.25
    assert check.fit_numbers(out, X, Y, f, idx[:1], rows)["mu_gap"] == \
        np.float32(0.25) / np.std(Y)
    out["mu"][1] = out["mu"][0]                  # chain 1 repeats chain 0
    assert check.structure_errors(out, 2, 3, 3, 2) == 1
    assert check.structure_errors(out, 2, 4, 3, 2) > 0
