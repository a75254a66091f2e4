"""Tree tensors and prediction of the port against the JAX package:
``decide_left`` / ``subset_member`` bit for bit, ``forest_predict`` within
float tolerance (rtol 1e-5: the same gathers, one sum over trees)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymc_bart_tpu.ops import predict as jpredict
from pymc_bart_tpu.ops import trees as jtrees

from pymc_bart_tpu_torch import convert
from pymc_bart_tpu_torch.ops import predict as tpredict
from pymc_bart_tpu_torch.ops import trees as ttrees


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _i32(a):
    return np.ascontiguousarray(a).view(np.int32)


def test_subset_member_bit_for_bit():
    rng = np.random.default_rng(0)
    cats = np.concatenate([
        rng.integers(-2**31, 2**31, size=4000),
        np.arange(-50, 50), [2**31 - 1, -2**31, 0]]).astype(np.int32)
    salts = rng.integers(0, 2**32, size=cats.size, dtype=np.uint32)
    vals = np.where(rng.random(cats.size) < 0.3, cats.astype(np.float32),
                    rng.normal(size=cats.size).astype(np.float32))
    vals[::97] = np.nan
    want = np.asarray(jtrees.subset_member(
        jnp.asarray(cats), jnp.asarray(vals), jnp.asarray(_i32(salts))))
    got = ttrees.subset_member(
        torch.from_numpy(cats), torch.from_numpy(vals),
        torch.from_numpy(_i32(salts))).numpy()
    np.testing.assert_array_equal(want, got)
    assert 0.3 < got.mean() < 0.7


@pytest.mark.parametrize("rule", [0, 1, 2])
def test_decide_left_bit_for_bit(rule):
    rng = np.random.default_rng(rule)
    n = 5000
    xv = rng.integers(-3, 40, size=n).astype(np.float32)
    xv[rng.random(n) < 0.1] = np.nan
    xv[rng.random(n) < 0.05] *= 1e8           # large categories
    xv[::501] = np.inf
    val = rng.integers(-3, 40, size=n).astype(np.float32)
    val[rng.random(n) < 0.05] = np.nan
    salts = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    rules = np.full(n, rule, np.int32)
    want = np.asarray(jtrees.decide_left(
        jnp.asarray(xv), jnp.asarray(val), jnp.asarray(salts),
        jnp.asarray(rules)))
    got = ttrees.decide_left(
        torch.from_numpy(xv), torch.from_numpy(val),
        torch.from_numpy(_i32(salts)), torch.from_numpy(rules)).numpy()
    np.testing.assert_array_equal(want, got)
    assert got.any() and not got.all()


def _random_forest(rng, m, depth, p, k, rules):
    S = 2 ** (depth + 1) - 1
    sv = np.full((m, S), -1, np.int32)
    for j in range(m):
        for s in range(2**depth - 1):       # internal slots only
            parent_ok = s == 0 or sv[j, (s - 1) // 2] >= 0
            if parent_ok and rng.random() < 0.7:
                sv[j, s] = rng.integers(0, p)
    sl = rng.integers(0, 4, size=(m, S)).astype(np.float32)
    cont = rules[np.clip(sv, 0, p - 1)] == 0
    sl = np.where(cont, rng.normal(size=(m, S)), sl).astype(np.float32)
    return dict(
        split_var=sv, split_val=sl,
        split_set=rng.integers(0, 2**32, size=(m, S), dtype=np.uint32),
        leaf=rng.normal(size=(m, S, k)).astype(np.float32),
        count=rng.integers(0, 9, size=(m, S)).astype(np.float32),
        slope=(0.2 * rng.normal(size=(m, S, k))).astype(np.float32))


@pytest.mark.parametrize("k", [1, 2])
def test_forest_predict_matches_jax(k):
    rng = np.random.default_rng(5 + k)
    m, depth, n, p = 7, 4, 60, 4
    rules = np.array([0, 1, 2, 0], np.int32)
    X = rng.normal(size=(n, p)).astype(np.float32)
    X[:, 1:3] = rng.integers(0, 4, size=(n, 2))
    X[rng.random((n, p)) < 0.08] = np.nan
    f = _random_forest(rng, m, depth, p, k, rules)
    want = np.asarray(jpredict.forest_predict(
        jtrees.Forest(**{key: jnp.asarray(v) for key, v in f.items()}),
        jnp.asarray(X), jnp.asarray(rules)))
    tf = convert.state_from_numpy(f, "cpu", kind="forest")   # chain axis 1
    assert tf.split_set.dtype == torch.int32
    got = tpredict.forest_predict(tf, torch.from_numpy(X),
                                  torch.from_numpy(rules))[0].numpy()
    np.testing.assert_allclose(want, got, rtol=1e-5, atol=1e-5)
    # truncated depth and the leaf index itself
    want_idx = np.asarray(jpredict.tree_leaf_index(
        jnp.asarray(f["split_var"][0]), jnp.asarray(f["split_val"][0]),
        jnp.asarray(f["split_set"][0]), jnp.asarray(X), jnp.asarray(rules),
        2))
    got_idx = tpredict.tree_leaf_index(
        tf.split_var[0, 0], tf.split_val[0, 0], tf.split_set[0, 0],
        torch.from_numpy(X), torch.from_numpy(rules), 2).numpy()
    np.testing.assert_array_equal(want_idx, got_idx)
    # the forest round-trips through the NumPy boundary
    back = convert.state_to_numpy(tf, chain=0)
    for key, v in f.items():
        np.testing.assert_array_equal(back[key], v)
        assert back[key].dtype == v.dtype


def test_init_forest_and_level_slots_match_jax():
    want = jtrees.init_forest(3, 15, 2, jnp.asarray([0.5, -1.0]), 40)
    got = ttrees.init_forest(3, 15, 2, [0.5, -1.0], 40, "cpu")
    for name in ("split_var", "split_val", "leaf", "count", "slope"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(got, name).numpy())
    assert [ttrees.level_slots(d) for d in range(4)] == [
        jtrees.level_slots(d) for d in range(4)]
