"""The sums of the port that reach a discrete decision (``ops/sums.py``):
float64 rounded once, and fixed point keyed by node, which has no order of
addition.  The whole-step kernel takes the same sums the same way, so these
tests pin the arithmetic both sides share."""

import numpy as np
import pytest
import torch

from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
from pymc_bart_tpu_torch.ops import sums
from pymc_bart_tpu_torch.sampler import pgbart


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sum64_is_the_float64_sum_rounded_once():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5000)) * 10.0 ** rng.integers(-3, 4, (3, 5000))
         ).astype(np.float32)
    want = x.astype(np.float64).sum(axis=1).astype(np.float32)
    got = sums.sum64(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    got0 = sums.sum64(torch.from_numpy(x), dim=0).numpy()
    np.testing.assert_array_equal(
        got0, x.astype(np.float64).sum(axis=0).astype(np.float32))


@pytest.mark.parametrize("top", [0.0, 1e-30, 0.75, 1.0, 3.5, 4096.0, 1e20])
def test_fixed_scale_gives_the_largest_residual_38_bits(top):
    r = torch.tensor([[[0.25 * top, -top, 0.5 * top]],
                      [[0.0, 0.0, 0.0]]], dtype=torch.float32)
    scale, inverse = sums.fixed_scale(r)
    assert scale.dtype == torch.float64 and tuple(scale.shape) == (2,)
    assert bool((scale * inverse == 1.0).all())
    mant, _e = np.frexp(scale.numpy())
    np.testing.assert_array_equal(mant, 0.5)            # powers of two
    assert float(scale[1]) == 2.0 ** sums.FIXED_BITS    # an all-zero chain
    top32 = float(np.float32(top))
    if top32 > 0:
        assert 2.0 ** 37 <= top32 * float(scale[0]) < 2.0 ** 38


def test_keyed_sum_fixed_has_no_order_and_skips_foreign_keys():
    rng = np.random.default_rng(1)
    C, k, n, P, K = 2, 1, 4000, 3, 6
    vals = (rng.normal(size=(C, k, n)) * 5).astype(np.float32)
    keys = rng.integers(-2, K + 2, size=(C, P, n))
    scale, inverse = sums.fixed_scale(torch.from_numpy(vals))
    got = sums.keyed_sum_fixed(torch.from_numpy(vals), torch.from_numpy(keys),
                               K, scale, inverse)
    assert got.dtype == torch.float32 and tuple(got.shape) == (C, P, k, K)
    want = np.zeros((C, P, k, K))
    for c in range(C):
        for q in range(P):
            for g in range(K):
                want[c, q, 0, g] = vals[c, 0, keys[c, q] == g].astype(
                    np.float64).sum()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # another order of the rows: the same bits
    perm = rng.permutation(n)
    again = sums.keyed_sum_fixed(
        torch.from_numpy(vals[:, :, perm].copy()),
        torch.from_numpy(keys[:, :, perm].copy()), K, scale, inverse)
    assert torch.equal(got, again)
    # the integers are what the kernel adds: round-half-even of r * scale
    c, q, g = 1, 2, 3
    sel = vals[c, 0, keys[c, q] == g].astype(np.float64)
    exact = int(np.rint(sel * float(scale[c])).astype(np.int64).sum())
    assert float(got[c, q, 0, g]) == float(np.float32(
        float(exact) * float(inverse[c])))


def test_plain_step_does_not_depend_on_the_order_of_the_rows():
    """Fixed-point and float64 sums: permuting the rows (data and row Gumbels
    alike) leaves every decision and every leaf of a step as it was."""
    rng = np.random.default_rng(2)
    n, p, C, P, D, m = 120, 3, 2, 5, 3, 4
    X = rng.uniform(size=(n, p)).astype(np.float32)
    Y = (np.sin(3 * X[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    cfg = BartConfig(m=m, max_depth=D)
    pg = PgbartConfig(num_particles=P, batch=(0.5, 0.5), num_refinements=3)
    rules = torch.zeros(p, dtype=torch.int32)
    w = torch.full((C, n, 1), 2.0)
    perm = rng.permutation(n)
    states = []
    for order in (np.arange(n), perm):
        Xt = torch.from_numpy(X[order].copy())
        Yt = torch.from_numpy(Y[order].copy())[:, None]
        state = pgbart.init_state(Xt, Yt, cfg, chains=C, device="cpu")
        gen = torch.Generator().manual_seed(3)
        for _ in range(3):
            r = pgbart.draw_rands(gen, B=2, C=C, P=P, D=D, n=n, k=1,
                                  S=cfg.n_nodes, num_refinements=3,
                                  device="cpu")
            r.rg = r.rg[..., torch.from_numpy(order)].contiguous()
            state, _vi = pgbart.pgbart_step(state, r, Xt, Yt, rules, cfg, pg,
                                            True, w, route="fused")
        states.append(state)
    a, b = states
    assert bool((a.forest.split_var >= 0).any())
    for name in ("split_var", "split_val", "count", "leaf"):
        assert torch.equal(getattr(a.forest, name), getattr(b.forest, name)), name
    assert torch.equal(a.sum_trees[:, torch.from_numpy(perm)], b.sum_trees)
    assert torch.equal(a.leaf_sd, b.leaf_sd)


def test_particle_sums_add_in_index_order():
    rng = np.random.default_rng(4)
    x = np.exp(rng.normal(size=(7, 19)) * 6).astype(np.float32)
    want = np.cumsum(x, axis=1, dtype=np.float32)       # sequential in float32
    got = sums.seq_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        sums.seq_sum(torch.from_numpy(x)).numpy(), want[:, -1])
    one = torch.from_numpy(x[:, :1].copy())
    assert torch.equal(sums.seq_sum(one), one[:, 0])
    assert torch.equal(sums.seq_cumsum(one), one)


@pytest.mark.parametrize("count", [3, 19, 50, 1000])
def test_true_div_is_one_rounding_of_the_quotient(count):
    rng = np.random.default_rng(count)
    x = rng.normal(size=4096).astype(np.float32)
    got = sums.true_div(torch.from_numpy(x), count).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x / np.float32(count))


def test_gumbel_pick_takes_the_lowest_row_of_the_largest_gumbel():
    """``gumbel_pick`` against NumPy's first arg-max over the masked rows:
    ties go to the lowest row, a NaN covariate of the winner is kept, a
    node with no row gets NaN, and the arrays broadcast (a node axis)."""
    rng = np.random.default_rng(3)
    n, G = 40, 3
    gum = rng.gumbel(size=(2, n)).astype(np.float32)
    gum[0, [5, 9, 30]] = 9.0                 # a three-way tie
    vals = rng.normal(size=(2, n)).astype(np.float32)
    vals[1, int(np.argmax(gum[1]))] = np.nan
    node = rng.integers(0, G - 1, size=(2, n))   # node G-1 holds no row
    mask = node[:, None, :] == np.arange(G)[None, :, None]     # (2, G, n)
    got = sums.gumbel_pick(torch.from_numpy(gum)[:, None],
                           torch.from_numpy(mask),
                           torch.from_numpy(vals)[:, None]).numpy()
    want = np.full((2, G), np.nan, np.float32)
    for c in range(2):
        for g in range(G - 1):
            score = np.where(mask[c, g], gum[c], -np.inf)
            want[c, g] = vals[c, int(np.argmax(score))]
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[:, G - 1]).all()
    assert got[0, node[0, 5]] == vals[0, min(
        i for i in (5, 9, 30) if node[0, i] == node[0, 5])]
