"""The whole-step function with row Gumbels generated from a seed, and the
static launch plan of its kernel, on the CPU.

No JAX trace here.  The port's generator (``csrc/common.cuh``, plain version
``ops.bign.gumbel_block_plain``) is Philox-4x32-10 with the counter (row,
stream of (tree, level, chain, particle)) and the first output word's top 23
bits mapped to ``u = (k + 0.5) 2^-23``; it is held against a NumPy Philox
written out here (same uniforms bit for bit; Gumbels to 1e-6, the logarithms
are NumPy's and PyTorch's).  ``pgbart_step_fused(impl="plain")`` without a
Gumbel block must leave exactly the state it leaves with the block
``gumbel_block`` writes out for the seed (integers equal, floats equal bit for
bit: it is the same code on the same numbers), directly and through
``pgbart_step`` on the fused and the per-round route, and ``sample(device="cpu",
pgbart_route="fused")`` must go on returning the draws of the per-round route
(both read one pre-drawn block on the CPU).

``ops.draw.launch_plan`` is a pure function of the shapes: the cases pin the
form (per-particle state in shared or in global memory), the cluster, the
particle slots of a block and the team's warps, and the reasons it refuses.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pymc_bart_tpu_torch as tpmb
from pymc_bart_tpu_torch import convert
from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
from pymc_bart_tpu_torch.ops import bign, draw
from pymc_bart_tpu_torch.sampler import pgbart

P_COLS = 3
MASK = np.uint64(0xFFFFFFFF)


def philox_first_word(row, stream, k0, k1):
    """Philox-4x32-10 on the counter (row, stream, 0, 0), first output word."""
    c = [np.uint64(row), np.uint64(stream), np.uint64(0), np.uint64(0)]
    k0, k1 = np.uint64(k0), np.uint64(k1)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & MASK,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & MASK]
        k0 = (k0 + np.uint64(0x9E3779B9)) & MASK
        k1 = (k1 + np.uint64(0xBB67AE85)) & MASK
    return int(c[0])


def make_case(lik, n, chains=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, P_COLS)).astype(np.float32)
    f_true = np.sin(3 * X[:, 0])
    if lik == "bernoulli":
        Y = rng.binomial(1, 1 / (1 + np.exp(-3 * f_true))).astype(np.float32)
    else:
        Y = (f_true + 0.1 * rng.normal(size=n)).astype(np.float32)
    row = None
    if lik == "gauss":
        w = np.array([4.0, 2.5, 1.5, 3.0], np.float32)[:chains]
        row = np.broadcast_to(w[:, None, None], (chains, n, 1)).copy()
    elif lik != "bernoulli":
        row = rng.uniform(0.1, 1.0, size=(chains, n, 1)).astype(np.float32)
    return (torch.from_numpy(X), torch.from_numpy(Y)[:, None],
            None if row is None else torch.from_numpy(row))


def small_step(lik="gauss", n=40):
    X, Y, row = make_case(lik, n)
    cfg = BartConfig(m=6, max_depth=3)
    pg = PgbartConfig(num_particles=4, batch=(0.5, 0.5))
    state = pgbart.init_state(X, Y, cfg, chains=2, device="cpu")
    rules = torch.zeros(P_COLS, dtype=torch.int32)
    gen = torch.Generator().manual_seed(1)
    rands = pgbart.draw_rands(gen, B=3, C=2, P=4, D=3, n=n, k=1, S=cfg.n_nodes,
                              num_refinements=5, device="cpu",
                              row_gumbels=False)
    return state, rands, (X, Y, rules, cfg, pg), row


def assert_identical(sa, sb, tag):
    da, db = convert.state_to_numpy(sa), convert.state_to_numpy(sb)
    assert da.keys() == db.keys()
    for name in da:
        np.testing.assert_array_equal(da[name], db[name],
                                      err_msg=f"{name} {tag}")


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [(0, 0), (-123456789, 987654321),
                                  (2**31 - 1, -2**31)])
def test_generator_is_philox_on_row_and_stream(seed):
    B, C, P, D, n = 2, 2, 3, 2, 7
    block = bign.gumbel_block(torch.tensor(seed, dtype=torch.int32), B=B, C=C,
                              P=P, D=D, n=n)
    assert tuple(block.shape) == (B, D, C, P, n)
    flat = block.reshape(B * D * C * P, n).numpy()
    k0, k1 = (s & 0xFFFFFFFF for s in seed)
    for stream in (0, 5, B * D * C * P - 1):
        for row in (0, 3, n - 1):
            bits = philox_first_word(row, stream, k0, k1)
            u = (np.float32(bits >> 9) + np.float32(0.5)) * np.float32(2.0**-23)
            np.testing.assert_allclose(flat[stream, row],
                                       -np.log(-np.log(u)), rtol=1e-6,
                                       atol=1e-6)


def test_generator_streams_follow_tree_level_chain_particle():
    """A value depends on (seed, row, stream) alone: the block of a larger
    step holds the smaller step's streams where the layout puts them."""
    seed = torch.tensor([11, -7], dtype=torch.int32)
    one = bign.gumbel_block(seed, B=1, C=2, P=3, D=2, n=9)
    two = bign.gumbel_block(seed, B=2, C=2, P=3, D=2, n=5)
    np.testing.assert_array_equal(one[0, :, :, :, :5].numpy(),
                                  two[0].numpy())
    other = bign.gumbel_block(torch.tensor([12, -7], dtype=torch.int32), B=1,
                              C=2, P=3, D=2, n=9)
    assert not np.array_equal(one.numpy(), other.numpy())
    rows = one.reshape(-1, 9).numpy()
    assert len({r.tobytes() for r in rows}) == rows.shape[0]


def test_generator_is_a_finite_gumbel():
    seed = torch.tensor([2024, 4], dtype=torch.int32)
    block = bign.gumbel_block(seed, B=2, C=2, P=5, D=4, n=2500).numpy()
    assert np.isfinite(block).all()
    assert abs(block.mean() - 0.5772156649) < 0.01
    assert abs(block.var() - np.pi**2 / 6) < 0.03
    # the ends of the 23-bit mapping are inside (0, 1) in float32
    for k in (0, 2**23 - 1):
        u = (np.float32(k) + np.float32(0.5)) * np.float32(2.0**-23)
        assert 0.0 < u < 1.0 and np.isfinite(-np.log(-np.log(u)))


# ---------------------------------------------------------------------------
# the whole-step function without a Gumbel block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lik", ["gauss", "bernoulli", "het_abs", "het_exp",
                                 "cat_logit"])
@pytest.mark.parametrize("tuning", [True, False])
def test_plain_version_from_a_seed_equals_the_written_out_block(lik, tuning):
    state, rands, args, row = small_step(lik)
    assert rands.rg is None and rands.seed is not None
    if not tuning:      # a draw step updates another number of trees
        gen = torch.Generator().manual_seed(3)
        rands = pgbart.draw_rands(
            gen, B=args[4].batch_size(6, False), C=2, P=4, D=3, n=40, k=1,
            S=args[3].n_nodes, num_refinements=5, device="cpu",
            row_gumbels=False)
    B = args[4].batch_size(6, tuning)
    block = bign.gumbel_block(rands.seed, B=B, C=2, P=4, D=3, n=40)
    kw = dict(lik=lik, lik_const=0.05 if lik == "het_abs" else 0.0,
              impl="plain")
    s_seed, vi_seed = draw.pgbart_step_fused(state.clone(), rands, *args, row,
                                             tuning, **kw)
    s_block, vi_block = draw.pgbart_step_fused(
        state.clone(), dataclasses.replace(rands, rg=block), *args, row,
        tuning, **kw)
    np.testing.assert_array_equal(vi_seed.numpy(), vi_block.numpy())
    assert_identical(s_seed, s_block, f"{lik} tuning={tuning}")
    assert int((s_seed.forest.split_var >= 0).sum()) > 0


@pytest.mark.parametrize("lik", ["gauss", "bernoulli"])
def test_step_on_the_fused_route_takes_rands_without_the_block(lik):
    state, rands, args, row = small_step(lik)
    s_route, vi_route = pgbart.pgbart_step(state.clone(), rands, *args, True,
                                           row, lik=lik, route="fused")
    s_direct, vi_direct = draw.pgbart_step_fused(state.clone(), rands, *args,
                                                 row, True, lik=lik)
    np.testing.assert_array_equal(vi_route.numpy(), vi_direct.numpy())
    assert_identical(s_route, s_direct, lik)
    # route=None takes the same route below the large-n threshold
    s_auto, _ = pgbart.pgbart_step(state.clone(), rands, *args, True, row,
                                   lik=lik)
    assert_identical(s_auto, s_direct, f"{lik} route=None")
    # the per-round route writes the same block out from the seed
    s_rounds, vi_rounds = pgbart.pgbart_step(state.clone(), rands, *args, True,
                                             row, lik=lik, route="rounds")
    np.testing.assert_array_equal(vi_rounds.numpy(), vi_direct.numpy())
    assert_identical(s_rounds, s_direct, f"{lik} route=rounds")


def test_step_needs_a_block_or_a_seed():
    state, rands, args, row = small_step()
    bare = dataclasses.replace(rands, seed=None)
    with pytest.raises(ValueError, match="neither"):
        draw.pgbart_step_fused(state.clone(), bare, *args, row, True)
    with pytest.raises(ValueError, match="neither"):
        pgbart.pgbart_step(state.clone(), bare, *args, True, row,
                           route="rounds")
    with pytest.raises(ValueError, match="CUDA"):
        draw.pgbart_step_fused(state.clone(), rands, *args, row, True,
                               impl="kernel")


def test_two_steps_from_one_seed_are_identical():
    state, rands, args, row = small_step()
    a, via = draw.pgbart_step_fused(state.clone(), rands, *args, row, True)
    b, vib = draw.pgbart_step_fused(state.clone(), rands, *args, row, True)
    np.testing.assert_array_equal(via.numpy(), vib.numpy())
    assert_identical(a, b, "rerun")
    other = dataclasses.replace(rands, seed=rands.seed + 1)
    c, _ = draw.pgbart_step_fused(state.clone(), other, *args, row, True)
    assert not np.array_equal(convert.state_to_numpy(a)["sum_trees"],
                              convert.state_to_numpy(c)["sum_trees"])


def _fit(route, seed=0):
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(60, 5)).astype(np.float32)
    f = 10 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 10 * X[:, 3] + 5 * X[:, 4]
    Y = (f + rng.normal(0, 1.0, 60)).astype(np.float32)
    with tpmb.Model():
        mu = tpmb.BART("mu", X, Y, m=8)
        sigma = tpmb.HalfNormal("sigma", 1.0)
        tpmb.Normal("y", mu, sigma, observed=Y)
        idata = tpmb.sample(tune=20, draws=20, chains=2, num_particles=6,
                            random_seed=seed, convergence_checks=False,
                            device="cpu", pgbart_route=route)
    return idata, f


def test_sample_on_the_fused_route_keeps_its_statistics():
    """On the CPU the fused route still reads one pre-drawn block per step,
    so its draws are the per-round route's bit for bit and its fit is what it
    was: finite, correlated with the true function, sigma of order one."""
    fused, f = _fit("fused")
    rounds, _ = _fit("rounds")
    mu = np.asarray(fused.posterior["mu"].values)
    np.testing.assert_array_equal(mu, np.asarray(rounds.posterior["mu"].values))
    np.testing.assert_array_equal(
        np.asarray(fused.posterior["sigma"].values),
        np.asarray(rounds.posterior["sigma"].values))
    assert mu.shape == (2, 20, 60) and np.isfinite(mu).all()
    assert np.corrcoef(mu.mean(axis=(0, 1)), f)[0, 1] > 0.8
    sigma = np.asarray(fused.posterior["sigma"].values)
    assert 0.2 < sigma.mean() < 6.0
    vi = np.asarray(fused["sample_stats"]["variable_inclusion"].values)
    assert (vi.sum(axis=-1) > 0).all()


# ---------------------------------------------------------------------------
# the static launch plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shapes, form, cluster, per_block, warps, x_staged", [
    ((4, 20, 6, 127, 1000, 10), "shared", 10, 2, 8, True),     # main shapes
    ((4, 19, 6, 127, 1000, 10), "shared", 10, 2, 8, True),     # an idle slot
    ((4, 10, 6, 127, 1000, 10), "shared", 10, 1, 16, True),
    ((4, 10, 6, 127, 4000, 10), "shared", 10, 1, 16, False),   # X stays global
    ((2, 10, 6, 127, 16384, 10), "global", 10, 1, 16, False),  # rows do not fit
    ((4, 10, 6, 127, 200_000, 10), "global", 10, 1, 16, False),
    ((4, 20, 10, 2047, 1000, 10), "global", 10, 2, 8, False),  # nodes do not fit
    ((4, 20, 11, 4095, 1000, 10), "global", 10, 2, 8, False),
    ((4, 20, 6, 127, 200, 1000), "shared", 10, 2, 8, False),   # wide X
    ((2, 6, 4, 31, 200, 4), "shared", 6, 1, 16, True),
    ((4, 40, 6, 127, 1000, 10), "shared", 14, 3, 5, True),
    ((1, 2, 1, 3, 5, 1), "shared", 2, 1, 16, True),
])
def test_launch_plan_is_a_function_of_the_shapes(shapes, form, cluster,
                                                 per_block, warps, x_staged):
    plan = draw.launch_plan(*shapes)
    assert isinstance(plan, draw.DrawPlan), plan
    assert (plan.form, plan.cluster, plan.per_block, plan.warps,
            plan.x_staged) == (form, cluster, per_block, warps, x_staged)
    C, P, D, S, n, p = shapes
    assert plan.cluster * plan.per_block >= P          # every particle a slot
    assert plan.cluster <= 16 and plan.threads <= 512
    assert plan.smem == draw.smem_bytes(plan, D, P, S, n, p, 5)
    assert plan.smem <= 232448 and plan.smem % 16 == 0
    assert plan == draw.launch_plan(*shapes)           # nothing but the shapes
    assert plan == draw.launch_plan(C + 3, P, D, S, n, p)   # chains do not matter


@pytest.mark.parametrize("shapes, word", [
    ((4, 20, 17, 2**18 - 1, 1000, 10), "max_depth"),
    ((4, 1, 6, 127, 1000, 10), "particles"),
    ((4, 600, 6, 127, 1000, 10), "particles"),
    ((4, 20, 12, 8191, 1000, 10), "shared memory"),
])
def test_launch_plan_names_what_it_refuses(shapes, word):
    reason = draw.launch_plan(*shapes)
    assert isinstance(reason, str) and word in reason


def test_shared_memory_grows_with_what_is_staged():
    base = draw.launch_plan(4, 20, 6, 127, 1000, 10)
    assert draw.launch_plan(4, 20, 6, 127, 1200, 10).smem > base.smem
    assert draw.launch_plan(4, 20, 7, 255, 1000, 10).smem > base.smem
    assert draw.launch_plan(4, 20, 6, 127, 1000, 10, R=9).smem > base.smem
    unstaged = dataclasses.replace(base, x_staged=False)
    assert (base.smem - draw.smem_bytes(unstaged, 6, 20, 127, 1000, 10, 5)
            == 4 * 1000 * 10 + 48)     # X, the rules, alignment
    # the gate reads the same plan
    cfg, pg = BartConfig(m=50, max_depth=6), PgbartConfig(num_particles=20)
    X = torch.zeros((1000, 10))
    assert draw.fused_draw_unsupported_reason(
        cfg, pg, X, torch.ones((4, 1000, 1)), chains=4) is None
    # a smaller step needs fewer bytes without the block
    with_block = draw.step_bytes(4, 5, 20, 6, 127, 1000, 10, 5, True)
    without = draw.step_bytes(4, 5, 20, 6, 127, 1000, 10, 5, False)
    assert with_block - without == 5 * 6 * 4 * 20 * 1000 * 4
