"""The large-n route of the port against its own whole-step route, on the CPU.

No JAX trace here: ``ops.bign.pgbart_step_bign`` (plain version) and
``ops.draw.pgbart_step_fused`` (plain version) get the same random blocks and
must leave the same state, for all five likelihood codes.  Tolerances are
those of tests/test_bign.py (structure, counts, VI, iteration and batch offset
equal; ``split_val`` rtol 1e-5 / atol 1e-6; leaves rtol 1e-4 / atol 1e-5;
``sum_trees`` / ``tree_pred`` rtol 1e-4 / atol 1e-4; ``leaf_sd`` rtol 1e-5 /
atol 1e-6): the large-n route scores particles from per-node sums, the
whole-step route from row sums.  ``split_set`` is not compared: the whole-step
route stores a salt per grown node, the large-n route (all-continuous rules)
leaves the field alone, as the JAX package's two kernels do.

Also here: the gate case by case, the ``route=None`` dispatch on both sides of
the row count at which the whole-step kernel's rows leave shared memory, and
the optional Gumbel block of ``StepRands``.
"""

import numpy as np
import pytest
import torch

from pymc_bart_tpu_torch import convert
from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
from pymc_bart_tpu_torch.ops import bign, draw
from pymc_bart_tpu_torch.sampler import pgbart

P_COLS = 3


def make_case(lik, n, chains=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, P_COLS)).astype(np.float32)
    f_true = np.sin(3 * X[:, 0])
    if lik == "bernoulli":
        Y = rng.binomial(1, 1 / (1 + np.exp(-3 * f_true))).astype(np.float32)
    else:
        Y = (f_true + 0.1 * rng.normal(size=n)).astype(np.float32)
    row = None
    if lik == "gauss":    # one precision per chain
        w = np.array([4.0, 2.5, 1.5, 3.0], np.float32)[:chains]
        row = np.broadcast_to(w[:, None, None], (chains, n, 1)).copy()
    elif lik != "bernoulli":
        row = rng.uniform(0.1, 1.0, size=(chains, n, 1)).astype(np.float32)
    return (torch.from_numpy(X), torch.from_numpy(Y)[:, None],
            None if row is None else torch.from_numpy(row))


def assert_same_state(sa, sb, tag):
    da, db = convert.state_to_numpy(sa), convert.state_to_numpy(sb)
    for name in ("split_var", "count", "iteration", "batch_offset",
                 "wf_count"):
        np.testing.assert_array_equal(da[name], db[name],
                                      err_msg=f"{name} {tag}")
    tols = {"split_val": (1e-5, 1e-6), "leaf": (1e-4, 1e-5),
            "sum_trees": (1e-4, 1e-4), "tree_pred": (1e-4, 1e-4),
            "alpha_vec": (0.0, 0.0), "leaf_sd": (1e-5, 1e-6),
            "wf_mean": (1e-4, 1e-5)}
    for name, (rtol, atol) in tols.items():
        np.testing.assert_allclose(da[name], db[name], rtol=rtol, atol=atol,
                                   err_msg=f"{name} {tag}")


def run_both(lik, refinements, n, *, chains=2, depth=3, particles=4, m=6,
             steps=3):
    X, Y, row = make_case(lik, n, chains)
    cfg = BartConfig(m=m, max_depth=depth)
    pg = PgbartConfig(num_particles=particles, batch=(0.5, 0.5),
                      num_refinements=refinements)
    rules = torch.zeros(P_COLS, dtype=torch.int32)
    lik_const = 0.05 if lik == "het_abs" else 0.0
    sa = pgbart.init_state(X, Y, cfg, chains=chains, device="cpu")
    sb = sa.clone()
    gen = torch.Generator().manual_seed(n)
    for t in range(steps):
        tuning = t < 2
        rands = pgbart.draw_rands(
            gen, B=pg.batch_size(m, tuning), C=chains, P=particles, D=depth,
            n=n, k=1, S=cfg.n_nodes, num_refinements=refinements,
            device="cpu")
        common = dict(lik=lik, lik_const=lik_const)
        sa, vi_a = pgbart.pgbart_step(sa, rands, X, Y, rules, cfg, pg, tuning,
                                      row, route="fused", **common)
        sb, vi_b = pgbart.pgbart_step(sb, rands, X, Y, rules, cfg, pg, tuning,
                                      row, route="bign", w_scalar=True,
                                      **common)
        assert torch.equal(vi_a, vi_b)
        assert_same_state(sa, sb, f"{lik} R={refinements} n={n} step {t}")
    assert (convert.state_to_numpy(sb)["split_var"] >= 0).any()


@pytest.mark.parametrize("n", [37, 301])
@pytest.mark.parametrize("lik,refinements", [
    ("gauss", 0), ("gauss", 5), ("bernoulli", 0), ("het_abs", 0),
    ("het_exp", 0), ("cat_logit", 0)])
def test_bign_route_equals_fused_route(lik, refinements, n):
    run_both(lik, refinements, n)


@pytest.mark.parametrize("kw", [
    dict(chains=1), dict(depth=1), dict(depth=5, particles=6, chains=3)],
    ids=["one_chain", "depth_1", "depth_5"])
def test_bign_route_other_shapes(kw):
    run_both("gauss", 5, 200, **kw)


def _gate_args(n=50_000):
    return (BartConfig(m=20), PgbartConfig(num_particles=10),
            torch.zeros((n, 10)))


@pytest.mark.parametrize("case,needle", [
    ("ok", None), ("row_precision", "scalar"), ("bernoulli_refines", "num_refinements"),
    ("mixed_rules", "all-continuous"), ("nan", "NaN-free"),
    ("linear", "response"), ("two_outputs", "n_outputs"),
    ("poisson", "likelihood codes")])
def test_gate_case_by_case(case, needle):
    cfg, pg, X = _gate_args()
    lik, w_scalar, all_cont, x_nan = "gauss", True, True, False
    if case == "row_precision":
        w_scalar = False
    elif case == "bernoulli_refines":
        lik = "bernoulli"
    elif case == "mixed_rules":
        all_cont = False
    elif case == "nan":
        x_nan = True
    elif case == "linear":
        cfg = BartConfig(m=20, response="linear")
    elif case == "two_outputs":
        cfg = BartConfig(m=20, n_outputs=2)
    elif case == "poisson":
        lik = "poisson"
    reason = bign.bign_unsupported_reason(cfg, pg, X, lik, w_scalar, all_cont,
                                          x_nan)
    if needle is None:
        assert reason is None
        pg0 = PgbartConfig(num_particles=10, num_refinements=0)
        assert bign.bign_unsupported_reason(cfg, pg0, X, "bernoulli", False,
                                            True, False) is None
    else:
        assert needle in reason


def test_gate_memory_on_a_fake_size():
    """The card's limit is memory: the row state grows with chains x
    particles x rows, tree_pred with chains x m x rows."""
    cfg, pg, _X = _gate_args()
    small = bign.memory_bytes(cfg, pg, 50_000, 10, 4, "gauss", 2)
    rowll = bign.memory_bytes(cfg, pg, 50_000, 10, 4, "bernoulli", 2)
    huge = bign.memory_bytes(cfg, pg, 200_000_000, 10, 4, "gauss", 2)
    assert small < rowll < 2**30          # well under a gigabyte at n = 50,000
    assert rowll - small == 2 * 40 * 50_000 * 4   # the prediction rows
    assert huge > 40 * 2**30              # more than half of an 80 GB card
    # the pre-drawn Gumbel block is what the generated mode saves
    with_block = bign.step_bytes(4, 2, 10, 6, 127, 50_000, 10, 5, False, True)
    without = bign.step_bytes(4, 2, 10, 6, 127, 50_000, 10, 5, False, False)
    assert with_block - without == 2 * 6 * 40 * 50_000 * 4
    assert bign.tiling(50_000) == (1024, 49)
    assert bign.tiling(37) == (1024, 1)
    tile, tiles = bign.tiling(10_000_000)
    assert tiles <= 64 and tile * tiles >= 10_000_000 and tile % 256 == 0
    # per tree 2 set-up kernels, 3 a level, 2 to select and commit
    assert bign.launches_per_step(2, 6) == 2 * (4 + 18) + 1


def _small_step(n=40, lik="gauss"):
    X, Y, row = make_case(lik, n)
    cfg = BartConfig(m=6, max_depth=3)
    pg = PgbartConfig(num_particles=4, batch=(0.5, 0.5))
    state = pgbart.init_state(X, Y, cfg, chains=2, device="cpu")
    rules = torch.zeros(P_COLS, dtype=torch.int32)
    gen = torch.Generator().manual_seed(1)

    def rands(**kw):
        return pgbart.draw_rands(gen, B=3, C=2, P=4, D=3, n=n, k=1,
                                 S=cfg.n_nodes, num_refinements=5,
                                 device="cpu", **kw)

    return state, rands, (X, Y, rules, cfg, pg), row


def test_route_none_on_both_sides_of_the_row_threshold(monkeypatch):
    state, rands, args, row = _small_step()
    seen = []
    real_bign, real_fused = bign.pgbart_step_bign, draw.pgbart_step_fused
    monkeypatch.setattr(bign, "pgbart_step_bign",
                        lambda *a, **kw: seen.append("bign") or real_bign(*a, **kw))
    monkeypatch.setattr(draw, "pgbart_step_fused",
                        lambda *a, **kw: seen.append("fused") or real_fused(*a, **kw))
    # the n = 1000 models stay fused, the n = 50,000 models do not
    assert pgbart.fused_rows_on_chip(
        BartConfig(m=50), PgbartConfig(num_particles=20),
        torch.zeros((1000, 10)), 4)
    assert not pgbart.fused_rows_on_chip(*_gate_args(), 4)
    r = rands()
    pgbart.pgbart_step(state.clone(), r, *args, True, row, w_scalar=True)
    assert seen == ["fused"]               # 40 rows fit shared memory
    monkeypatch.setattr(pgbart, "fused_rows_on_chip", lambda *a: False)
    pgbart.pgbart_step(state.clone(), r, *args, True, row, w_scalar=True)
    assert seen == ["fused", "bign"]       # rows off chip: the large-n route
    pgbart.pgbart_step(state.clone(), r, *args, True, row, w_scalar=False)
    assert seen == ["fused", "bign", "fused"]   # the gate refuses: per-row sigma
    pgbart.pgbart_step(state.clone(), r, *args, True, row, w_scalar=True,
                       all_cont=False)
    assert seen[-1] == "fused"
    taken, why = pgbart.resolve_route(
        None, args[3], args[4], args[0], row, "gauss", chains=2,
        w_scalar=True, all_cont=True, x_nan=False)
    assert taken == "bign" and why == {"bign": None}
    monkeypatch.setattr(pgbart, "fused_rows_on_chip", lambda *a: True)
    taken, why = pgbart.resolve_route(
        None, args[3], args[4], args[0], row, "gauss", chains=2,
        w_scalar=True, all_cont=True, x_nan=False)
    assert taken == "fused" and "shared memory" in why["bign"]
    with pytest.raises(ValueError, match="scalar"):
        pgbart.pgbart_step(state.clone(), r, *args, True, row, route="bign")
    with pytest.raises(ValueError, match="route"):
        pgbart.pgbart_step(state.clone(), r, *args, True, row, route="big")


def test_rands_without_the_gumbel_block():
    state, rands, args, row = _small_step()
    r = rands(row_gumbels=False)
    assert r.rg is None
    assert r.seed.dtype == torch.int32 and tuple(r.seed.shape) == (2,)
    full = rands()
    assert full.seed is None and tuple(full.rg.shape) == (3, 3, 2, 4, 40)
    # the plain version has no generator of its own
    with pytest.raises(ValueError, match="no generator"):
        pgbart.pgbart_step(state.clone(), r, *args, True, row, route="bign",
                           w_scalar=True)
    # the other routes write the block out from the seed
    # (tests/test_torch_draw_generated.py); without either they refuse
    import dataclasses
    with pytest.raises(ValueError, match="neither"):
        pgbart.pgbart_step(state.clone(), dataclasses.replace(r, seed=None),
                           *args, True, row, route="rounds")
    with pytest.raises(ValueError, match="CUDA"):
        bign.pgbart_step_bign(state.clone(), full, args[0], args[1], args[3],
                              args[4], row[:, 0, 0].contiguous(), True,
                              impl="kernel")
    # on the CPU the generator's plain version writes the block out
    block = bign.gumbel_block(r.seed, B=3, C=2, P=4, D=3, n=40)
    assert tuple(block.shape) == (3, 3, 2, 4, 40)
    assert bool(torch.isfinite(block).all())
    with pytest.raises(ValueError, match="int32"):
        bign.gumbel_block(r.seed.to(torch.int64), B=3, C=2, P=4, D=3, n=40)
    with pytest.raises(ValueError, match="impl"):
        bign.pgbart_step_bign(state.clone(), full, args[0], args[1], args[3],
                              args[4], row[:, 0, 0].contiguous(), True,
                              impl="fast")


def test_rands_from_numpy_accepts_a_missing_block():
    rng = np.random.default_rng(0)
    B, P, D, n, S, R = 2, 3, 2, 5, 7, 1
    Gtot = 2**D - 1
    chain = [rng.random((B, P, Gtot)), rng.random((B, P, Gtot)), None,
             rng.normal(size=(B, P, 2 * Gtot, 1)),
             rng.integers(0, 2**32, size=(B, P, Gtot), dtype=np.uint32),
             rng.random((B, D)), rng.random((B,)),
             rng.normal(size=(B, R, 1, S)), rng.random((B, R))]
    r = convert.rands_from_numpy([chain, chain], "cpu")
    assert r.rg is None and tuple(r.ug.shape) == (B, 2, P, Gtot)
    chain[2] = rng.gumbel(size=(B, D, P, n))
    r = convert.rands_from_numpy([chain, chain], "cpu")
    assert tuple(r.rg.shape) == (B, D, 2, P, n)
