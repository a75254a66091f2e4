"""Retained-path rejuvenation of the port (``sampler/rejuvenate.py``) against
the JAX package's ``sampler/rejuvenate.py`` on the same trees and the same
random numbers, plus the oracles of ``tests/test_rejuvenate.py`` run on the
port.

The JAX functions draw their randoms from keys; the tests repeat those key
splits (``_one_move``: seven keys of one move; ``rejuvenate_forest``: one
key a move) and hand the numbers to the port.  Tree structure, split sets,
counts and the accept decision must be equal; split values, leaves and
predictions agree to rtol 1e-5 / atol 1e-6 (float32 sums in another order).
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymc_bart_tpu.config import BartConfig as JBartConfig
from pymc_bart_tpu.config import PgbartConfig as JPgbartConfig
from pymc_bart_tpu.ops.trees import Forest as JForest
from pymc_bart_tpu.sampler import pgbart as jpg
from pymc_bart_tpu.sampler import rejuvenate as jrj

import pymc_bart_tpu_torch as tpmb
from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
from pymc_bart_tpu_torch.convert import state_from_numpy
from pymc_bart_tpu_torch.ops.predict import tree_predict
from pymc_bart_tpu_torch.ops.trees import decide_left
from pymc_bart_tpu_torch.sampler import pgbart, rejuvenate as rj

N, P_COLS, D, M = 60, 3, 3, 5
S = 2 ** (D + 1) - 1
TOL = dict(rtol=1e-5, atol=1e-6)
BRANCHES = {"grow": (0.0, 0.25), "prune": (0.25, 0.5), "change": (0.5, 1.0)}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(case, seed=0):
    """X (n, p), rules (p,): all continuous, or a continuous column with
    NaNs beside a one-hot and a subset column (the latter with NaNs too)."""
    rng = np.random.default_rng(seed)
    if case == "cont":
        return (rng.uniform(size=(N, P_COLS)).astype(np.float32),
                np.zeros(P_COLS, np.int32))
    X = np.stack([rng.uniform(size=N), rng.integers(0, 4, N),
                  rng.integers(0, 6, N)], axis=1).astype(np.float32)
    X[rng.uniform(size=N) < 0.1, 0] = np.nan
    X[rng.uniform(size=N) < 0.1, 2] = np.nan
    return X, np.array([0, 1, 2], np.int32)


def _random_tree(rng, X, rules, k=1):
    """One valid tree over the rows of X (counts follow the routing)."""
    n, p = X.shape
    sv = np.full(S, -1, np.int32)
    sl = np.zeros(S, np.float32)
    st = np.zeros(S, np.uint32)
    ct = np.zeros(S, np.float32)
    lf = (0.3 * rng.normal(size=(S, k))).astype(np.float32)
    rows = {0: np.arange(n)}
    ct[0] = n
    depth = rj.depth_of_slots(S, "cpu").numpy()
    for s in range(S):
        idx = rows.get(s)
        if idx is None or depth[s] >= D or len(idx) < 4 or rng.uniform() > 0.8:
            continue
        j = int(rng.integers(p))
        val = X[rng.choice(idx), j]
        salt = np.uint32(rng.integers(0, 2**32))
        left = decide_left(
            torch.from_numpy(X[idx, j]), torch.tensor(val),
            torch.tensor(np.array(salt).view(np.int32)),
            torch.tensor(rules[j])).numpy()
        if left.all() or not left.any():
            continue
        sv[s], sl[s], st[s] = j, val, salt
        rows[2 * s + 1], rows[2 * s + 2] = idx[left], idx[~left]
        ct[2 * s + 1], ct[2 * s + 2] = left.sum(), (~left).sum()
    return sv, sl, st, lf, ct


def _tree_pred(tree, X, rules):
    sv, sl, st, lf, _ct = tree
    t = torch.from_numpy
    return tree_predict(t(sv), t(sl), t(st.view(np.int32)), t(lf),
                        torch.zeros_like(t(lf)), t(X), t(rules), D).numpy()


def _move_rands(key, n, k=1):
    """The numbers JAX's ``_one_move`` draws from ``key``, as one move of
    ``RejuvRands`` for one chain."""
    (k_move, k_node, k_var, k_row, k_salt, k_eps, k_acc
     ) = jax.random.split(key, 7)
    vals = dict(
        u_move=jax.random.uniform(k_move, ()),
        g_node=jax.random.gumbel(k_node, (S,)),
        u_var=jax.random.uniform(k_var, ()),
        row_gum=jax.random.gumbel(k_row, (n,)),
        salt=jax.random.bits(k_salt, (), dtype=jnp.uint32),
        eps=jax.random.normal(k_eps, (2, k)),
        u_acc=jax.random.uniform(k_acc, ()))
    out = {}
    for name, v in vals.items():
        a = np.asarray(v)
        a = a.astype(np.int64) if name == "salt" else a.astype(np.float32)
        out[name] = torch.from_numpy(np.array(a, copy=True))[None]
    return rj.RejuvRands(**out)


def _key_for(branch, seed):
    """A key whose move takes ``branch``."""
    lo, hi = BRANCHES[branch]
    for t in range(1000):
        key = jax.random.PRNGKey(1000 * seed + t)
        u = float(jax.random.uniform(jax.random.split(key, 7)[0], ()))
        if lo <= u < hi:
            return key
    raise AssertionError("no key found")


def _gauss_ll_jax(Yt, gw):
    def ll_of(sum_noi, pred):
        diff = (Yt - sum_noi) - pred
        return -0.5 * jnp.sum(gw * diff * diff)
    return ll_of


@functools.partial(jax.jit, static_argnums=(0,))
def _jax_move(cfg, key, sv, sl, st, lf, ct, pred, X, sum_noi, alpha_cdf,
              leaf_sd, rules, Yt, gw):
    depth = jnp.asarray(jrj._depth_array(cfg.n_nodes))
    return jrj._one_move(key, sv, sl, st, lf, ct, pred, X, Yt - sum_noi,
                         sum_noi, alpha_cdf, leaf_sd, rules, cfg,
                         _gauss_ll_jax(Yt, gw), depth, None)


def _move_case(case, seed):
    """Tree, data and likelihood of one ``_one_move`` comparison."""
    rng = np.random.default_rng(100 + seed)
    X, rules = _data(case, seed)
    sv, sl, st, lf, ct = _random_tree(rng, X, rules)
    pred = _tree_pred((sv, sl, st, lf, ct), X, rules)
    sum_noi = rng.normal(size=(N, 1)).astype(np.float32)
    Yt = (sum_noi + pred + 0.5 * rng.normal(size=(N, 1))).astype(np.float32)
    gw = np.full((N, 1), 4.0, np.float32)
    alpha = rng.integers(1, 4, P_COLS).astype(np.float32)
    return dict(X=X, rules=rules, tree=(sv, sl, st, lf, ct), pred=pred,
                sum_noi=sum_noi, Yt=Yt, gw=gw, alpha_cdf=np.cumsum(alpha),
                leaf_sd=np.array([0.2], np.float32))


def _run_both(c, key):
    jcfg = JBartConfig(m=M, max_depth=D)
    cfg = BartConfig(m=M, max_depth=D)
    sv, sl, st, lf, ct = c["tree"]
    got_j = _jax_move(jcfg, key, sv, sl, st, lf, ct, c["pred"], c["X"],
                      c["sum_noi"], c["alpha_cdf"], c["leaf_sd"], c["rules"],
                      c["Yt"], c["gw"])
    got_j = [np.asarray(a) for a in got_j]
    t = torch.from_numpy
    Yt, gw, sum_noi = (t(c[k])[None] for k in ("Yt", "gw", "sum_noi"))

    def ll_of(sn, pred):
        diff = (Yt - sn) - pred
        return -0.5 * (gw * diff * diff).to(torch.float64).sum((1, 2)).float()

    got_t = rj._one_move(
        _move_rands(key, N), t(sv)[None], t(sl)[None],
        t(st.view(np.int32))[None], t(lf)[None], t(ct)[None],
        t(c["pred"])[None], t(c["X"]).t().contiguous(), Yt - sum_noi, sum_noi,
        t(c["alpha_cdf"]).float()[None], t(c["leaf_sd"])[None],
        t(c["rules"]), cfg, ll_of, rj.depth_of_slots(S, "cpu"),
        all_cont=bool((c["rules"] == 0).all()))
    got_t = [a[0].numpy() for a in got_t]
    return got_j, got_t


def _compare(got_j, got_t, tree, tag=""):
    sv_j, sl_j, st_j, lf_j, ct_j, pred_j = got_j
    sv_t, sl_t, st_t, lf_t, ct_t, pred_t, acc_t = got_t
    np.testing.assert_array_equal(sv_t, sv_j, err_msg=tag)
    np.testing.assert_array_equal(st_t.view(np.uint32), st_j, err_msg=tag)
    np.testing.assert_array_equal(ct_t, ct_j, err_msg=tag)
    internal = sv_j >= 0
    np.testing.assert_allclose(sl_t[internal], sl_j[internal], **TOL,
                               err_msg=tag)
    np.testing.assert_allclose(lf_t, lf_j, **TOL, err_msg=tag)
    np.testing.assert_allclose(pred_t, pred_j, **TOL, err_msg=tag)
    acc_j = (not np.array_equal(sv_j, tree[0])
             or not np.array_equal(lf_j, tree[3]))
    assert bool(acc_t) == acc_j, tag
    return acc_j


@pytest.mark.parametrize("case", ["cont", "mixed"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_one_move_matches_jax(branch, seed, case):
    c = _move_case(case, seed)
    key = _key_for(branch, seed)
    got_j, got_t = _run_both(c, key)
    _compare(got_j, got_t, c["tree"], f"{branch} {case} {seed}")


def test_one_move_decisions_over_many_keys():
    """Unforced moves on the mixed tree: the same decisions, and both
    accepted and rejected moves of more than one branch among them."""
    c = _move_case("mixed", 5)
    decisions = []
    for t in range(24):
        key = jax.random.PRNGKey(7000 + t)
        got_j, got_t = _run_both(c, key)
        decisions.append(_compare(got_j, got_t, c["tree"], f"key {t}"))
    assert 0 < sum(decisions) < len(decisions), decisions


@pytest.mark.parametrize("lik", ["gauss", "bernoulli"])
@pytest.mark.parametrize("seed", [0, 1])
def test_rejuvenate_forest_matches_jax(lik, seed):
    """m=3 trees, 2 sweeps (6 moves, one tree after another)."""
    m, sweeps = 3, 2
    rng = np.random.default_rng(200 + seed)
    X, rules = _data("mixed", seed)
    trees = [_random_tree(rng, X, rules) for _ in range(m)]
    forest = [np.stack([t[i] for t in trees]) for i in range(5)]
    tree_pred = np.stack([_tree_pred(t, X, rules) for t in trees])
    f = tree_pred.sum(0)
    if lik == "gauss":
        Yt = (f + 0.4 * rng.normal(size=(N, 1))).astype(np.float32)
        row = np.full((N, 1), 6.0, np.float32)
    else:
        Yt = (rng.uniform(size=(N, 1)) < 1 / (1 + np.exp(-3 * f))
              ).astype(np.float32)
        row = None
    jcfg = JBartConfig(m=m, max_depth=D)
    jpgc = JPgbartConfig(ancestor_sampling=True, rejuvenation_sweeps=sweeps)
    st0 = jpg.init_state(jnp.asarray(X), jnp.asarray(Yt), jcfg)
    sv, sl, ss, lf, ct = (jnp.asarray(a) for a in forest)
    st0 = dataclasses.replace(
        st0, forest=JForest(sv, sl, ss, lf, ct, jnp.zeros_like(lf)),
        tree_pred=jnp.asarray(tree_pred), sum_trees=jnp.asarray(f),
        alpha_vec=jnp.asarray(rng.integers(1, 4, P_COLS), jnp.float32),
        leaf_sd=jnp.asarray([0.25], jnp.float32))
    ll_j = jpg._make_ll_of(None, None, None if row is None else
                           jnp.asarray(row), lik, 0.0, jnp.asarray(Yt), None)
    key = jax.random.PRNGKey(31 + seed)
    out_j = jrj.rejuvenate_forest(key, st0, jnp.asarray(X), jnp.asarray(Yt),
                                  jnp.asarray(rules), jcfg, jpgc, ll_j)

    # the same numbers: one key a move, split as the JAX fori_loop does
    moves, key_c = [], key
    for _ in range(m * sweeps):
        key_c, k_t = jax.random.split(key_c)
        moves.append(_move_rands(k_t, N))
    rands = rj.RejuvRands(*(torch.stack([getattr(mv, fl.name) for mv in moves])
                            for fl in dataclasses.fields(rj.RejuvRands)))
    state = state_from_numpy({f_.name: np.asarray(getattr(st0, f_.name))
                              for f_ in dataclasses.fields(st0)
                              if f_.name != "forest"}
                             | {f_.name: np.asarray(getattr(st0.forest,
                                                            f_.name))
                                for f_ in dataclasses.fields(st0.forest)},
                             "cpu")
    cfg = BartConfig(m=m, max_depth=D)
    Y = torch.from_numpy(Yt)[None]
    ll_t = pgbart.make_ll_of(lik, 0.0, None if row is None
                             else torch.from_numpy(row)[None], Y)
    rj.rejuvenate_forest(state, rands, torch.from_numpy(X), Y,
                         torch.from_numpy(rules), cfg,
                         PgbartConfig(ancestor_sampling=True,
                                      rejuvenation_sweeps=sweeps), ll_t)
    fj, ft = out_j.forest, state.forest
    np.testing.assert_array_equal(ft.split_var[0].numpy(),
                                  np.asarray(fj.split_var))
    np.testing.assert_array_equal(ft.split_set[0].numpy().view(np.uint32),
                                  np.asarray(fj.split_set))
    np.testing.assert_array_equal(ft.count[0].numpy(), np.asarray(fj.count))
    internal = np.asarray(fj.split_var) >= 0
    np.testing.assert_allclose(ft.split_val[0].numpy()[internal],
                               np.asarray(fj.split_val)[internal], **TOL)
    np.testing.assert_allclose(ft.leaf[0].numpy(), np.asarray(fj.leaf), **TOL)
    np.testing.assert_allclose(state.tree_pred[0].numpy(),
                               np.asarray(out_j.tree_pred), **TOL)
    np.testing.assert_allclose(state.sum_trees[0].numpy(),
                               np.asarray(out_j.sum_trees), rtol=1e-5,
                               atol=1e-5)
    # something moved
    assert not np.array_equal(np.asarray(fj.leaf), forest[3])


def test_prior_preserved_under_rejuvenation_alone():
    """Zero precision: the moves see no likelihood, so the stationary
    structure is the Chipman prior: root split rate alpha, depth-1 rate
    alpha 2^-beta (tests/test_rejuvenate.py's oracle, on 64 chains of
    rejuvenation alone)."""
    C, n, p = 64, 256, 3
    alpha, beta = 0.7, 1.2
    cfg = BartConfig(m=1, max_depth=3, alpha=alpha, beta=beta)
    pgc = PgbartConfig(ancestor_sampling=True)
    rng = np.random.default_rng(7)
    X = torch.from_numpy(rng.uniform(size=(n, p)).astype(np.float32))
    Yt = torch.from_numpy(rng.normal(size=(n, 1)).astype(np.float32))
    rules = torch.zeros(p, dtype=torch.int32)
    state = pgbart.init_state(X, Yt, cfg, chains=C, device="cpu")
    ll_of = pgbart.make_ll_of("gauss", 0.0, torch.zeros((C, n, 1)), Yt[None])
    gen = torch.Generator().manual_seed(3)
    burn, keep = 150, 450
    sv = []
    for t in range(burn + keep):
        rands = rj.draw_rejuv_rands(gen, moves=1, C=C, S=cfg.n_nodes, n=n,
                                    k=1, device="cpu")
        rj.rejuvenate_forest(state, rands, X, Yt, rules, cfg, pgc, ll_of)
        if t >= burn:
            sv.append(state.forest.split_var[:, 0, :3].clone())
    sv = torch.stack(sv).reshape(-1, 3).numpy()
    root = sv[:, 0] >= 0
    T = sv.shape[0]
    se0 = np.sqrt(alpha * (1 - alpha) * 25.0 / T)
    assert abs(root.mean() - alpha) < 4 * se0 + 0.02, root.mean()
    d1 = sv[root][:, 1:3] >= 0
    want1 = alpha * 2.0 ** -beta
    se1 = np.sqrt(want1 * (1 - want1) * 25.0 / max(d1.shape[0], 1))
    assert abs(d1.mean() - want1) < 4 * se1 + 0.03, d1.mean()


def _step_setup(seed=11, n=120, p=4, m=5):
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.uniform(size=(n, p)).astype(np.float32))
    Yt = torch.from_numpy(rng.normal(size=(n, 1)).astype(np.float32))
    cfg = BartConfig(m=m, max_depth=3)
    rules = torch.zeros(p, dtype=torch.int32)
    return X, Yt, cfg, rules


def _step(state, gen, X, Yt, rules, cfg, pgc, tuning, route, C=2):
    n = X.shape[0]
    rands = pgbart.draw_rands(
        gen, B=pgc.batch_size(cfg.m, tuning), C=C, P=pgc.num_particles,
        D=cfg.max_depth, n=n, k=1, S=cfg.n_nodes,
        num_refinements=pgc.num_refinements, device="cpu")
    rejuv = (rj.draw_rejuv_rands(
        gen, moves=cfg.m * pgc.rejuvenation_sweeps, C=C, S=cfg.n_nodes, n=n,
        k=1, device="cpu") if pgc.ancestor_sampling else None)
    gw = torch.ones((C, n, 1))
    return pgbart.pgbart_step(state, rands, X, Yt, rules, cfg, pgc, tuning,
                              gw, route=route, w_scalar=True, rejuv=rejuv)


@pytest.mark.parametrize("route", ["fused", "rounds", "bign"])
def test_forest_invariants_after_rejuvenated_steps(route):
    """After rejuvenated steps on each route: cached per-tree predictions
    equal the forest's, sum_trees their sum, pruned children leave the active
    set, the inclusion counts recount the forest."""
    X, Yt, cfg, rules = _step_setup()
    pgc = PgbartConfig(num_particles=6, batch=(1.0, 1.0),
                       num_refinements=0 if route == "bign" else 2,
                       ancestor_sampling=True)
    state = pgbart.init_state(X, Yt, cfg, chains=2, device="cpu")
    gen = torch.Generator().manual_seed(5)
    for i in range(8):
        state, vi = _step(state, gen, X, Yt, rules, cfg, pgc, i < 4, route)
    fresh = pgbart.refresh_tree_pred(state.clone(), X, rules, cfg)
    np.testing.assert_allclose(state.tree_pred.numpy(),
                               fresh.tree_pred.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(state.sum_trees.numpy(),
                               state.tree_pred.sum(1).numpy(), rtol=0,
                               atol=1e-4)
    sv = state.forest.split_var.numpy()
    ct = state.forest.count.numpy()
    below_leaf = (sv[..., : (cfg.n_nodes - 1) // 2] < 0)
    kids = np.stack([ct[..., 1::2], ct[..., 2::2]], -1)
    assert (kids[below_leaf] == 0).all()
    want = (sv.reshape(2, -1)[:, :, None] == np.arange(X.shape[1])).sum(1)
    np.testing.assert_array_equal(vi.numpy(), want)
    assert (sv >= 0).any()


def test_ancestor_sampling_off_leaves_the_step_bit_identical():
    """Without ancestor_sampling the step is the route's step alone, and the
    moves' numbers (which would be drawn after the step's) are ignored."""
    X, Yt, cfg, rules = _step_setup()
    pg_off = PgbartConfig(num_particles=6, num_refinements=2)
    base = pgbart.init_state(X, Yt, cfg, chains=2, device="cpu")
    outs = []
    for with_moves in (False, True):
        gen = torch.Generator().manual_seed(9)
        rands = pgbart.draw_rands(
            gen, B=pg_off.batch_size(cfg.m, False), C=2, P=6, D=3,
            n=X.shape[0], k=1, S=cfg.n_nodes, num_refinements=2,
            device="cpu")
        rejuv = (rj.draw_rejuv_rands(gen, moves=cfg.m, C=2, S=cfg.n_nodes,
                                     n=X.shape[0], k=1, device="cpu")
                 if with_moves else None)
        outs.append(pgbart.pgbart_step(base.clone(), rands, X, Yt, rules, cfg,
                                       pg_off, False, torch.ones((2, 120, 1)),
                                       rejuv=rejuv))
    for a, b in zip(dataclasses.astuple(outs[0][0].forest),
                    dataclasses.astuple(outs[1][0].forest)):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][0].tree_pred, outs[1][0].tree_pred)
    assert torch.equal(outs[0][1], outs[1][1])


def test_sample_without_ancestor_sampling_draws_no_moves(monkeypatch):
    calls = []
    real = rj.draw_rejuv_rands
    monkeypatch.setattr(rj, "draw_rejuv_rands",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(40, 2)).astype(np.float32)
    Y = (X[:, 0] + 0.1 * rng.normal(size=40)).astype(np.float32)
    for flag in (False, True):
        with tpmb.Model():
            mu = tpmb.BART("mu", X, Y, m=3)
            tpmb.Normal("y", mu, 0.3, observed=Y)
            idata = tpmb.sample(tune=3, draws=3, chains=2, random_seed=1,
                                device="cpu", ancestor_sampling=flag,
                                convergence_checks=False)
        assert np.isfinite(idata.posterior["mu"].values).all()
        assert len(calls) == (6 if flag else 0)


def test_ancestor_sampling_with_a_linear_response_raises():
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(30, 2)).astype(np.float32)
    Y = X[:, 0].astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with tpmb.Model():
            mu = tpmb.BART("mu", X, Y, m=3, response="linear")
            tpmb.Normal("y", mu, 0.3, observed=Y)
            with pytest.raises(ValueError, match="response='constant'"):
                tpmb.sample(tune=2, draws=2, chains=2, device="cpu",
                            ancestor_sampling=True)


def test_pgbart_step_refuses_ancestor_sampling_with_a_linear_response():
    """The step itself holds the rule that sample() checks up front: a linear
    forest asked for rejuvenation raises instead of skipping the moves."""
    X, Yt, cfg, rules = _step_setup()
    cfg = dataclasses.replace(cfg, response="linear")
    pgc = PgbartConfig(num_particles=6, num_refinements=2,
                       ancestor_sampling=True)
    state = pgbart.init_state(X, Yt, cfg, chains=2, device="cpu")
    gen = torch.Generator().manual_seed(3)
    with pytest.raises(ValueError, match="response='constant'"):
        _step(state, gen, X, Yt, rules, cfg, pgc, False, "rounds")
