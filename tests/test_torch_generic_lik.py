"""The generic model likelihood and joint multi-output forests in the port.

* The port's closure (``compound.make_loglik``, with ``out`` for one column,
  evaluated one chain at a time and batched by ``pgbart.batched_loglik``)
  against the JAX package's ``_make_loglik`` / ``_make_loglik_output`` on the
  same theta and candidate values, for Poisson, StudentT, the joint
  heteroscedastic expression, a joint Categorical and a separate-trees scale
  forest without a closed form: rtol 1e-5.
* The per-round route with ``lik="generic"`` against the same route with the
  closed-form code, on the same ``StepRands``, for two likelihoods that have
  both (``Bernoulli(sigmoid(f))`` and ``Normal(f, fixed sigma)``): tree
  structure and counts equal, leaves rtol 1e-4.  The generic closure keeps
  the constants of the log-density (-log sigma, -1/2 log 2 pi) and sums in
  float32, the closed forms drop them and sum in float64; these cancel in
  the SMC weights and the refinement ratio but not in float32 rounding, so
  the decisions are held on the fixed seeds below.
* ``select_refine_plain`` at k = 2 against an explicit loop, rejuvenation
  with the generic ``ll_of``, and ``sample()`` of the joint heteroscedastic
  model of ``tests/test_baseline_configs.py`` and the coal-mining Poisson
  model of ``examples/coal_disasters.py`` on the CPU.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymc_bart_tpu as jpmb
import pymc_bart_tpu_torch as tpmb
from pymc_bart_tpu.sampler import compound as jcompound
from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
from pymc_bart_tpu_torch.ops.predict import forest_predict
from pymc_bart_tpu_torch.ops.select import select_refine_plain
from pymc_bart_tpu_torch.sampler import compound as tcompound
from pymc_bart_tpu_torch.sampler import pgbart as tpgbart
from pymc_bart_tpu_torch.sampler import rejuvenate as trejuv

N = 40


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    Y = (2 * np.sin(2 * X[:, 0]) + rng.normal(0, 0.5, n)).astype(np.float32)
    counts = rng.poisson(np.exp(0.5 * X[:, 0]) * 2).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.float32)
    return X, Y, counts, labels


def _poisson(pmb, X, Y, counts, labels):
    mu = pmb.BART("mu", X, np.log1p(counts), m=4)
    pmb.Poisson("y", mu=pmb.math.exp(mu) * 1.5, observed=counts)
    return "mu", 1, None


def _student(pmb, X, Y, counts, labels):
    mu = pmb.BART("mu", X, Y, m=4)
    s = pmb.HalfNormal("s", 1.0)
    pmb.StudentT("y", nu=4.0, mu=mu, sigma=s, observed=Y)
    return "mu", 1, None


def _het_joint(pmb, X, Y, counts, labels):
    w = pmb.BART("w", X, Y, m=4, shape=(2, N))
    pmb.Normal("y", w[0], pmb.math.abs(w[1]) + 0.05, observed=Y)
    return "w", 2, None


def _cat_joint(pmb, X, Y, counts, labels):
    lo = pmb.BART("lo", X, labels, m=4, shape=(3, N))
    pmb.Categorical("y", p=pmb.math.softmax(lo.T, axis=-1), observed=labels)
    return "lo", 3, None


def _scale_output(pmb, X, Y, counts, labels):
    # a separate-trees scale link without a closed form: output 1 generic
    w = pmb.BART("w", X, Y, m=4, shape=(2, N), separate_trees=True)
    s = pmb.HalfNormal("s", 1.0)
    pmb.Normal("y", w[0], s * pmb.math.abs(w[1]) + 0.1, observed=Y)
    return "w", 2, 1


MODELS = {"poisson": _poisson, "student_t": _student,
          "het_joint": _het_joint, "categorical_joint": _cat_joint,
          "scale_output": _scale_output}


@pytest.mark.parametrize("name", list(MODELS))
def test_closures_match_jax(name):
    data = _data()
    with jpmb.Model() as jm:
        vname, k, out = MODELS[name](jpmb, *data)
    with tpmb.Model() as tm:
        MODELS[name](tpmb, *data)
    jc = jcompound.CompiledModel(jm)
    tc = tcompound.CompiledModel(tm, "cpu")
    assert tc.theta_size == jc.theta_size
    if out is None:
        jfn = jcompound._make_loglik(jc, vname)
        tfn = tcompound.make_loglik(tc, vname)
    else:
        jfn = jcompound._make_loglik_output(jc, vname, out)
        tfn = tcompound.make_loglik(tc, vname, out)
    # the fused-code detection leaves these to the generic closure
    brv = tm.bart_rvs[0]
    assert tcompound._fused_likelihood(tm, brv, out=out) is None

    rng = np.random.default_rng(7)
    C, Q = 2, 3
    theta = rng.normal(0, 0.3, (C, tc.theta_size)).astype(np.float32)
    cur = rng.normal(0, 0.5, (C, N, k)).astype(np.float32)
    kf = 1 if out is not None else k
    F = rng.normal(0, 0.5, (C, Q, N, kf)).astype(np.float32)
    want = np.array([[float(jfn(jnp.asarray(F[c, q]),
                                (jnp.asarray(theta[c]),
                                 {vname: jnp.asarray(cur[c])})))
                      for q in range(Q)] for c in range(C)])
    one = float(tfn(torch.from_numpy(F[0, 0]),
                    (torch.from_numpy(theta[0]),
                     {vname: torch.from_numpy(cur[0])})))
    batched = tpgbart.batched_loglik(
        tfn, (torch.from_numpy(theta), {vname: torch.from_numpy(cur)}))(
        torch.from_numpy(F)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(one, want[0, 0], rtol=1e-5)
    np.testing.assert_allclose(batched, want, rtol=1e-5)


def _route_pair(lik, seed):
    """Two PGBART steps of the per-round route with the closed-form code
    ``lik`` and with the generic closure of the same likelihood, from one
    state and the same random blocks."""
    rng = np.random.default_rng(seed)
    n, C, sigma = 36, 2, 0.7
    X = rng.uniform(size=(n, 2)).astype(np.float32)
    f = 2 * np.sin(3 * X[:, 0])
    if lik == "bernoulli":
        Y = (rng.uniform(size=n) < 1 / (1 + np.exp(-f))).astype(np.float32)
    else:
        Y = (f + sigma * rng.normal(size=n)).astype(np.float32)
    with tpmb.Model() as model:
        mu = tpmb.BART("mu", X, Y, m=5, max_depth=4)
        if lik == "bernoulli":
            tpmb.Bernoulli("y", tpmb.math.sigmoid(mu), observed=Y)
        else:
            tpmb.Normal("y", mu, sigma, observed=Y)
    cfg = BartConfig(m=5, max_depth=4)
    pg = PgbartConfig(num_particles=6, num_refinements=3)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y[:, None])
    rules = torch.zeros(2, dtype=torch.int32)
    compiled = tcompound.CompiledModel(model, "cpu")
    loglik = tcompound.make_loglik(compiled, "mu")
    row = (None if lik == "bernoulli"
           else torch.full((C, n, 1), 1.0 / sigma**2))
    gen = torch.Generator().manual_seed(seed)
    blocks = [tpgbart.draw_rands(
        gen, B=pg.batch_size(cfg.m, tuning), C=C, P=pg.num_particles,
        D=cfg.max_depth, n=n, k=1, S=cfg.n_nodes,
        num_refinements=pg.num_refinements, device="cpu")
        for tuning in (True, False)]
    out = {}
    for kind in (lik, "generic"):
        state = tpgbart.init_state(Xt, Yt, cfg, chains=C, device="cpu")
        for tuning, rands in zip((True, False), blocks):
            params = (torch.zeros((C, 0)), {"mu": state.sum_trees.clone()})
            state, vi = tpgbart.pgbart_step(
                state, rands, Xt, Yt, rules, cfg, pg, tuning,
                None if kind == "generic" else row, lik=kind,
                route="rounds", loglik_fn=loglik, lik_params=params)
        out[kind] = (state, vi)
    return out[lik], out["generic"]


@pytest.mark.parametrize("lik, seed", [("bernoulli", 0), ("gauss", 1)])
def test_generic_route_matches_closed_form(lik, seed):
    (a, vi_a), (b, vi_b) = _route_pair(lik, seed)
    for name in ("split_var", "split_set", "count"):
        torch.testing.assert_close(getattr(a.forest, name),
                                   getattr(b.forest, name), rtol=0, atol=0)
    torch.testing.assert_close(vi_a, vi_b, rtol=0, atol=0)
    torch.testing.assert_close(a.forest.leaf, b.forest.leaf, rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(a.sum_trees, b.sum_trees, rtol=1e-4,
                               atol=1e-5)
    assert (a.forest.split_var >= 0).any()       # the trees grew


def test_generic_route_refuses_the_whole_step_routes():
    cfg = BartConfig(m=4, max_depth=3, n_outputs=2)
    pg = PgbartConfig(num_particles=4)
    X = torch.zeros((10, 2))
    for route, word in (("fused", "fused"), ("bign", "large-n")):
        with pytest.raises(ValueError, match=word):
            tpgbart.resolve_route(route, cfg, pg, X, None, "generic",
                                  chains=1, w_scalar=False, all_cont=True,
                                  x_nan=False)
    taken, why = tpgbart.resolve_route(None, cfg, pg, X, None, "generic",
                                       chains=1, w_scalar=False,
                                       all_cont=True, x_nan=False)
    assert taken == "rounds" and "generic" in why["fused"]


def _select_loop(sv, ct, lf, li, pred, log_w, resid, eps, u_acc, u_sel, hiv,
                 m, ll_fn):
    """One chain of ``select_refine_plain`` written as a loop in float64."""
    P, k, S = lf.shape
    w = np.exp(log_w - log_w.max())
    cdf = np.cumsum(w)
    widx = min(int((cdf < u_sel * cdf[-1]).sum()), P - 1)
    lf_w, li_w, pred_w = lf[widx].copy(), li[widx], pred[widx].copy()
    mask = ((sv[widx] < 0) & (ct[widx] > 0)).astype(np.float64)
    center = np.zeros((k, S))
    for s in range(S):
        rows = li_w == s
        center[:, s] = (resid[:, rows].astype(np.float64).sum(1)
                        / max(ct[widx, s], 1.0) / m)

    def lp(lf_x):
        return -sum(hiv[j] * (mask * (lf_x[j] - center[j]) ** 2).sum()
                    for j in range(k))

    ll_c = ll_fn(pred_w) + lp(lf_w)
    for i in range(eps.shape[0]):
        lf_p = lf_w + eps[i] * mask
        pred_p = lf_p[:, li_w]
        ll_p = ll_fn(pred_p) + lp(lf_p)
        if np.log(u_acc[i]) < ll_p - ll_c:
            lf_w, pred_w, ll_c = lf_p, pred_p, ll_p
    return widx, lf_w, pred_w


def test_select_refine_plain_two_outputs_matches_a_loop():
    rng = np.random.default_rng(11)
    C, P, k, D, n, R, m = 3, 5, 2, 3, 30, 6, 4
    S = 2 ** (D + 1) - 1
    # complete trees of depth 2 (slots 0-2 split, 3-6 leaves), rows spread
    sv = np.full((C, P, S), -1, np.int32)
    sv[:, :, :3] = rng.integers(0, 2, (C, P, 3))
    li = rng.integers(3, 7, (C, P, n)).astype(np.int32)
    ct = np.zeros((C, P, S), np.float32)
    for c in range(C):
        for q in range(P):
            ct[c, q] = np.bincount(li[c, q], minlength=S)
    lf = rng.normal(0, 0.5, (C, P, k, S)).astype(np.float32)
    pred = np.take_along_axis(lf, li[:, :, None, :].repeat(k, 2), 3)
    log_w = rng.normal(0, 2, (C, P)).astype(np.float32)
    resid = rng.normal(0, 1, (C, k, n)).astype(np.float32)
    eps = rng.normal(0, 0.2, (C, R, k, S)).astype(np.float32)
    u_acc = rng.uniform(size=(C, R)).astype(np.float32)
    u_sel = rng.uniform(size=C).astype(np.float32)
    hiv = rng.uniform(1, 3, (C, k)).astype(np.float32)
    y = rng.normal(0, 1, (C, k, n)).astype(np.float32)

    def ll_torch(pred_x):                  # a non-Gaussian row likelihood
        return -(torch.from_numpy(y) - pred_x).abs().sum((1, 2))

    T = torch.from_numpy
    got = select_refine_plain(
        T(sv), T(np.zeros((C, P, S), np.float32)),
        T(np.zeros((C, P, S), np.int32)), T(lf), T(ct), T(li), T(pred),
        T(log_w), T(resid), T(np.zeros((C, k, n), np.float32)), T(eps),
        T(u_acc), T(u_sel), T(hiv), num_refinements=R, m=m, ll_fn=ll_torch)
    for c in range(C):
        widx, lf_w, pred_w = _select_loop(
            sv[c], ct[c], lf[c], li[c], pred[c], log_w[c], resid[c], eps[c],
            u_acc[c], u_sel[c], hiv[c], m,
            lambda px: -np.abs(y[c] - px).sum())
        np.testing.assert_array_equal(got[0][c].numpy(), sv[c, widx])
        np.testing.assert_array_equal(got[5][c].numpy(), li[c, widx])
        np.testing.assert_allclose(got[3][c].numpy(), lf_w, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got[6][c].numpy(), pred_w, rtol=1e-5,
                                   atol=1e-6)


def test_rejuvenation_with_the_generic_likelihood():
    """The sweep under the generic ``ll_of`` of ``Normal(f, sigma)`` takes
    the closed form's decisions (same numbers), and a joint two-output
    forest's sweep keeps ``tree_pred`` equal to the forest's predictions."""
    rng = np.random.default_rng(5)
    n, C, sigma = 40, 3, 0.6
    X = rng.uniform(size=(n, 2)).astype(np.float32)
    Y = (np.sin(4 * X[:, 0]) + sigma * rng.normal(size=n)).astype(np.float32)
    Xt, rules = torch.from_numpy(X), torch.zeros(2, dtype=torch.int32)
    for k in (1, 2):
        cfg = BartConfig(m=4, max_depth=3, n_outputs=k)
        pg = PgbartConfig(num_particles=4, ancestor_sampling=True,
                          rejuvenation_sweeps=3)
        with tpmb.Model() as model:
            w = tpmb.BART("w", X, Y, m=4, max_depth=3,
                          shape=(2, n) if k == 2 else None)
            if k == 1:
                tpmb.Normal("y", w, sigma, observed=Y)
            else:
                tpmb.Normal("y", w[0], tpmb.math.abs(w[1]) + 0.05,
                            observed=Y)
        loglik = tcompound.make_loglik(tcompound.CompiledModel(model, "cpu"),
                                       "w")
        Yt = torch.from_numpy(np.repeat(Y[:, None], k, 1))
        gen = torch.Generator().manual_seed(2)
        state = tpgbart.init_state(Xt, Yt, cfg, chains=C, device="cpu")
        for _ in range(3):                  # grow some trees first
            rands = tpgbart.draw_rands(
                gen, B=2, C=C, P=4, D=3, n=n, k=k, S=cfg.n_nodes,
                num_refinements=5, device="cpu")
            params = (torch.zeros((C, 0)), {"w": state.sum_trees.clone()})
            state, _ = tpgbart.step_rounds(
                state, rands, Xt, Yt, rules, cfg, pg, True, None,
                lik="generic", loglik_fn=loglik, lik_params=params)
        rj = trejuv.draw_rejuv_rands(gen, moves=12, C=C, S=cfg.n_nodes, n=n,
                                     k=k, device="cpu")
        params = (torch.zeros((C, 0)), {"w": state.sum_trees.clone()})
        ll_gen = tpgbart.make_ll_of("generic", 0.0, None, Yt[None], loglik,
                                    params)
        moved = trejuv.rejuvenate_forest(state.clone(), rj, Xt, Yt, rules,
                                         cfg, pg, ll_gen, True)
        f = moved.forest
        assert not torch.equal(f.split_var, state.forest.split_var) or \
            not torch.equal(f.leaf, state.forest.leaf)
        per_tree = forest_predict(f, Xt, rules, cfg.max_depth)
        torch.testing.assert_close(moved.sum_trees, per_tree, rtol=1e-5,
                                   atol=1e-5)
        if k == 1:
            ll_cf = tpgbart.make_ll_of(
                "gauss", 0.0, torch.full((C, n, 1), 1 / sigma**2), Yt[None])
            want = trejuv.rejuvenate_forest(state.clone(), rj, Xt, Yt, rules,
                                            cfg, pg, ll_cf, True)
            for name in ("split_var", "split_val", "count"):
                torch.testing.assert_close(getattr(f, name),
                                           getattr(want.forest, name),
                                           rtol=0, atol=0, equal_nan=True)
            torch.testing.assert_close(f.leaf, want.forest.leaf, rtol=1e-5,
                                       atol=1e-6)


def test_sample_het_joint_tracks_the_mean():
    """``config_het_joint`` in miniature (``tests/test_baseline_configs.py``
    ``test_heteroscedastic_two_output``: n=150, m=20, one chain; 100/100
    steps here, 150/150 there)."""
    rng = np.random.default_rng(2)
    n = 150
    X = rng.uniform(-1, 1, size=(n, 2))
    mu_true = np.where(X[:, 0] > 0, 3.0, -3.0)
    sd_true = np.where(X[:, 1] > 0, 2.0, 0.3)
    Y = rng.normal(mu_true, sd_true)
    with tpmb.Model():
        w = tpmb.BART("w", X, Y, m=20, shape=(2, n))
        tpmb.Normal("y", w[0], tpmb.math.abs(w[1]) + 0.05, observed=Y)
        with pytest.warns(UserWarning, match="per-round"):
            idata = tpmb.sample(tune=100, draws=100, chains=1,
                                random_seed=3, device="cpu")
    post = idata.posterior["w"].values
    assert post.shape == (1, 100, 2, n) and np.isfinite(post).all()
    r = np.corrcoef(post.mean(axis=(0, 1))[0], mu_true)[0, 1]
    assert r > 0.8, r
    assert w.all_trees.n_outputs == 2
    pred = tpmb.utils.sample_posterior(w.all_trees, X, size=3,
                                       rng=np.random.default_rng(0),
                                       device="cpu")
    assert pred.shape == (3, n, 2)


def test_sample_coal_rate_drops():
    """``examples/coal_disasters.py``: Poisson(exp(BART)) on 56 bins of
    1851-1962; the rate before 1890 over the rate after 1900 (about 3 in
    the example's output)."""
    disasters = np.array([
        4, 5, 4, 0, 1, 4, 3, 4, 0, 6, 3, 3, 4, 0, 2, 6, 3, 3, 5, 4, 5, 3, 1,
        4, 4, 1, 5, 5, 3, 4, 2, 5, 2, 2, 3, 4, 2, 1, 3, 2, 2, 1, 1, 1, 1, 3,
        0, 0, 1, 0, 1, 1, 0, 0, 3, 1, 0, 3, 2, 2, 0, 1, 1, 1, 0, 1, 0, 1, 0,
        0, 0, 2, 1, 0, 0, 0, 1, 1, 0, 2, 3, 3, 1, 1, 2, 1, 1, 1, 1, 2, 4, 2,
        0, 0, 0, 1, 4, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 1])
    years = np.arange(1851, 1963)
    edges = np.linspace(years[0], years[-1] + 1, 57)
    centers = 0.5 * (edges[:-1] + edges[1:])
    counts, _ = np.histogram(np.repeat(years, disasters), bins=edges)
    exposure = np.diff(edges)
    Y = counts.astype(float)
    with tpmb.Model():
        mu = tpmb.BART("mu", centers[:, None], np.log1p(Y), m=20)
        tpmb.Poisson("y", mu=tpmb.math.exp(mu) * exposure / exposure.mean(),
                     observed=Y)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            idata = tpmb.sample(tune=100, draws=100, chains=2, random_seed=0,
                                device="cpu")
    rate = np.exp(idata.posterior["mu"].values).mean(axis=(0, 1))
    ratio = rate[centers < 1890].mean() / rate[centers > 1900].mean()
    assert ratio > 2.0, ratio
