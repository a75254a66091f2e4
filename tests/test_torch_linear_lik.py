"""The linear and mix leaf responses under the non-Gaussian likelihoods.

The port's per-round step (``grow_round`` with the linear statistics and zero
row weights, the closed-form particle log-likelihood, the winner by inverse
CDF on ``usel`` and the intercept-only refinement whose prediction keeps the
slope term, in ``select_refine_plain``) against the JAX package's per-round
route for ``lik="bernoulli"`` and ``"het_abs"``, fed JAX's own draws from
the same keys.  The environment asks the JAX package for its per-round
kernels (``PYMC_BART_TPU_PALLAS=1``, ``PYMC_BART_TPU_MEGAKERNEL=0``), but it
grows a non-Gaussian forest in XLA (``_grow_round``; its growth kernel is
Gaussian) and selects in its ``fused_other`` branch.  Then ``sample()`` on
the CPU of a linear logistic classifier and of the coal-mining Poisson model
with ``response="linear"`` (the generic likelihood).

Two chains, two consecutive steps.  Tolerances as
tests/test_torch_pgbart_step.py: tree structure, counts, VI, iteration and
batch offset exactly equal; ``split_val`` rtol 1e-5 / atol 1e-6; leaves and
slopes rtol 1e-4 / atol 1e-5; predictions rtol 1e-4 / atol 1e-4, Welford
means rtol 1e-4 / atol 1e-5."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymc_bart_tpu.config import BartConfig, PgbartConfig
from pymc_bart_tpu.ops.draw_pallas import _rands_reference
from pymc_bart_tpu.sampler import pgbart

import pymc_bart_tpu_torch as tpmb
from pymc_bart_tpu_torch import convert
from pymc_bart_tpu_torch.config import BartConfig as TBartConfig
from pymc_bart_tpu_torch.config import PgbartConfig as TPgbartConfig
from pymc_bart_tpu_torch.ops.predict import forest_predict
from pymc_bart_tpu_torch.ops.trees import Forest
from pymc_bart_tpu_torch.sampler import pgbart as tpgbart

N, P_COLS, M, DEPTH, PARTICLES = 48, 3, 6, 3, 4
HET_CONST = 0.1


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(seed=0):
    """Centred covariates (well-conditioned slope statistics, as
    tests/test_torch_response_linear.py explains); labels of a logistic
    model and a heteroscedastic target around a known mean."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, P_COLS)).astype(np.float32)
    logit = 2.0 * X[:, 0] + np.sin(3 * X[:, 1])
    labels = rng.binomial(1, 1 / (1 + np.exp(-logit))).astype(np.float32)
    mu0 = np.sin(X[:, 0]).astype(np.float32)
    y = (mu0 + (0.3 + np.abs(X[:, 1])) * rng.normal(size=N)).astype(
        np.float32)
    return X, labels, y, mu0


def _rands(key, B, P, D, n, S, num_refinements):
    """The draws of the JAX package's per-tree key sequence on its per-round
    route for a non-Gaussian linear / mix tree: ``_rands_reference``'s blocks
    (``fused_other``: winner by ``uniform(k_sel)``, refinement normals and
    uniforms drawn at once) plus ``u_mix`` from k6; the Gaussian winner's
    Gumbels ``gsel`` are not read (zeros)."""
    Gtot, R = 2**D - 1, max(num_refinements, 1)
    blocks = [np.asarray(a) for a in _rands_reference(
        key, B, P, D, n, Gtot, R, S, num_refinements)]
    umix, kc = [], key
    for _ in range(B):
        kc, k_tree = jax.random.split(kc)
        _k_init, kk = jax.random.split(k_tree)
        k6 = jax.random.split(kk, 8)[6]
        umix.append(np.asarray(jax.random.uniform(k6, (P, 2 * Gtot))))
    return blocks + [np.stack(umix), np.zeros((B, P), np.float32)]


def _state_dict(state):
    d = {f.name: np.asarray(getattr(state, f.name))
         for f in dataclasses.fields(state) if f.name != "forest"}
    d.update({f.name: np.asarray(getattr(state.forest, f.name))
              for f in dataclasses.fields(state.forest)})
    return d


_EXACT = ("split_var", "split_set", "count", "iteration", "batch_offset")
_CLOSE = {"split_val": (1e-5, 1e-6), "leaf": (1e-4, 1e-5),
          "slope": (1e-4, 1e-5), "sum_trees": (1e-4, 1e-4),
          "tree_pred": (1e-4, 1e-4), "alpha_vec": (1e-7, 0.0),
          "leaf_sd": (1e-5, 1e-6), "wf_mean": (1e-4, 1e-5),
          "wf_count": (1e-7, 0.0)}


def _compare(want_states, want_vis, got, got_vi, tag):
    for c, (want, want_vi) in enumerate(zip(want_states, want_vis)):
        w = _state_dict(want)
        g = convert.state_to_numpy(got, chain=c)
        msg = f"{tag} chain {c}"
        for name in _EXACT:
            np.testing.assert_array_equal(w[name], g[name],
                                          err_msg=f"{name} {msg}")
        np.testing.assert_array_equal(np.asarray(want_vi), got_vi[c].numpy(),
                                      err_msg=msg)
        for name, (rtol, atol) in _CLOSE.items():
            np.testing.assert_allclose(w[name], g[name], rtol=rtol, atol=atol,
                                       err_msg=f"{name} {msg}")


def _loglik_unused(f, params):
    raise AssertionError("a closed-form code does not call the model closure")


@pytest.mark.parametrize("lik,response,tuning", [
    ("bernoulli", "linear", False), ("bernoulli", "mix", True),
    ("het_abs", "linear", False)])
def test_step_matches_jax_per_round_route(lik, response, tuning,
                                          monkeypatch):
    monkeypatch.setenv("PYMC_BART_TPU_PALLAS", "1")
    monkeypatch.setenv("PYMC_BART_TPU_MEGAKERNEL", "0")
    X, labels, y, mu0 = _setup()
    cfg = BartConfig(m=M, max_depth=DEPTH, response=response)
    pg = PgbartConfig(num_particles=PARTICLES, batch=(0.5, 0.5))
    tcfg = TBartConfig(m=M, max_depth=DEPTH, response=response)
    tpg = TPgbartConfig(num_particles=PARTICLES, batch=(0.5, 0.5))
    B = pg.batch_size(M, tuning)
    chains = 2
    if lik == "bernoulli":
        Y, rows = labels[:, None], [None] * chains
    else:
        # the scale forest's target and per-chain row data (y - mu0)^2
        dev = np.abs(y - mu0)
        Y = (dev / 0.7978845608 - HET_CONST)[:, None].astype(np.float32)
        rows = [((1.0 + 0.5 * c) * dev * dev)[:, None].astype(np.float32)
                for c in range(chains)]
    Xj, Yj, rules = jnp.asarray(X), jnp.asarray(Y), jnp.zeros(P_COLS,
                                                              jnp.int32)
    jstates = [pgbart.init_state(Xj, Yj, cfg) for _ in range(chains)]
    tstate = tpgbart.init_state(X, Y, tcfg, chains=chains, device="cpu")
    row_t = (None if lik == "bernoulli" else
             torch.from_numpy(np.stack(rows)).contiguous())
    assert tpgbart.resolve_route(
        None, tcfg, tpg, torch.from_numpy(X), row_t, lik, chains=chains,
        w_scalar=False, all_cont=True, x_nan=False)[0] == "rounds"
    for step in range(2):
        keys = [jax.random.PRNGKey(5 + 10 * step + c) for c in range(chains)]
        want_vis = []
        for c, key in enumerate(keys):
            gw = None if rows[c] is None else jnp.asarray(rows[c])
            jstates[c], vi = pgbart.pgbart_step(
                key, jstates[c], Xj, Yj, rules, cfg, pg, _loglik_unused,
                None, tuning, gauss_w=gw, lik=lik, lik_const=HET_CONST)
            want_vis.append(vi)
        rands = convert.rands_from_numpy(
            [_rands(key, B, PARTICLES, DEPTH, N, cfg.n_nodes,
                    pg.num_refinements) for key in keys], "cpu")
        tstate, got_vi = tpgbart.pgbart_step(
            tstate, rands, torch.from_numpy(X), torch.from_numpy(Y),
            torch.zeros(P_COLS, dtype=torch.int32), tcfg, tpg, tuning, row_t,
            lik=lik, lik_const=HET_CONST)
        _compare(jstates, want_vis, tstate, got_vi,
                 f"{lik} {response} tuning={tuning} step={step}")
    got = convert.state_to_numpy(tstate)
    assert (got["split_var"] >= 0).any() and (got["slope"] != 0).any()


def _stored_forests_predict_last_draw(rv, post, X):
    tr = rv.all_trees
    assert tr.slope.shape == tr.leaf.shape and (tr.slope != 0).any()
    t = torch.as_tensor
    last = Forest(*(t(np.ascontiguousarray(a[:, -1])) for a in (
        tr.split_var, tr.split_val, tr.split_set.view(np.int32), tr.leaf,
        tr.count, tr.slope)))
    pred = forest_predict(last, t(np.asarray(X, np.float32)),
                          t(rv.rules_array()), rv.config.max_depth)
    np.testing.assert_allclose(pred[..., 0].numpy(), post[:, -1], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("response", ["linear", "mix"])
def test_sample_linear_classifier_on_the_cpu(response):
    """``y ~ Bernoulli(sigmoid(BART))`` with sloped leaves: the per-round
    route with its warning, finite draws, training accuracy above the
    majority rate, and the stored slopes and forests predict the last
    draw."""
    X, labels, _, _ = _setup(1)
    with tpmb.Model():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            lo = tpmb.BART("lo", X, labels, m=5, max_depth=3,
                           response=response)
        tpmb.Bernoulli("y", p=tpmb.math.sigmoid(lo), observed=labels)
        with pytest.warns(UserWarning, match="per-round"):
            idata = tpmb.sample(tune=20, draws=10, chains=2, num_particles=4,
                                random_seed=1, device="cpu",
                                convergence_checks=False)
    post = idata.posterior["lo"].values
    assert post.shape == (2, 10, N) and np.isfinite(post).all()
    acc = float(((post.mean(axis=(0, 1)) > 0) == (labels > 0.5)).mean())
    assert acc > max(labels.mean(), 1 - labels.mean())
    _stored_forests_predict_last_draw(lo, post, X)


def test_sample_coal_linear_rate_drops():
    """``examples/coal_disasters.py`` with ``response="linear"``: the
    generic Poisson likelihood on sloped leaves; the rate before 1890 over
    the rate after 1900 above 1.5 at this budget (about 3 in the
    example's output), and the stored forests predict the last draw."""
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
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mu = tpmb.BART("mu", centers[:, None], np.log1p(Y), m=20,
                           response="linear")
        tpmb.Poisson("y", mu=tpmb.math.exp(mu) * exposure / exposure.mean(),
                     observed=Y)
        with pytest.warns(UserWarning, match="per-round"):
            idata = tpmb.sample(tune=60, draws=40, chains=2, random_seed=0,
                                device="cpu", convergence_checks=False)
    post = idata.posterior["mu"].values
    assert post.shape == (2, 40, 56) and np.isfinite(post).all()
    rate = np.exp(post).mean(axis=(0, 1))
    ratio = rate[centers < 1890].mean() / rate[centers > 1900].mean()
    assert ratio > 1.5, ratio
    _stored_forests_predict_last_draw(mu, post, centers[:, None])
