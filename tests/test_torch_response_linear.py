"""The linear and mix leaf responses: the port's per-round route against the
JAX package's (``PYMC_BART_TPU_PALLAS=1``, ``PYMC_BART_TPU_MEGAKERNEL=0``:
the growth kernel in interpret mode with its least-squares slope
statistics, the winner and the refinement in XLA), fed JAX's own draws from
the same keys; then ``sample()`` on the CPU and the models that keep their
refusal.

Two chains, two consecutive steps; tuning off for the linear response and
on for the mix response (each configuration costs a JAX trace of the
per-round step).  Tolerances as
tests/test_torch_pgbart_step.py: tree structure, counts, VI, iteration and
batch offset exactly equal; ``split_val`` rtol 1e-5 / atol 1e-6; leaves and
slopes rtol 1e-4 / atol 1e-5; predictions and Welford means rtol 1e-4 /
atol 1e-4 (float sums are taken in another order)."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymc_bart_tpu.config import BartConfig, PgbartConfig
from pymc_bart_tpu.sampler import pgbart

import pymc_bart_tpu_torch as tpmb
from pymc_bart_tpu_torch import convert
from pymc_bart_tpu_torch.config import BartConfig as TBartConfig
from pymc_bart_tpu_torch.config import PgbartConfig as TPgbartConfig
from pymc_bart_tpu_torch.ops.predict import forest_predict
from pymc_bart_tpu_torch.ops.trees import Forest
from pymc_bart_tpu_torch.sampler import pgbart as tpgbart

N, P_COLS, M, DEPTH, PARTICLES = 48, 3, 6, 3, 4


def _setup(seed=0):
    """Centred covariates: the least-squares statistics are then well
    conditioned.  (Uniform [0, 1] covariates give children of a few rows near
    1, where ``sum x^2 - (sum x)^2 / c`` cancels four digits in float32; the
    reference's matmul and the port's exact fixed-point sums round the inputs
    of that difference apart by one unit, and the slope by 5e-4.)"""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, P_COLS)).astype(np.float32)
    Y = (2.0 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.normal(size=N)
         ).astype(np.float32)[:, None]
    return X, Y


def _loglik(f, params):
    y, w = params
    return jnp.sum(-0.5 * w * (y - f) ** 2)


def _rands_linear(key, B, P, D, n, S, num_refinements):
    """The draws of the JAX package's per-tree key sequence on its per-round
    route for a linear / mix tree (``pgbart._update_one_tree``: the growth
    blocks, ``u_mix`` from k6, the winner by ``categorical(k_sel, log_w)`` =
    arg-max of ``log_w`` plus ``gumbel(k_sel, (P,))``, and per refinement
    sweep ``normal(k_eps, (S, k))`` and ``uniform(k_acc, ())`` from successive
    splits of the carried key), as the 11-tuple of
    ``convert.rands_from_numpy``."""
    k, Gtot = 1, 2**D - 1
    R = max(num_refinements, 1)
    out = [[] for _ in range(11)]
    kc = key
    for _ in range(B):
        kc, k_tree = jax.random.split(kc)
        _k_init, kk = jax.random.split(k_tree)
        kk, k1, k2, k3, k4, k5, k6, k_res_all = jax.random.split(kk, 8)
        res_keys = jax.random.split(k_res_all, D)
        kk, k_sel = jax.random.split(kk)
        epsr, uacc = [], []
        for _r in range(num_refinements):
            kk, k_eps, k_acc = jax.random.split(kk, 3)
            epsr.append(jax.random.normal(k_eps, (S, k)).T)
            uacc.append(jax.random.uniform(k_acc, ()))
        if num_refinements == 0:
            epsr, uacc = [jnp.zeros((k, S))] * R, [jnp.ones(())] * R
        blocks = (
            jax.random.uniform(k1, (P, Gtot)), jax.random.uniform(k2, (P, Gtot)),
            jax.random.gumbel(k3, (D, P, n)),
            jax.random.normal(k4, (P, 2 * Gtot, k)),
            jax.random.bits(k5, (P, Gtot), dtype=jnp.uint32),
            jnp.stack([jax.random.uniform(res_keys[d], ()) for d in range(D)]),
            jnp.zeros(()), jnp.stack(epsr), jnp.stack(uacc),
            jax.random.uniform(k6, (P, 2 * Gtot)),
            jax.random.gumbel(k_sel, (P,)))
        for acc, b in zip(out, blocks):
            acc.append(np.asarray(b))
    return [np.stack(a) for a in out]


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


@pytest.mark.parametrize("response,tuning", [("linear", False),
                                             ("mix", True)])
def test_step_matches_jax_per_round_route(response, tuning, monkeypatch):
    monkeypatch.setenv("PYMC_BART_TPU_PALLAS", "1")
    monkeypatch.setenv("PYMC_BART_TPU_MEGAKERNEL", "0")
    X, Y = _setup()
    cfg = BartConfig(m=M, max_depth=DEPTH, response=response)
    pg = PgbartConfig(num_particles=PARTICLES, batch=(0.5, 0.5))
    tcfg = TBartConfig(m=M, max_depth=DEPTH, response=response)
    tpg = TPgbartConfig(num_particles=PARTICLES, batch=(0.5, 0.5))
    B = pg.batch_size(M, tuning)
    w_chain = [4.0, 2.5]  # per-chain noise precision
    Xj, Yj, rules = jnp.asarray(X), jnp.asarray(Y), jnp.zeros(P_COLS,
                                                              jnp.int32)
    jstates = [pgbart.init_state(Xj, Yj, cfg) for _ in w_chain]
    tstate = tpgbart.init_state(X, Y, tcfg, chains=len(w_chain), device="cpu")
    gw_t = torch.tensor(w_chain)[:, None, None].expand(-1, N, 1).contiguous()
    assert tpgbart.resolve_route(
        None, tcfg, tpg, torch.from_numpy(X), gw_t, "gauss", chains=2,
        w_scalar=True, all_cont=True, x_nan=False)[0] == "rounds"
    for step in range(2):
        keys = [jax.random.PRNGKey(3 + 10 * step + c)
                for c in range(len(w_chain))]
        want_vis = []
        for c, key in enumerate(keys):
            gw = jnp.full((N, 1), w_chain[c], jnp.float32)
            jstates[c], vi = pgbart.pgbart_step(
                key, jstates[c], Xj, Yj, rules, cfg, pg, _loglik, (Yj, gw),
                tuning, gauss_w=gw)
            want_vis.append(vi)
        rands = convert.rands_from_numpy(
            [_rands_linear(key, B, PARTICLES, DEPTH, N, cfg.n_nodes,
                           pg.num_refinements) for key in keys], "cpu")
        tstate, got_vi = tpgbart.pgbart_step(
            tstate, rands, torch.from_numpy(X), torch.from_numpy(Y),
            torch.zeros(P_COLS, dtype=torch.int32), tcfg, tpg, tuning, gw_t)
        _compare(jstates, want_vis, tstate, got_vi,
                 f"{response} tuning={tuning} step={step}")
    got = convert.state_to_numpy(tstate)
    assert (got["split_var"] >= 0).any() and (got["slope"] != 0).any()


def _model(X, Y, response="linear", lik="normal", shape=None):
    mu = tpmb.BART("mu", X, Y if lik == "normal" else (Y > Y.mean()) * 1.0,
                   m=5, max_depth=3, response=response, shape=shape)
    if lik == "bernoulli":
        labels = (Y > Y.mean()) * 1.0
        tpmb.Bernoulli("y", tpmb.math.sigmoid(mu), observed=labels)
    else:
        sigma = tpmb.HalfNormal("sigma", 1.0)
        tpmb.Normal("y", mu if shape is None else mu[0], sigma, observed=Y)
    return mu


def test_sample_linear_on_the_cpu():
    X, Y = _setup(1)
    Y = Y[:, 0]
    with tpmb.Model():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mu = _model(X, Y)
            idata = tpmb.sample(tune=6, draws=6, chains=2, num_particles=4,
                                random_seed=1, device="cpu",
                                convergence_checks=False)
    post = idata.posterior["mu"].values
    assert post.shape == (2, 6, N) and np.isfinite(post).all()
    tr = mu.all_trees
    assert tr.slope.shape == tr.leaf.shape and (tr.slope != 0).any()
    vi = idata.sample_stats["variable_inclusion"].values
    recount = np.stack([(tr.split_var == j).sum(axis=(2, 3))
                        for j in range(P_COLS)], axis=-1)
    np.testing.assert_array_equal(vi[:, :, 0, :], recount)
    # the stored forests, slopes included, predict the posterior draws
    t = torch.as_tensor
    forest = Forest(t(tr.split_var), t(tr.split_val),
                    t(tr.split_set.view(np.int32)), t(tr.leaf), t(tr.count),
                    t(tr.slope))
    pred = forest_predict(forest, t(X), t(np.zeros(P_COLS, np.int32)), 3)
    np.testing.assert_allclose(pred[..., 0].numpy(), post, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kw, word", [
    (dict(response="mix", lik="bernoulli"), "response"),
    (dict(response="linear", shape=(2, N)), "response")],
    ids=["mix_bernoulli", "linear_two_outputs"])
def test_sample_refuses_what_waits(kw, word):
    """Both models run on the per-round route: a mix classifier
    (closed-form Bernoulli code) and a linear joint forest of two outputs
    (the generic likelihood); finite draws, slopes stored, and the stored
    forests predict the last draw."""
    X, Y = _setup(2)
    with tpmb.Model():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mu = _model(X, Y[:, 0], **kw)
        with pytest.warns(UserWarning, match="per-round"):
            idata = tpmb.sample(tune=4, draws=3, chains=2, num_particles=4,
                                random_seed=2, device="cpu",
                                convergence_checks=False)
    post = idata.posterior["mu"].values
    k = 1 if "shape" not in kw else 2
    assert post.shape == (2, 3) + ((N,) if k == 1 else (2, N))
    assert np.isfinite(post).all() and word == "response"
    tr = mu.all_trees
    assert tr.n_outputs == k and (tr.slope != 0).any()
    t = torch.as_tensor
    last = Forest(*(t(np.ascontiguousarray(a[:, -1])) for a in (
        tr.split_var, tr.split_val, tr.split_set.view(np.int32), tr.leaf,
        tr.count, tr.slope)))
    pred = forest_predict(last, t(X), t(np.zeros(P_COLS, np.int32)), 3)
    want = post[:, -1] if k == 1 else post[:, -1].transpose(0, 2, 1)
    np.testing.assert_allclose(pred.numpy().reshape(want.shape), want,
                               rtol=1e-5, atol=1e-5)
