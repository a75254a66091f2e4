"""The port's large-n step ``ops.bign.pgbart_step_bign`` (its plain version, on
the CPU) against the JAX package's row-tiled Pallas kernel
``bign_pallas.pgbart_step_bign(rng_mode="reference")`` in interpret mode.

Both are fed the same random blocks (``draw_pallas._rands_reference`` through
``convert.rands_from_numpy``): two chains with their own precision or row
data, two consecutive steps, so the state the first step leaves feeds the
second.  n = 300, p = 3, m = 6, depth 3, 4 particles, batch (0.5, 0.5).

Tolerances are those of tests/test_bign.py: tree structure, counts, VI,
iteration and batch offset exactly equal; ``split_val`` rtol 1e-5 / atol 1e-6;
leaves rtol 1e-4 / atol 1e-5; ``sum_trees`` and ``tree_pred`` rtol 1e-4 / atol
1e-4; ``alpha_vec`` equal; ``leaf_sd`` rtol 1e-5 / atol 1e-6.  The JAX kernel
sums its node statistics in float32 and the port in float64 rounded once, so
floats differ in the last bits; at this n no discrete decision flips.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymc_bart_tpu.config import BartConfig, PgbartConfig
from pymc_bart_tpu.ops import bign_pallas, draw_pallas
from pymc_bart_tpu.sampler import pgbart

from pymc_bart_tpu_torch import convert
from pymc_bart_tpu_torch.config import BartConfig as TBartConfig
from pymc_bart_tpu_torch.config import PgbartConfig as TPgbartConfig
from pymc_bart_tpu_torch.ops import bign as tbign

N, P_COLS, M, DEPTH, PARTICLES, CHAINS = 300, 3, 6, 3, 4, 2


def make_data(lik, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(N, P_COLS)).astype(np.float32)
    f_true = np.sin(3 * X[:, 0])
    if lik == "bernoulli":
        Y = rng.binomial(1, 1 / (1 + np.exp(-3 * f_true))).astype(np.float32)
    else:
        Y = (f_true + 0.1 * rng.normal(size=N)).astype(np.float32)
    return X, Y[:, None]


def state_dict(state):
    d = {f.name: np.asarray(getattr(state, f.name))
         for f in dataclasses.fields(state) if f.name != "forest"}
    d.update({f.name: np.asarray(getattr(state.forest, f.name))
              for f in dataclasses.fields(state.forest)})
    return d


def compare_states(want, want_vi, got, got_vi, tag):
    """``want``: the JAX state with a leading chain axis; ``got``: the port's."""
    w_all = state_dict(want)
    for c in range(CHAINS):
        w = {k: v[c] for k, v in w_all.items()}
        g = convert.state_to_numpy(got, chain=c)
        msg = f"{tag} chain {c}"
        for name in ("split_var", "count", "iteration", "batch_offset"):
            np.testing.assert_array_equal(w[name], g[name],
                                          err_msg=f"{name} {msg}")
        np.testing.assert_array_equal(np.asarray(want_vi)[c],
                                      got_vi[c].numpy(), err_msg=msg)
        np.testing.assert_allclose(w["split_val"], g["split_val"], rtol=1e-5,
                                   atol=1e-6, err_msg=msg)
        np.testing.assert_allclose(w["leaf"], g["leaf"], rtol=1e-4,
                                   atol=1e-5, err_msg=msg)
        for name in ("sum_trees", "tree_pred"):
            np.testing.assert_allclose(w[name], g[name], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name} {msg}")
        np.testing.assert_allclose(w["alpha_vec"], g["alpha_vec"],
                                   err_msg=msg)
        np.testing.assert_allclose(w["leaf_sd"], g["leaf_sd"], rtol=1e-5,
                                   atol=1e-6, err_msg=msg)
        np.testing.assert_allclose(w["wf_mean"], g["wf_mean"], rtol=1e-4,
                                   atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(w["wf_count"], g["wf_count"], err_msg=msg)


def run_two_steps(lik, tuning, refinements):
    X, Y = make_data(lik)
    cfg = BartConfig(m=M, max_depth=DEPTH)
    pg = PgbartConfig(num_particles=PARTICLES, batch=(0.5, 0.5),
                      num_refinements=refinements)
    tcfg = TBartConfig(m=M, max_depth=DEPTH)
    tpg = TPgbartConfig(num_particles=PARTICLES, batch=(0.5, 0.5),
                        num_refinements=refinements)
    B = pg.batch_size(M, tuning)
    S, Gtot, R = cfg.n_nodes, 2**DEPTH - 1, max(refinements, 1)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    w = np.array([4.0, 2.5], np.float32)      # per-chain noise precision

    one = pgbart.init_state(Xj, Yj, cfg)
    jstate = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (CHAINS,) + a.shape), one)
    tstate = convert.state_from_numpy([state_dict(one)] * CHAINS, "cpu")

    if lik == "gauss":
        jstep = jax.jit(jax.vmap(lambda k, s, w1: bign_pallas.pgbart_step_bign(
            k, s, Xj, Yj, cfg, pg, w1, tuning, rng_mode="reference")))
        jargs = (jnp.asarray(w)[:, None],)
        w_chain = torch.from_numpy(w.copy())
    else:
        jstep = jax.jit(jax.vmap(lambda k, s: bign_pallas.pgbart_step_bign(
            k, s, Xj, Yj, cfg, pg, jnp.zeros((1,)), tuning,
            rng_mode="reference", lik=lik, llw=jnp.zeros((N,)))))
        jargs = ()
        w_chain = None
    Xt, Yt = torch.from_numpy(X.copy()), torch.from_numpy(Y.copy())
    for step in range(2):
        keys = jnp.stack([jax.random.PRNGKey(11 + 10 * step + c)
                          for c in range(CHAINS)])
        jstate, want_vi = jstep(keys, jstate, *jargs)
        rands = convert.rands_from_numpy(
            [[np.asarray(a) for a in draw_pallas._rands_reference(
                key, B, PARTICLES, DEPTH, N, Gtot, R, S, refinements)]
             for key in keys], "cpu")
        tstate, got_vi = tbign.pgbart_step_bign(
            tstate, rands, Xt, Yt, tcfg, tpg, w_chain, tuning, lik=lik)
        compare_states(jstate, want_vi, tstate, got_vi,
                       f"lik={lik} tuning={tuning} step={step}")
    assert (convert.state_to_numpy(tstate)["split_var"] >= 0).any()


@pytest.mark.parametrize("lik,tuning,refinements", [
    ("gauss", True, 5), ("gauss", False, 5), ("bernoulli", True, 0)])
def test_bign_matches_jax_large_n_kernel(lik, tuning, refinements):
    run_two_steps(lik, tuning, refinements)
