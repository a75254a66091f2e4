"""The kernel-bearing unit as a whole: the port's ``pgbart_step`` on
the CPU against the JAX package's per-round Pallas route (interpret mode),
fed JAX's own random blocks (``draw_pallas._rands_reference``).

Two chains, two consecutive steps, tuning on and off.  Tolerances as
tests/test_draw_pallas.py: tree structure, counts, VI, iteration and batch
offset exactly equal; ``split_val`` rtol 1e-5 / atol 1e-6; leaves rtol 1e-4 /
atol 1e-5; predictions and Welford means rtol 1e-4 / atol 1e-4 or 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymc_bart_tpu.config import BartConfig, PgbartConfig
from pymc_bart_tpu.ops.draw_pallas import _rands_reference
from pymc_bart_tpu.sampler import pgbart

from pymc_bart_tpu_torch import convert
from pymc_bart_tpu_torch.config import BartConfig as TBartConfig
from pymc_bart_tpu_torch.config import PgbartConfig as TPgbartConfig
from pymc_bart_tpu_torch.sampler import pgbart as tpgbart

N, P_COLS, M, DEPTH, PARTICLES = 48, 3, 6, 3, 4


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(N, P_COLS)).astype(np.float32)
    Y = (np.sin(3 * X[:, 0]) + 0.1 * rng.normal(size=N)).astype(
        np.float32)[:, None]
    return X, Y


def _loglik(f, params):
    y, w = params
    return jnp.sum(-0.5 * w * (y - f) ** 2)


def _state_dict(state):
    d = {f.name: np.asarray(getattr(state, f.name))
         for f in dataclasses.fields(state) if f.name != "forest"}
    d.update({f.name: np.asarray(getattr(state.forest, f.name))
              for f in dataclasses.fields(state.forest)})
    return d


def _compare(want_states, want_vis, got, got_vi, tag):
    for c, (want, want_vi) in enumerate(zip(want_states, want_vis)):
        w = _state_dict(want)
        g = convert.state_to_numpy(got, chain=c)
        msg = f"{tag} chain {c}"
        for name in ("split_var", "split_set", "count", "iteration",
                     "batch_offset"):
            np.testing.assert_array_equal(w[name], g[name],
                                          err_msg=f"{name} {msg}")
        assert g["split_set"].dtype == np.uint32
        np.testing.assert_array_equal(np.asarray(want_vi),
                                      got_vi[c].numpy(), err_msg=msg)
        np.testing.assert_allclose(w["split_val"], g["split_val"], rtol=1e-5,
                                   atol=1e-6, err_msg=msg)
        np.testing.assert_allclose(w["leaf"], g["leaf"], rtol=1e-4,
                                   atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(w["sum_trees"], g["sum_trees"], rtol=1e-4,
                                   atol=1e-4, err_msg=msg)
        np.testing.assert_allclose(w["tree_pred"], g["tree_pred"], rtol=1e-4,
                                   atol=1e-4, err_msg=msg)
        np.testing.assert_allclose(w["alpha_vec"], g["alpha_vec"],
                                   err_msg=msg)
        np.testing.assert_allclose(w["leaf_sd"], g["leaf_sd"], rtol=1e-5,
                                   atol=1e-6, err_msg=msg)
        np.testing.assert_allclose(w["wf_mean"], g["wf_mean"], rtol=1e-4,
                                   atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(w["wf_count"], g["wf_count"], err_msg=msg)


@pytest.mark.parametrize("tuning", [False, True])
def test_pgbart_step_matches_jax_per_round_route(tuning, monkeypatch):
    monkeypatch.setenv("PYMC_BART_TPU_PALLAS", "1")
    monkeypatch.setenv("PYMC_BART_TPU_MEGAKERNEL", "0")
    X, Y = _setup()
    cfg = BartConfig(m=M, max_depth=DEPTH)
    pg = PgbartConfig(num_particles=PARTICLES, batch=(0.5, 0.5))
    tcfg = TBartConfig(m=M, max_depth=DEPTH)
    tpg = TPgbartConfig(num_particles=PARTICLES, batch=(0.5, 0.5))
    B = pg.batch_size(M, tuning)
    S, Gtot, R = cfg.n_nodes, 2**DEPTH - 1, pg.num_refinements
    w_chain = [4.0, 2.5]  # per-chain noise precision
    Xj, Yj, rules = jnp.asarray(X), jnp.asarray(Y), jnp.zeros(P_COLS,
                                                              jnp.int32)

    jstates = [pgbart.init_state(Xj, Yj, cfg) for _ in w_chain]
    tstate = tpgbart.init_state(X, Y, tcfg, chains=len(w_chain), device="cpu")
    # the converted initial state equals the port's own
    init = convert.state_from_numpy([_state_dict(s) for s in jstates], "cpu")
    for name, a in convert.state_to_numpy(init).items():
        np.testing.assert_allclose(a, convert.state_to_numpy(tstate)[name],
                                   rtol=1e-6, err_msg=name)

    gw_t = torch.tensor(w_chain)[:, None, None].expand(-1, N, 1).contiguous()
    for step in range(2):
        keys = [jax.random.PRNGKey(7 + 10 * step + c)
                for c in range(len(w_chain))]
        want_vis = []
        for c, key in enumerate(keys):
            gw = jnp.full((N, 1), w_chain[c], jnp.float32)
            jstates[c], vi = pgbart.pgbart_step(
                key, jstates[c], Xj, Yj, rules, cfg, pg, _loglik, (Yj, gw),
                tuning, gauss_w=gw)
            want_vis.append(vi)
        rands = convert.rands_from_numpy(
            [[np.asarray(a) for a in _rands_reference(
                key, B, PARTICLES, DEPTH, N, Gtot, R, S, R)]
             for key in keys], "cpu")
        tstate, got_vi = tpgbart.pgbart_step(
            tstate, rands, torch.from_numpy(X), torch.from_numpy(Y),
            torch.zeros(P_COLS, dtype=torch.int32), tcfg, tpg, tuning, gw_t)
        _compare(jstates, want_vis, tstate, got_vi,
                 f"tuning={tuning} step={step}")
    assert (convert.state_to_numpy(tstate)["split_var"] >= 0).any()


def test_step_refuses_what_is_not_ported():
    X, Y = _setup()
    tpg = TPgbartConfig(num_particles=PARTICLES)
    for kw, word in ((dict(response="linear"), "response"),
                     (dict(n_outputs=2), "n_outputs")):
        tcfg = TBartConfig(m=M, max_depth=DEPTH, **kw)
        with pytest.raises(NotImplementedError, match=word):
            tpgbart.pgbart_step(None, None, torch.from_numpy(X), None, None,
                                tcfg, tpg, False, None)


def test_draw_rands_shapes_and_determinism():
    kw = dict(B=3, C=2, P=4, D=3, n=10, k=1, S=15, num_refinements=5,
              device="cpu")
    a = tpgbart.draw_rands(torch.Generator().manual_seed(5), **kw)
    b = tpgbart.draw_rands(torch.Generator().manual_seed(5), **kw)
    assert a.rg.shape == (3, 3, 2, 4, 10) and a.eps.shape == (3, 2, 4, 1, 14)
    assert a.sb.dtype == torch.int32 and a.epsr.shape == (3, 2, 5, 1, 15)
    assert a.seed is None and b.seed is None    # drawn only without the block
    for f in dataclasses.fields(a):
        if f.name == "seed":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert torch.equal(x, y), f.name
        assert torch.isfinite(x.to(torch.float32)).all(), f.name
    assert (a.sb < 0).any() and (a.sb > 0).any()  # all 32 bits are used
