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


@pytest.mark.parametrize("kw, lik, word", [
    (dict(response="linear"), "bernoulli", None),
    (dict(response="mix"), "het_abs", None),
    (dict(n_outputs=2), "gauss", "n_outputs")],
    ids=["linear_bernoulli", "mix_het_abs", "two_outputs_gauss"])
def test_step_refuses_what_is_not_ported(kw, lik, word):
    """A closed-form code with two outputs is refused; the linear and mix
    responses under a non-Gaussian code run on the per-round route
    (tests/test_torch_linear_lik.py holds them to the JAX package): two
    steps leave finite sums of trees equal to the forests' predictions,
    with slopes drawn."""
    X, Y = _setup()
    tpg = TPgbartConfig(num_particles=PARTICLES)
    tcfg = TBartConfig(m=M, max_depth=DEPTH, **kw)
    Xt = torch.from_numpy(X)
    if word is not None:
        with pytest.raises(NotImplementedError, match=word):
            tpgbart.pgbart_step(None, None, Xt, None, None, tcfg, tpg, False,
                                None, lik=lik)
        return
    C = 2
    if lik == "bernoulli":
        Yt, row = torch.from_numpy((Y > Y.mean()).astype(np.float32)), None
    else:
        dev = np.abs(Y - Y.mean())
        Yt = torch.from_numpy(dev / 0.7978845608 - 0.1)
        row = torch.from_numpy(dev * dev)[None].expand(C, N, 1).contiguous()
    rules = torch.zeros(P_COLS, dtype=torch.int32)
    state = tpgbart.init_state(X, Yt, tcfg, chains=C, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        rands = tpgbart.draw_rands(
            gen, B=tpg.batch_size(M, True), C=C, P=PARTICLES, D=DEPTH, n=N,
            k=1, S=tcfg.n_nodes, num_refinements=tpg.num_refinements,
            device="cpu", response=tcfg.response)
        state, vi = tpgbart.pgbart_step(state, rands, Xt, Yt, rules, tcfg,
                                        tpg, True, row, lik=lik,
                                        lik_const=0.1)
    assert torch.isfinite(state.sum_trees).all()
    assert (state.forest.slope != 0).any()
    refreshed = tpgbart.refresh_tree_pred(state.clone(), Xt, rules, tcfg)
    torch.testing.assert_close(refreshed.sum_trees, state.sum_trees,
                               rtol=1e-5, atol=1e-5)


def test_draw_rands_shapes_and_determinism():
    kw = dict(B=3, C=2, P=4, D=3, n=10, k=1, S=15, num_refinements=5,
              device="cpu")
    a = tpgbart.draw_rands(torch.Generator().manual_seed(5), **kw)
    b = tpgbart.draw_rands(torch.Generator().manual_seed(5), **kw)
    assert a.rg.shape == (3, 3, 2, 4, 10) and a.eps.shape == (3, 2, 4, 1, 14)
    assert a.sb.dtype == torch.int32 and a.epsr.shape == (3, 2, 5, 1, 15)
    assert a.seed is None and b.seed is None    # drawn only without the block
    assert a.umix is None and a.gsel is None    # drawn for linear / mix only
    # every chain and row of the draw (StepRands.shard places a part)
    assert (a.chains, a.chain0, a.row0) == (None, 0, 0)
    for f in dataclasses.fields(a):
        if f.name in ("seed", "umix", "gsel", "chains", "chain0", "row0"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert torch.equal(x, y), f.name
        assert torch.isfinite(x.to(torch.float32)).all(), f.name
    assert (a.sb < 0).any() and (a.sb > 0).any()  # all 32 bits are used
