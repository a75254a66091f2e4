"""The port's whole-step function ``ops.draw.pgbart_step_fused`` (its plain
version, on the CPU) against the JAX package's whole-step Pallas kernel
``draw_pallas.pgbart_step_fused(rng_mode="reference")`` in interpret mode.

Both are fed the same random blocks (``draw_pallas._rands_reference`` through
``convert.rands_from_numpy``): two chains with their own row data, two
consecutive steps, so the state the first step leaves feeds the second.  This
file holds the Gaussian code (tuning on and off, NaNs in X, one-hot and subset
columns); ``tests/test_torch_draw_lik.py`` holds the other codes.

Tolerances are those of tests/test_draw_pallas.py: tree structure, counts,
VI, iteration and batch offset exactly equal; ``split_val`` rtol 1e-5 / atol
1e-6; leaves rtol 1e-4 / atol 1e-5; ``sum_trees`` and ``tree_pred`` rtol 1e-4
/ atol 1e-4 (the two sum floats in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymc_bart_tpu.config import BartConfig, PgbartConfig
from pymc_bart_tpu.ops import draw_pallas
from pymc_bart_tpu.sampler import pgbart

from pymc_bart_tpu_torch import convert
from pymc_bart_tpu_torch.config import BartConfig as TBartConfig
from pymc_bart_tpu_torch.config import PgbartConfig as TPgbartConfig
from pymc_bart_tpu_torch.ops import draw as tdraw
from pymc_bart_tpu_torch.sampler import pgbart as tpgbart

N, P_COLS, M, DEPTH, PARTICLES, CHAINS = 48, 3, 6, 3, 4, 2


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_data(seed=0, kind="gauss", with_nan=False, mixed=False):
    """X (N, P_COLS), Y (N, 1), rules (P_COLS,), all NumPy."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(N, P_COLS)).astype(np.float32)
    rules = np.zeros(P_COLS, np.int32)
    if mixed:  # a one-hot and a subset column of small integer categories
        X[:, 1:] = rng.integers(0, 4, size=(N, P_COLS - 1)).astype(np.float32)
        rules[1:] = (1, 2)
    f_true = np.sin(3 * X[:, 0]) + (0.3 * X[:, 1] if mixed else 0.0)
    if with_nan:  # missing covariates route right on both sides
        X[rng.random(size=X.shape) < 0.1] = np.nan
    if kind == "bernoulli":
        Y = rng.binomial(1, 1 / (1 + np.exp(-3 * f_true))).astype(np.float32)
    else:
        Y = (f_true + 0.1 * rng.normal(size=N)).astype(np.float32)
    return X, Y[:, None], rules


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
        for name in ("split_var", "split_set", "count", "iteration",
                     "batch_offset"):
            np.testing.assert_array_equal(w[name], g[name],
                                          err_msg=f"{name} {msg}")
        np.testing.assert_array_equal(np.asarray(want_vi)[c],
                                      got_vi[c].numpy(), err_msg=msg)
        np.testing.assert_allclose(w["split_val"], g["split_val"], rtol=1e-5,
                                   atol=1e-6, err_msg=msg)
        np.testing.assert_allclose(w["leaf"], g["leaf"], rtol=1e-4,
                                   atol=1e-5, err_msg=msg)
        np.testing.assert_array_equal(g["slope"], 0.0, err_msg=msg)
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


def run_two_steps(X, Y, rules, lik_row, *, lik, tuning, lik_const=0.0):
    """Two consecutive steps on both sides; ``lik_row``: (CHAINS, N, 1) NumPy
    or None.  Returns the port's final state."""
    cfg = BartConfig(m=M, max_depth=DEPTH)
    pg = PgbartConfig(num_particles=PARTICLES, batch=(0.5, 0.5))
    tcfg = TBartConfig(m=M, max_depth=DEPTH)
    tpg = TPgbartConfig(num_particles=PARTICLES, batch=(0.5, 0.5))
    B = pg.batch_size(M, tuning)
    S, Gtot, R = cfg.n_nodes, 2**DEPTH - 1, pg.num_refinements
    Xj, Yj, rj = jnp.asarray(X), jnp.asarray(Y), jnp.asarray(rules)

    one = pgbart.init_state(Xj, Yj, cfg)
    jstate = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (CHAINS,) + a.shape), one)
    tstate = convert.state_from_numpy([state_dict(one)] * CHAINS, "cpu")

    def fused(key, state, row):
        return draw_pallas.pgbart_step_fused(
            key, state, Xj, Yj, rj, cfg, pg, row, tuning,
            rng_mode="reference", lik=lik, lik_const=lik_const)

    if lik_row is None:
        jstep = jax.jit(jax.vmap(lambda k, s: fused(k, s, None)))
        jargs = ()
    else:
        jstep = jax.jit(jax.vmap(fused))
        jargs = (jnp.asarray(lik_row),)
    trow = None if lik_row is None else torch.from_numpy(lik_row.copy())
    Xt, Yt = torch.from_numpy(X.copy()), torch.from_numpy(Y.copy())
    rt = torch.from_numpy(rules.copy())
    for step in range(2):
        keys = jnp.stack([jax.random.PRNGKey(7 + 10 * step + c)
                          for c in range(CHAINS)])
        jstate, want_vi = jstep(keys, jstate, *jargs)
        rands = convert.rands_from_numpy(
            [[np.asarray(a) for a in draw_pallas._rands_reference(
                key, B, PARTICLES, DEPTH, N, Gtot, R, S, R)]
             for key in keys], "cpu")
        tstate, got_vi = tdraw.pgbart_step_fused(
            tstate, rands, Xt, Yt, rt, tcfg, tpg, trow, tuning, lik=lik,
            lik_const=lik_const)
        compare_states(jstate, want_vi, tstate, got_vi,
                       f"lik={lik} tuning={tuning} step={step}")
    assert (convert.state_to_numpy(tstate)["split_var"] >= 0).any()
    return tstate


def precision_rows():
    w = np.array([4.0, 2.5], np.float32)      # per-chain noise precision
    return np.broadcast_to(w[:, None, None], (CHAINS, N, 1)).copy()


@pytest.mark.parametrize("case", ["draw", "tuning", "nan", "mixed"])
def test_fused_gauss_matches_jax_whole_step_kernel(case):
    X, Y, rules = make_data(with_nan=case == "nan", mixed=case == "mixed")
    tstate = run_two_steps(X, Y, rules, precision_rows(), lik="gauss",
                           tuning=case != "draw")
    sv = convert.state_to_numpy(tstate)["split_var"]
    if case == "mixed":
        assert (sv >= 1).any(), "no categorical column was split on"


def _port_setup(lik="gauss", seed=3):
    X, Y, rules = make_data(seed=seed,
                            kind="bernoulli" if lik == "bernoulli" else "gauss")
    tcfg = TBartConfig(m=M, max_depth=DEPTH)
    tpg = TPgbartConfig(num_particles=PARTICLES, batch=(0.5, 0.5))
    state = tpgbart.init_state(X, Y, tcfg, chains=CHAINS, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    rands = tpgbart.draw_rands(
        gen, B=tpg.batch_size(M, True), C=CHAINS, P=PARTICLES, D=DEPTH, n=N,
        k=1, S=tcfg.n_nodes, num_refinements=tpg.num_refinements,
        device="cpu")
    row = None if lik == "bernoulli" else torch.from_numpy(precision_rows())
    args = (torch.from_numpy(X), torch.from_numpy(Y), torch.from_numpy(rules),
            tcfg, tpg)
    return state, rands, args, row


@pytest.mark.parametrize("lik", ["gauss", "bernoulli"])
def test_route_fused_equals_route_rounds(lik):
    state, rands, args, row = _port_setup(lik)
    outs = {}
    for route in ("fused", "rounds", None):
        s, vi = tpgbart.pgbart_step(state.clone(), rands, *args, True, row,
                                    lik=lik, route=route)
        outs[route] = (convert.state_to_numpy(s), vi)
    for route in ("rounds", None):
        for name, a in outs["fused"][0].items():
            np.testing.assert_array_equal(a, outs[route][0][name],
                                          err_msg=f"{name} route={route}")
        assert torch.equal(outs["fused"][1], outs[route][1])
    assert (outs["fused"][0]["split_var"] >= 0).any()
    with pytest.raises(ValueError, match="route"):
        tpgbart.pgbart_step(state, rands, *args, True, row, route="mega")


def test_route_none_follows_the_gate(monkeypatch):
    state, rands, args, row = _port_setup()
    seen = []
    real = tdraw.pgbart_step_fused

    def spy(*a, **kw):
        seen.append(kw.get("lik"))
        return real(*a, **kw)

    monkeypatch.setattr(tdraw, "pgbart_step_fused", spy)
    tpgbart.pgbart_step(state.clone(), rands, *args, True, row)
    assert seen == ["gauss"]               # the gate admits it: fused
    tpgbart.pgbart_step(state.clone(), rands, *args, True, row,
                        route="rounds")
    assert seen == ["gauss"]               # forced away from it
    # the gate refuses (no row data): route=None takes the rounds, which
    # then misses the precision; route="fused" names the reason
    monkeypatch.setattr(tpgbart, "step_rounds",
                        lambda *a, **kw: seen.append("rounds") or (None, None))
    tpgbart.pgbart_step(state.clone(), rands, *args, True, None)
    assert seen == ["gauss", "rounds"]
    with pytest.raises(ValueError, match="row data"):
        tpgbart.pgbart_step(state.clone(), rands, *args, True, None,
                            route="fused")


def test_gate_reasons():
    X, _, _ = make_data()
    Xt = torch.from_numpy(X)
    cfg = TBartConfig(m=M, max_depth=DEPTH)
    pg = TPgbartConfig(num_particles=PARTICLES)
    row = torch.ones((CHAINS, N, 1))
    reason = tdraw.fused_draw_unsupported_reason
    assert reason(cfg, pg, Xt, row) is None
    assert tdraw.fused_draw_supported(cfg, pg, Xt, row, chains=CHAINS)
    assert reason(cfg, pg, Xt, None, lik="bernoulli") is None
    assert "row data" in reason(cfg, pg, Xt, None)
    assert "row data" in reason(cfg, pg, Xt, None, lik="het_exp")
    assert "not fused" in reason(cfg, pg, Xt, row, lik="poisson")
    assert "response" in reason(
        TBartConfig(m=M, max_depth=DEPTH, response="linear"), pg, Xt, row)
    assert "n_outputs" in reason(
        TBartConfig(m=M, max_depth=DEPTH, n_outputs=2), pg, Xt, row)
    assert not tdraw.fused_draw_supported(cfg, pg, Xt, None)
    # the shared-memory mirror grows with depth, particles and node slots
    small = tdraw.launch_plan(4, 20, 6, 127, 1000, 10)
    deep = tdraw.launch_plan(4, 20, 8, 511, 1000, 10)
    assert small.smem < deep.smem <= 232448
    assert small.smem == tdraw.smem_bytes(small, 6, 20, 127, 1000, 10, 5)


def test_plain_version_refuses_what_the_gate_refuses():
    state, rands, args, row = _port_setup()
    with pytest.raises(ValueError, match="row data"):
        tdraw.pgbart_step_fused(state, rands, *args, None, True)
    with pytest.raises(ValueError, match="impl"):
        tdraw.pgbart_step_fused(state, rands, *args, row, True, impl="fast")
    with pytest.raises(ValueError, match="CUDA"):
        tdraw.pgbart_step_fused(state, rands, *args, row, True, impl="kernel")
    with pytest.raises(NotImplementedError, match="poisson"):
        tpgbart.step_rounds(state, rands, *args, True, row, lik="poisson")
    # another code runs the per-round route too (its winner and refinement
    # in plain PyTorch); asked for kernels, CPU tensors are refused by the
    # growth kernel instead of reaching a plain version
    with pytest.raises(ValueError, match="CUDA"):
        tpgbart.step_rounds(state, rands, *args, True, None, impl="kernel",
                            lik="bernoulli")
