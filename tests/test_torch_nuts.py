"""The port's chain-batched NUTS and HMC on known targets (the moment checks
of tests/test_nuts.py), several chains at once, plus a check that chains in
one batch do not influence each other's trajectories.

NUTS's graph path (``nuts.Graphs``): on the CPU its block of static buffers
with the capture left out against the eager path, bit for bit; which
transitions take it; the model's constants made once, not copied to the
device at every log-density evaluation.  The tests marked ``card`` replay
the captured graphs on a CUDA device against the eager path there (bit for
bit, directly and through ``sample()``); they skip elsewhere.  This file
imports no JAX: on the card run it with ``python -m pytest --noconftest
tests/test_torch_nuts.py -m card -s``.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import pymc_bart_tpu_torch as pmb
from pymc_bart_tpu_torch import tracing
from pymc_bart_tpu_torch.models import Expr, distributions, evaluate
from pymc_bart_tpu_torch.sampler import compound, hmc, nuts

CHAINS = 4


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(logp, d, step_fn=nuts.nuts_step, n_tune=300, n_draw=300, seed=0):
    gen = torch.Generator().manual_seed(seed)
    state = nuts.init_state(torch.zeros(CHAINS, d))
    for _ in range(n_tune):
        state, _ = step_fn(gen, state, logp, tuning=True)
    state = nuts.finalize_adaptation(state)
    draws = []
    for _ in range(n_draw):
        state, acc = step_fn(gen, state, logp, tuning=False)
        draws.append(state.theta.numpy().copy())
    assert acc.shape == (CHAINS,)
    return np.stack(draws, axis=1)          # (chains, draws, d)


def test_nuts_standard_normal():
    draws = _run(lambda t: -0.5 * (t**2).sum(dim=1), d=3)
    flat = draws.reshape(-1, 3)
    assert np.abs(flat.mean(axis=0)).max() < 0.15
    assert np.abs(flat.std(axis=0) - 1.0).max() < 0.15
    # every chain on its own has the right scale too
    assert np.abs(draws.std(axis=1) - 1.0).max() < 0.3


def test_nuts_correlated_gaussian():
    cov = np.array([[1.0, 0.9], [0.9, 1.0]])
    prec = torch.tensor(np.linalg.inv(cov), dtype=torch.float32)

    def logp(t):
        return -0.5 * torch.einsum("ci,ij,cj->c", t, prec, t)

    emp_cov = np.cov(_run(logp, d=2, seed=1).reshape(-1, 2).T)
    assert abs(emp_cov[0, 1] - 0.9) < 0.2, emp_cov
    assert abs(emp_cov[0, 0] - 1.0) < 0.3, emp_cov


def test_nuts_scale_mismatch():
    # scales differing by 100x: mass adaptation must handle it
    scales = torch.tensor([0.05, 5.0])
    draws = _run(lambda t: -0.5 * ((t / scales) ** 2).sum(dim=1), d=2,
                 seed=2).reshape(-1, 2)
    assert abs(draws[:, 0].std() - 0.05) < 0.02
    assert abs(draws[:, 1].std() - 5.0) < 1.5


def test_hmc_standard_normal():
    draws = _run(lambda t: -0.5 * (t**2).sum(dim=1), d=2,
                 step_fn=hmc.hmc_step, seed=3).reshape(-1, 2)
    assert np.abs(draws.mean(axis=0)).max() < 0.2
    assert np.abs(draws.std(axis=0) - 1.0).max() < 0.2


def test_nuts_full_stats_and_per_chain_targets():
    """Chains with different targets in one batch: each recovers its own
    scale (the masks keep stopped chains untouched), and the statistics are
    per chain."""
    scales = torch.tensor([0.1, 1.0, 3.0, 10.0])[:, None]
    logp = lambda t: -0.5 * ((t / scales) ** 2).sum(dim=1)  # noqa: E731
    gen = torch.Generator().manual_seed(4)
    state = nuts.init_state(torch.zeros(CHAINS, 1))
    for _ in range(300):
        state, _ = nuts.nuts_step(gen, state, logp, tuning=True)
    state = nuts.finalize_adaptation(state)
    draws, depths = [], []
    for _ in range(400):
        state, stats = nuts.nuts_step(gen, state, logp, tuning=False,
                                      full_stats=True)
        draws.append(state.theta[:, 0].numpy().copy())
        depths.append(stats["tree_depth"].numpy().copy())
    sd = np.stack(draws).std(axis=0)
    np.testing.assert_allclose(sd, scales[:, 0].numpy(), rtol=0.35)
    assert set(stats) == {"accept", "diverging", "tree_depth", "n_steps",
                          "step_size", "energy"}
    assert all(v.shape == (CHAINS,) for v in stats.values())
    depths = np.stack(depths)
    assert depths.min() >= 1 and depths.max() <= 8
    assert not stats["diverging"].any()
    n_steps = stats["n_steps"].numpy()
    assert ((n_steps & (n_steps + 1)) == 0).all()   # 2^depth - 1 leapfrogs


def test_same_seed_same_trajectory():
    logp = lambda t: -0.5 * (t**2).sum(dim=1)  # noqa: E731
    a = _run(logp, d=2, n_tune=20, n_draw=20, seed=9)
    b = _run(logp, d=2, n_tune=20, n_draw=20, seed=9)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(AssertionError):
        np.testing.assert_array_equal(
            a, _run(logp, d=2, n_tune=20, n_draw=20, seed=10))


# ---------------------------------------------------------------------------
# the graph path
# ---------------------------------------------------------------------------

def _transitions(logp, d, device="cpu", n=40, seed=0, graphs=None):
    """``n`` transitions (the first half tuning) from one generator: every
    state field and statistic of each, and the generator's final state."""
    gen = torch.Generator(device=device).manual_seed(seed)
    state = nuts.init_state(torch.zeros(CHAINS, d, device=device))
    out = []
    for i in range(n):
        if i == n // 2:
            state = nuts.finalize_adaptation(state)
        state, stats = nuts.nuts_step(gen, state, logp, tuning=i < n // 2,
                                      full_stats=True, graphs=graphs)
        out.append({**{f"state.{k}": v.clone()
                       for k, v in vars(state).items()}, **stats})
    return out, gen.get_state()


def _assert_identical(a, b):
    (steps_a, gen_a), (steps_b, gen_b) = a, b
    assert len(steps_a) == len(steps_b)
    for i, (x, y) in enumerate(zip(steps_a, steps_b)):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, (i, k)
            assert torch.equal(x[k], y[k]), (i, k, x[k], y[k])
    assert torch.equal(gen_a, gen_b)


def _targets(device):
    """Friedman's sigma (d=1: a HalfNormal(1) prior in log space and the
    Gaussian likelihood of fixed residuals, batched with ``vmap``) and a
    d=3 Normal target with vector parameters."""
    g = torch.Generator().manual_seed(7)
    resid = (0.8 * torch.randn((CHAINS, 200), generator=g)).to(device)
    mu = torch.tensor([0.5, -1.0, 2.0], device=device)
    sd = torch.tensor([0.3, 1.0, 4.0], device=device)

    def sigma_logp(u, res):           # one chain: u (1,), res (n,)
        s = torch.exp(u[0])
        return (u[0] - 0.5 * s * s - res.numel() * torch.log(s)
                - 0.5 * (res * res).sum() / (s * s))

    def host_copy(t):           # copies a Python list to the device
        c = torch.tensor([0.5, -1.0], device=t.device)
        return -0.5 * ((t - c) ** 2).sum(dim=1)

    batched = torch.func.vmap(sigma_logp)
    return {1: lambda t: batched(t, resid),
            3: lambda t: -0.5 * (((t - mu) / sd) ** 2).sum(dim=1),
            2: host_copy}


@pytest.mark.parametrize("d", [1, 3])
def test_graph_block_without_capture_equals_the_eager_path(d, monkeypatch):
    """The graph path's transition on its static block, every doubling run
    eagerly on the CPU (capture needs a card), against the eager path: the
    same draws in the same order, the same numbers bit for bit, at every
    depth up to the limit."""
    logp = _targets("cpu")[d]
    eager = _transitions(logp, d)
    monkeypatch.setattr(nuts, "_graph_path", lambda *a: True)
    graphs = nuts.Graphs()
    monkeypatch.setattr(graphs, "_capture", lambda *a: None)
    timings = {}
    with tracing.recording(timings):
        block = _transitions(logp, d, graphs=graphs)
    _assert_identical(eager, block)
    c = timings["counters"]
    depths = sum(int(s["tree_depth"].max()) for s in block[0])
    assert c["nuts_step/nuts_eager_doublings"] == depths
    assert "nuts_step/nuts_graph_replays" not in c
    # the first doubling needs no check: every chain runs it
    assert c["nuts_step/host_syncs"] == sum(
        int(s["tree_depth"].max()) - 1 + (int(s["tree_depth"].max()) < 8)
        for s in block[0])


def test_cpu_and_sharded_logp_take_the_eager_path():
    """Graphs need a CUDA state and a log-density without a collective;
    on the CPU, and for a ``ShardedLogp``, every doubling runs eagerly."""
    plain = _targets("cpu")[3]
    sharded = hmc.ShardedLogp(lambda t: torch.zeros(t.shape[0]), plain,
                              rows=None)
    cuda = torch.device("cuda")     # a device name only: nothing runs there
    graphs = nuts.Graphs()
    assert nuts._graph_path(cuda, plain, graphs)
    assert not nuts._graph_path(cuda, sharded, graphs)
    assert not nuts._graph_path(cuda, plain, None)
    assert not nuts._graph_path(torch.device("cpu"), plain, graphs)
    for logp in (plain, sharded):
        timings = {}
        with tracing.recording(timings):
            steps, _ = _transitions(logp, 3, n=6, graphs=graphs)
        c = timings["counters"]
        assert c.get("nuts_step/nuts_graph_replays", 0) == 0
        assert "nuts_step/nuts_graph_captures" not in c
        assert c["nuts_step/nuts_eager_doublings"] == sum(
            int(s["tree_depth"].max()) for s in steps)


def test_model_constants_are_made_once_with_the_old_values(monkeypatch):
    """A log-density evaluation copies no constant to the device:
    ``distributions._t`` counts no ``host_syncs`` (the Python scale of
    ``HalfNormal(1.0)`` and a fixed ``sigma=0.7`` are tensors made once) and
    ``expr.evaluate`` copies a NumPy constant once; the values and the
    log-density equal the old per-evaluation copies bit for bit."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(30, 2)).astype(np.float32)
    Y = rng.normal(size=30).astype(np.float32)
    with pmb.Model() as model:
        mu = pmb.BART("mu", X, Y, m=3)
        sigma = pmb.HalfNormal("sigma", 1.0)
        b = pmb.Normal("b", mu=np.zeros(2, np.float32),
                       sigma=[1.0, 2.5], shape=(2,))
        pmb.Normal("y", mu + b[0] * np.full(30, 0.1, np.float32), sigma,
                   observed=Y)
        pmb.Normal("y2", b[1] * pmb.math.constant([0.3]), 0.7,
                   observed=Y[:1])
    compiled = compound.CompiledModel(model, "cpu")
    theta = torch.tensor([0.3, -0.2, 0.4])
    bart = {"mu": torch.from_numpy(Y[:, None] * 0.5)}
    for rv, ps in zip(compiled.free_params + list(model.observed_rvs),
                      compiled.prior_params + compiled.observed_params):
        for p, q in zip(rv.params, ps):
            if not isinstance(p, Expr):
                old = torch.as_tensor(np.asarray(p, np.float32))
                assert q.dtype == old.dtype and torch.equal(q, old), p

    def old_logdensity():
        """The log-density with every constant copied at its use."""
        env, log_jac = compiled.build_env(theta, bart)
        parts = []
        for rvs, values in ((compiled.free_params,
                             [env[rv.name] for rv in compiled.free_params]),
                            (model.observed_rvs, compiled.observed)):
            lp = torch.zeros(())
            for rv, value in zip(rvs, values):
                params = tuple(torch.as_tensor(np.asarray(p, np.float32))
                               if isinstance(p, (list, np.ndarray)) else
                               evaluate(p, env)
                               for p in rv.params)
                lp = lp + rv.dist.logp(value, *params).sum()
            parts.append(lp)
        return parts[0] + parts[1] + log_jac

    copies = []
    real = torch.as_tensor
    monkeypatch.setattr(torch, "as_tensor",
                        lambda *a, **k: copies.append(1) or real(*a, **k))
    timings = {}
    with tracing.recording(timings):
        new = [compiled.logdensity(theta, bart) for _ in range(3)]
    # the Op's NumPy array and the Const [0.3], each made once
    assert len(copies) == 2
    assert not any(k.endswith("host_syncs")
                   for k in timings.get("counters", {}))
    with tracing.recording(timings):
        old = old_logdensity()
    assert timings["counters"]["host_syncs"] >= 2    # the old copies
    for v in new:
        assert torch.equal(v, old)
    assert distributions._t(1.0).dtype == torch.float32


# on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.card
@pytest.mark.parametrize("d", [1, 3, 2])
def test_graphs_replay_the_eager_path_bit_for_bit(card, d, monkeypatch):
    """40 transitions (20 tuning) at C=4 from one generator state: the
    replayed graphs and the eager path give the same states, statistics and
    generator state, with most doublings replayed.  A log-density that
    copies from the host (d=2) cannot be captured: its first capture fails
    and the fit runs eagerly from there, to the same numbers."""
    logp = _targets("cuda")[d]
    timings = {}
    graphs = nuts.Graphs()
    with tracing.recording(timings):
        replayed = _transitions(logp, d, device="cuda", graphs=graphs)
    c = timings["counters"]
    depth_max = max(int(s["tree_depth"].max()) for s in replayed[0])
    if d == 2:
        assert graphs.failed
        assert "nuts_step/nuts_graph_captures" not in c
        assert "nuts_step/nuts_graph_replays" not in c
    else:
        assert not graphs.failed
        assert 1 <= c["nuts_step/nuts_graph_captures"] <= depth_max
        assert c["nuts_step/nuts_graph_replays"] > c[
            "nuts_step/nuts_eager_doublings"]
    monkeypatch.setattr(nuts, "_GRAPHS", False)
    _assert_identical(_transitions(logp, d, device="cuda",
                                   graphs=nuts.Graphs()), replayed)
    print(json.dumps({"graphs_vs_eager": d, "card": card,
                      "counters": c}))


def _friedman(n=1000, p=10, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    f = (10 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 20 * (X[:, 2] - 0.5) ** 2
         + 10 * X[:, 3] + 5 * X[:, 4])
    return X, (f + rng.normal(size=n)).astype(np.float32)


def _sample_friedman(timings=None, **kw):
    X, Y = _friedman()
    with pmb.Model() as model:
        mu = pmb.BART("mu", X, Y, m=50)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)
        idata = pmb.sample(**kw, timings=timings)
    trees = model.bart_rvs[0].all_trees
    return (np.asarray(idata.posterior["sigma"].values),
            {f: np.asarray(getattr(trees, f))
             for f in ("split_var", "split_val", "leaf", "count")})


@pytest.mark.card
def test_sample_on_graphs_equals_the_eager_path(card, monkeypatch):
    """``sample()`` at n=1000 (m=50, 4 chains, 10/30 steps): sigma's draws
    and the forests equal the eager path's; a capture a depth reached at
    most, every doubling replayed or eager, and no synchronising operation
    inside a replay (PyTorch's sync debug mode)."""
    kw = dict(device="cuda", chains=4, num_particles=10, tune=10, draws=30,
              random_seed=5, convergence_checks=False)
    _sample_friedman(**dict(kw, tune=2, draws=2))        # builds the kernels
    depths = []
    real_step = nuts.nuts_step

    def step(*a, **k):
        out = real_step(*a, **k)
        depths.append(int(out[1]["tree_depth"].max()))
        return out

    monkeypatch.setattr(nuts, "nuts_step", step)
    warned = {}
    real = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return real(message, category, filename, lineno, file, line)
        tracer = tracing._TRACER.get()
        path = tracer.stack[-1].path if tracer is not None else "<none>"
        site = f"{os.path.relpath(filename)}:{lineno}"
        warned.setdefault(path, {}).setdefault(site, 0)
        warned[path][site] += 1

    timings = {}
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sigma, trees = _sample_friedman(timings, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    c = timings["counters"]

    def total(name):
        return sum(v for k, v in c.items() if k.split("/")[-1] == name)

    print(json.dumps({"sample_graphs": card, "counters": c,
                      "warned": warned, "depths": depths}))
    assert len(depths) == 40
    assert 1 <= total("nuts_graph_captures") <= max(depths)
    assert total("nuts_graph_replays") + total("nuts_eager_doublings") \
        == sum(depths)
    assert total("nuts_graph_replays") > 0.8 * sum(depths)
    assert not any(p.endswith("nuts_leapfrog") for p in warned)
    for phase in ("tune", "draw"):
        path = f"{phase}/nuts_step"
        assert sum(warned.get(path, {}).values()) == c[path + "/host_syncs"]

    monkeypatch.setattr(nuts, "_GRAPHS", False)
    sigma_e, trees_e = _sample_friedman(**kw)
    np.testing.assert_array_equal(sigma, sigma_e)
    for f in trees:
        np.testing.assert_array_equal(trees[f], trees_e[f])
