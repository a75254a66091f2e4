"""The port's chain-batched NUTS and HMC on known targets (the moment checks
of tests/test_nuts.py), several chains at once, plus a check that chains in
one batch do not influence each other's trajectories."""

import numpy as np
import pytest
import torch

from pymc_bart_tpu_torch.sampler import hmc, nuts

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
