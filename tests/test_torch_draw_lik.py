"""The non-Gaussian likelihood codes of the port's whole-step function
against the JAX package's whole-step Pallas kernel (interpret mode), as
tests/test_torch_draw.py does for the Gaussian code: bernoulli with tuning
on and off, het_abs, het_exp and cat_logit, inputs as
tests/test_draw_chains.py.  Same random blocks, two chains, two consecutive
steps, same tolerances.
"""

import numpy as np
import pytest
import torch

from pymc_bart_tpu_torch.sampler import pgbart as tpgbart

from test_torch_draw import CHAINS, N, P_COLS, make_data, run_two_steps


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(lik):
    """(X, Y, rules, lik_row (CHAINS, N, 1) or None, lik_const)."""
    if lik == "bernoulli":
        X, Y, rules = make_data(seed=2, kind="bernoulli")
        return X, Y, rules, None, 0.0
    if lik == "cat_logit":
        rng = np.random.default_rng(6)
        X = rng.uniform(size=(N, P_COLS)).astype(np.float32)
        labels = rng.integers(0, 3, N)
        # growth target of class 0 (+-2) and the logsumexp of the two other
        # classes' current outputs, which differ between the chains
        Y = (4.0 * (labels == 0) - 2.0).astype(np.float32)[:, None]
        others = rng.normal(0.0, 0.5, size=(CHAINS, N, 2))
        row = np.log(np.exp(others).sum(axis=2, keepdims=True))
        return (X, Y, np.zeros(P_COLS, np.int32), row.astype(np.float32), 0.0)
    X, Y, rules = make_data(seed=2)
    # scale-forest update: squared residuals about each chain's mean value
    mu0 = np.array([0.0, 0.1], np.float32)[:, None, None]
    row = ((Y[None] - mu0) ** 2).astype(np.float32)
    return X, Y, rules, row, 0.05 if lik == "het_abs" else 0.0


@pytest.mark.parametrize("lik, tuning", [
    ("bernoulli", False), ("bernoulli", True), ("het_abs", False),
    ("het_exp", False), ("cat_logit", False)])
def test_fused_likelihood_codes_match_jax_whole_step_kernel(lik, tuning):
    X, Y, rules, row, lik_const = _case(lik)
    run_two_steps(X, Y, rules, row, lik=lik, tuning=tuning,
                  lik_const=lik_const)


@pytest.mark.parametrize("lik", ["bernoulli", "het_abs", "het_exp",
                                 "cat_logit"])
def test_closed_forms_against_their_definitions(lik):
    """``closed_form_ll`` against a float64 evaluation of each code's
    log-density, up to the terms that do not depend on F."""
    rng = np.random.default_rng(1)
    F = rng.normal(0.0, 2.0, size=(3, 7))
    y = (rng.random(7) < 0.5).astype(np.float64)
    row = rng.uniform(0.1, 2.0, size=(3, 7))
    got = tpgbart.closed_form_ll(
        lik, 0.05, torch.tensor(F, dtype=torch.float32),
        torch.tensor(y, dtype=torch.float32),
        torch.tensor(row, dtype=torch.float32)).numpy()
    if lik == "bernoulli":
        p = 1 / (1 + np.exp(-F))
        want = y * np.log(p) + (1 - y) * np.log1p(-p)
    elif lik == "het_abs":
        sg = np.abs(F) + 0.05
        want = -0.5 * row / sg**2 - np.log(sg)
    elif lik == "het_exp":
        want = -0.5 * row * np.exp(-2 * F) - F
    else:
        want = y * F - np.log(np.exp(F) + np.exp(row))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_closed_form_refuses_an_unknown_code():
    with pytest.raises(ValueError, match="poisson"):
        tpgbart.closed_form_ll("poisson", 0.0, torch.zeros(2), torch.zeros(2),
                               None)
