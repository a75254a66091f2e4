"""The large-n route as a whole, on the CPU: ``sample(pgbart_route="bign")`` of
the port against the JAX package's ``sample()`` with its large-n kernel
engaged (``PYMC_BART_TPU_BIGN=1``, Pallas in interpret mode), on the regression
model of tests/test_bign.py (n = 400, p = 4, m = 10, 2 chains, 5 particles,
tune 40 / draws 40, ``store_trees=False``).  The classifier of that file is in
tests/test_torch_bign_e2e_classifier.py: one JAX model per file, since tracing
the JAX kernel takes about a minute and one file is one worker.

The two packages draw from different random streams, so this is a STATISTICAL
comparison of the posterior mean of the BART variable: the port's RMSE
against the true f (in units of y) lies within 0.35 of the JAX run's, and
each run passes the threshold the JAX test uses (RMSE below 0.8 std(f)).
Two runs this short (40 draws) differ from each other by more than either
differs from the truth, so the runs are held to the truth and not to each
other row by row.
"""

import numpy as np
import pytest

import pymc_bart_tpu as jpmb
import pymc_bart_tpu_torch as tpmb
from pymc_bart_tpu_torch.ops import bign as tbign
from pymc_bart_tpu_torch.ops import draw as tdraw

KW = dict(tune=40, draws=40, chains=2, random_seed=0, num_particles=5,
          store_trees=False)


def regression(pmb, X, Y, **kw):
    with pmb.Model():
        mu = pmb.BART("mu", X, Y, m=10)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)
        idata = pmb.sample(**KW, **kw)
    return np.asarray(idata.posterior["mu"].values).mean(axis=(0, 1))


@pytest.fixture
def port_calls(monkeypatch):
    """Counts the port's calls of its large-n and whole-step functions."""
    calls = {"bign": 0, "fused": 0}
    real_bign, real_fused = tbign.pgbart_step_bign, tdraw.pgbart_step_fused

    def bign_spy(*a, **kw):
        calls["bign"] += 1
        return real_bign(*a, **kw)

    def fused_spy(*a, **kw):
        calls["fused"] += 1
        return real_fused(*a, **kw)

    monkeypatch.setattr(tbign, "pgbart_step_bign", bign_spy)
    monkeypatch.setattr(tdraw, "pgbart_step_fused", fused_spy)
    monkeypatch.setenv("PYMC_BART_TPU_BIGN", "1")   # the JAX side's switch
    return calls


def test_regression_on_the_large_n_route(port_calls):
    rng = np.random.default_rng(5)
    n = 400
    X = rng.uniform(size=(n, 4)).astype(np.float32)
    f = 8 * X[:, 0]
    Y = (f + rng.normal(0, 0.5, n)).astype(np.float32)
    want = regression(jpmb, X, Y, progressbar=False)
    got = regression(tpmb, X, Y, device="cpu", pgbart_route="bign")
    assert port_calls == {"bign": 80, "fused": 0}
    bound = 0.8 * float(np.std(f))
    rmse_want = float(np.sqrt(np.mean((want - f) ** 2)))
    rmse_got = float(np.sqrt(np.mean((got - f) ** 2)))
    assert rmse_want < bound, rmse_want
    assert rmse_got < bound, rmse_got
    assert abs(rmse_got - rmse_want) < 0.35, (rmse_got, rmse_want)


def test_route_is_refused_with_its_reason():
    """A forced large-n route names what the gate refuses: five refinements
    with a non-Gaussian likelihood."""
    rng = np.random.default_rng(7)
    X = rng.uniform(size=(60, 3)).astype(np.float32)
    Y = rng.binomial(1, 0.5, 60).astype(np.float32)
    with tpmb.Model():
        lo = tpmb.BART("lo", X, Y, m=5)
        tpmb.Bernoulli("y", p=tpmb.math.sigmoid(lo), observed=Y)
        with pytest.raises(ValueError, match="num_refinements"):
            tpmb.sample(tune=2, draws=2, chains=2, device="cpu",
                        pgbart_route="bign")
        # with the gate's requirement met the route runs, rejuvenation too
        idata = tpmb.sample(tune=2, draws=2, chains=2, device="cpu",
                            pgbart_route="bign", num_refinements=0,
                            ancestor_sampling=True, convergence_checks=False)
        assert np.isfinite(idata.posterior["lo"].values).all()
