"""The large-n route as a whole, on the CPU, for the classifier: the second
half of tests/test_torch_bign_e2e.py (one JAX model per file: tracing the JAX
package's large-n kernel in interpret mode takes about a minute, and one file
is one worker).  ``sample(pgbart_route="bign")`` of the port against the JAX
package's ``sample()`` with its large-n kernel engaged
(``PYMC_BART_TPU_BIGN=1``), on the Bernoulli model of tests/test_bign.py
(n = 400, p = 4, m = 10, 2 chains, 5 particles, no refinements, tune 40 /
draws 40, ``store_trees=False``).

The two packages draw from different random streams, so this is a STATISTICAL
comparison: the train accuracy of the port's posterior-mean logit lies within
0.1 of the JAX run's, and both pass the JAX test's threshold of 0.7.
"""

import numpy as np
import pytest

import pymc_bart_tpu as jpmb
import pymc_bart_tpu_torch as tpmb
from pymc_bart_tpu_torch.ops import bign as tbign
from pymc_bart_tpu_torch.ops import draw as tdraw

KW = dict(tune=40, draws=40, chains=2, random_seed=0, num_particles=5,
          store_trees=False)


def classifier(pmb, X, Y, **kw):
    with pmb.Model():
        lo = pmb.BART("lo", X, Y, m=10)
        pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=Y)
        idata = pmb.sample(**KW, num_refinements=0, **kw)
    return np.asarray(idata.posterior["lo"].values).mean(axis=(0, 1))


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


def test_classifier_on_the_large_n_route(port_calls):
    rng = np.random.default_rng(6)
    n = 400
    X = rng.uniform(size=(n, 4)).astype(np.float32)
    p_true = 1 / (1 + np.exp(-(6 * X[:, 0] - 3)))
    Y = rng.binomial(1, p_true).astype(np.float32)
    want = classifier(jpmb, X, Y)
    got = classifier(tpmb, X, Y, device="cpu", pgbart_route="bign")
    assert port_calls == {"bign": 80, "fused": 0}
    acc_want = float(((want > 0) == (Y > 0.5)).mean())
    acc_got = float(((got > 0) == (Y > 0.5)).mean())
    assert acc_want > 0.7, acc_want
    assert acc_got > 0.7, acc_got
    assert abs(acc_got - acc_want) < 0.1
