"""Categorical split rules and missing covariates through the port's
``sample()`` on the CPU: a Subset column of 48 categories, a OneHot column
and a continuous column with a tenth of its values NaN, in the model of
tests/test_categorical.py ``test_subset_split_rule_many_categories`` (there
n=400, m=10, 200/150 steps, one chain; here the same size, 120/80 steps, two
chains).  The non-ordinal grouping of the 48 categories is recovered, the
Subset column leads the variable inclusion, and the stored forests replay
the training fit out of sample, the NaN rows included.  The continuous
column carries an effect of its own, so that it is split on and its NaN
rows are routed."""

import numpy as np
import pytest
import torch

import pymc_bart_tpu_torch as tpmb
from pymc_bart_tpu_torch.sampler import pgbart as tpgbart


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n=400, seed=7):
    rng = np.random.default_rng(seed)
    cats = rng.integers(0, 48, size=n)
    group = (cats % 3 == 0).astype(float)      # {0, 3, ..., 45} vs the rest
    onehot = rng.integers(0, 3, size=n).astype(float)
    x = rng.uniform(size=n)
    Y = (5.0 * group + 1.5 * (onehot == 2) + 2.0 * x
         + rng.normal(0, 0.3, n))
    x[rng.permutation(n)[: n // 10]] = np.nan
    X = np.stack([cats.astype(float), onehot, x], axis=1)
    return X, Y, cats, group


@pytest.fixture(scope="module")
def fit():
    X, Y, cats, group = _data()
    routes = []
    real = tpgbart.pgbart_step

    def spy(*a, **kw):
        routes.append(kw.get("route"))
        return real(*a, **kw)

    tpgbart.pgbart_step = spy
    try:
        with tpmb.Model() as model:
            mu = tpmb.BART("mu", X, Y, m=10, split_rules=[
                "SubsetSplit", "OneHotSplit", "ContinuousSplit"])
            sigma = tpmb.HalfNormal("sigma", 1.0)
            tpmb.Normal("y", mu, sigma, observed=Y)
            idata = tpmb.sample(tune=120, draws=80, chains=2, random_seed=0,
                                device="cpu", convergence_checks=False)
    finally:
        tpgbart.pgbart_step = real
    return idata, model, mu, X, cats, group, set(routes)


def test_subset_grouping_is_recovered(fit):
    idata, _, _, _, cats, group, routes = fit
    # the whole-step function's route takes every rule and NaN X
    assert routes == {"fused"}
    post = idata.posterior["mu"].values
    assert post.shape == (2, 80, 400) and np.isfinite(post).all()
    fhat = post.mean(axis=(0, 1))
    gap = fhat[group == 1].mean() - fhat[group == 0].mean()
    assert gap > 3.0, gap
    hi = cats > 31          # categories above a 32-bit mask's reach
    hi_gap = (fhat[hi & (group == 1)].mean()
              - fhat[hi & (group == 0)].mean())
    assert hi_gap > 3.0, hi_gap


def test_subset_column_leads_the_variable_inclusion(fit):
    idata, _, _, X, _, _, _ = fit
    vi_norm, labels = tpmb.get_variable_inclusion(idata, X)
    assert labels[0] == "0", (vi_norm, labels)
    vi = idata.sample_stats["variable_inclusion"].values.sum(axis=(0, 1))[0]
    # every column splits somewhere, the one holding NaNs too (the split
    # prior adapts during tuning, rich get richer: from some seeds a column
    # of weak effect is never proposed again)
    assert (vi > 0).all(), vi


def test_stored_forests_replay_the_training_fit(fit):
    idata, model, mu, X, _, _, _ = fit
    fhat = idata.posterior["mu"].values.mean(axis=(0, 1))
    trees = model.bart_rvs[0].all_trees
    # every draw through the stored forests on the raw covariates (NaNs
    # included) against the draws themselves
    preds = tpmb.utils.predict_draw_indices(
        trees, X, np.arange(trees.split_var.shape[0]
                            * trees.split_var.shape[1]), device="cpu")
    post = idata.posterior["mu"].values.reshape(-1, X.shape[0])
    assert np.sqrt(np.mean((preds[..., 0] - post) ** 2)) < 1e-4
    sampled = tpmb.utils.sample_posterior(
        trees, X, size=20, rng=np.random.default_rng(0), device="cpu")
    assert np.sqrt(np.mean((sampled.mean(axis=0)[:, 0] - fhat) ** 2)) < 1.0
