"""Posterior prediction and predictive sampling of the port
(``utils/posterior.py``, ``ops/predict.py``'s excluded path,
``models/predictive.py``) on the CPU.

The stored forests come from a tiny port ``sample()``; the JAX package's
``PosteriorForests`` is built from the same NumPy arrays, and both draw
their indices from the same NumPy seed: indices and predictions must agree
(predictions to rtol 1e-5)."""

import dataclasses

import numpy as np
import pytest
import torch

import pymc_bart_tpu_torch as tpmb
from pymc_bart_tpu.config import BartConfig as JBartConfig
from pymc_bart_tpu.utils import posterior as jpost
from pymc_bart_tpu_torch.utils import posterior as tpost

N, P_COLS = 50, 3


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, P_COLS)).astype(np.float32)
    f = 2 * np.sin(2 * X[:, 0]) + X[:, 1]
    return X, (f + 0.3 * rng.normal(size=n)).astype(np.float32), f


@pytest.fixture(scope="module")
def fitted():
    """A single-output forest store and a separate-trees list of two."""
    X, Y, _ = _data()
    with tpmb.Model():
        mu = tpmb.BART("mu", X, Y, m=4, max_depth=4)
        tpmb.Normal("y", mu, 0.3, observed=Y)
        tpmb.sample(tune=8, draws=6, chains=2, random_seed=3, device="cpu",
                    convergence_checks=False)
    with tpmb.Model():
        w = tpmb.BART("w", X, Y, m=4, max_depth=4, shape=(2, N),
                      separate_trees=True)
        tpmb.Normal("y", w[0], tpmb.math.abs(w[1]) + 0.1, observed=Y)
        tpmb.sample(tune=8, draws=6, chains=2, random_seed=4, device="cpu",
                    convergence_checks=False)
    return mu.all_trees, w.all_trees


def _to_jax(pf):
    fields = {f.name: getattr(pf, f.name) for f in dataclasses.fields(pf)}
    fields["config"] = JBartConfig(**dataclasses.asdict(pf.config))
    return jpost.PosteriorForests(**fields)


def _X_new(seed=5, n=17):
    X = np.random.default_rng(seed).uniform(-1, 1, (n, P_COLS))
    X = X.astype(np.float32)
    X[3, 1] = np.nan                     # a NaN row goes right
    return X


@pytest.mark.parametrize("excluded", [None, [0], [1, 2]],
                         ids=["none", "x0", "x1_x2"])
def test_predict_draw_indices_matches_jax(fitted, excluded):
    single, _ = fitted
    idx = np.random.default_rng(1).integers(0, single.n_total, 9)
    X = _X_new()
    got = tpost.predict_draw_indices(single, X, idx, excluded, device="cpu")
    want = jpost.predict_draw_indices(_to_jax(single), X, idx, excluded)
    assert got.shape == (9, X.shape[0], 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if excluded:
        plain = tpost.predict_draw_indices(single, X, idx, device="cpu")
        assert not np.allclose(got, plain)


@pytest.mark.parametrize("layout", ["single", "list"])
@pytest.mark.parametrize("excluded", [None, [0]], ids=["none", "x0"])
def test_sample_posterior_matches_jax(fitted, layout, excluded):
    single, per_output = fitted
    trees = single if layout == "single" else per_output
    jtrees = (_to_jax(trees) if layout == "single"
              else [_to_jax(p) for p in trees])
    X = _X_new()
    got = tpost.sample_posterior(trees, X, rng=np.random.default_rng(11),
                                 size=(2, 3), excluded=excluded, device="cpu")
    want = jpost.sample_posterior(jtrees, X, rng=np.random.default_rng(11),
                                  size=(2, 3), excluded=excluded)
    k = 1 if layout == "single" else 2
    assert got.shape == want.shape == (2, 3, X.shape[0], k)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_excluded_prediction_is_the_count_weighted_average():
    """Excluding the only covariate of a stump averages its two leaves by
    their training counts, for every row."""
    pf = _stump()
    got = tpost.predict_draw_indices(pf, _X_new(n=6), [0], excluded=[0],
                                     device="cpu")
    lf, ct = pf.leaf[0, 0, 0, :, 0], pf.count[0, 0, 0]
    want = (lf[1] * ct[1] + lf[2] * ct[2]) / (ct[1] + ct[2])
    np.testing.assert_allclose(got[0, :, 0], want, rtol=1e-6)


def _stump():
    """One draw of one tree: a root split on column 0 with two leaves."""
    S = 7
    sv = np.full((1, 1, 1, S), -1, np.int32)
    sv[..., 0] = 0
    sl = np.zeros((1, 1, 1, S), np.float32)
    lf = np.zeros((1, 1, 1, S, 1), np.float32)
    lf[..., 1, 0], lf[..., 2, 0] = -1.0, 3.0
    ct = np.zeros((1, 1, 1, S), np.float32)
    ct[..., 0], ct[..., 1], ct[..., 2] = 10, 3, 7
    cfg = tpmb.BartConfig(m=1, max_depth=2)
    return tpost.PosteriorForests(
        split_var=sv, split_val=sl, split_set=np.zeros_like(sv, np.uint32),
        leaf=lf, count=ct, slope=np.zeros_like(lf), config=cfg,
        rules=np.zeros(P_COLS, np.int32),
        X_train=np.zeros((10, P_COLS), np.float32))


def test_out_of_sample_predictions_after_set_data():
    X, Y, f = _data(1)
    X_new, _, f_new = _data(2, n=23)
    with tpmb.Model():
        Xd = tpmb.Data("X", X)
        w = tpmb.BART("w", Xd, Y, m=5, shape=(2, N), separate_trees=True)
        tpmb.Normal("y", w[0], tpmb.math.abs(w[1]) + 0.05, observed=Y)
        idata = tpmb.sample(tune=25, draws=15, chains=2, random_seed=2,
                            device="cpu", ancestor_sampling=True,
                            convergence_checks=False)
        pp = tpmb.sample_posterior_predictive(idata, random_seed=1,
                                              device="cpu",
                                              extend_inferencedata=False)
        assert pp.posterior_predictive["y"].shape == (2, 15, N)
        tpmb.set_data({"X": X_new})
        out = tpmb.sample_posterior_predictive(
            idata, predictions=True, sample_vars=["y", "w"], random_seed=1,
            device="cpu")
    assert out is idata
    y_new = idata.predictions["y"]
    assert y_new.shape == (2, 15, 23)
    assert y_new.dims == ("chain", "draw", "y_dim_0")
    w_new = idata.predictions["w"].values
    assert w_new.shape == (2, 15, 2, 23)
    # the recomputed mean output follows the new rows' signal
    assert np.corrcoef(w_new[:, :, 0].mean(axis=(0, 1)), f_new)[0, 1] > 0.8
    # y is drawn around w[0] with the scale |w[1]| + 0.05
    z = (y_new.values - w_new[:, :, 0]) / (np.abs(w_new[:, :, 1]) + 0.05)
    assert abs(z.mean()) < 0.2 and abs(z.std() - 1.0) < 0.15


def test_prior_predictive_moments():
    X, Y, _ = _data(3)
    with tpmb.Model():
        mu = tpmb.BART("mu", X, Y, m=5)
        sigma = tpmb.HalfNormal("sigma", 2.0)
        tpmb.Deterministic("two_sigma", 2.0 * sigma)
        tpmb.Normal("y", mu, sigma, observed=Y)
        prior = tpmb.sample_prior_predictive(4000, random_seed=5,
                                             device="cpu")
    s = prior.prior["sigma"].values
    assert s.shape == (1, 4000)
    # HalfNormal(2): mean 2 sqrt(2 / pi), second moment 4
    assert abs(s.mean() - 2.0 * np.sqrt(2.0 / np.pi)) < 0.06
    np.testing.assert_allclose(prior.prior["two_sigma"].values, 2.0 * s,
                               rtol=1e-6)
    assert (prior.prior["mu"].values == np.float32(np.mean(Y))).all()
    y = prior.prior_predictive["y"].values
    assert y.shape == (1, 4000, N)
    assert abs(y.mean() - np.mean(Y)) < 0.05
    assert abs(y.var() - 4.0) < 0.25
