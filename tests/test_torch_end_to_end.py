"""The ported path as a whole: the Friedman model and the logistic
classifier through the port's ``sample(device="cpu")`` at a small size,
against the JAX package's ``sample()`` on the same data.

The two packages draw from different random streams, so draws cannot match;
posterior summaries are held to a Monte-Carlo band instead.  At this size
(n=100, p=5, m=10, 60 tune + 60 draws, 2 chains, 8 particles) repeated runs
of either package give RMSE-vs-true-f 1.83..1.93 and mean sigma 2.33..2.45
(spread about 0.06 each); the band is 0.35 for the RMSE and 0.4 for sigma."""

import numpy as np
import pytest
import torch

import pymc_bart_tpu as jpmb
import pymc_bart_tpu_torch as tpmb

N, P_COLS, M, TUNE, DRAWS, CHAINS, PARTICLES = 100, 5, 10, 60, 60, 2, 8


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _friedman(n, p, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    f = (10 * np.sin(np.pi * X[:, 0] * X[:, 1])
         + 20 * (X[:, 2] - 0.5) ** 2 + 10 * X[:, 3] + 5 * X[:, 4])
    return X, (f + rng.normal(0, 1.0, n)).astype(np.float32), f


def _toy(n, p, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    f = 3.0 * np.sin(3.0 * X[:, 0]) + X[:, 1]
    return X, (f + 0.3 * rng.normal(size=n)).astype(np.float32), f


def _fit(pmb, seed, **kw):
    X, Y, _ = _friedman(N, P_COLS)
    with pmb.Model():
        mu = pmb.BART("mu", X, Y, m=M)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)
        idata = pmb.sample(tune=TUNE, draws=DRAWS, chains=CHAINS,
                           num_particles=PARTICLES, random_seed=seed,
                           convergence_checks=False, **kw)
    return idata, mu


@pytest.fixture(scope="module")
def port_fit():
    timings = {}
    idata, mu = _fit(tpmb, 0, device="cpu", chunk_size=25, timings=timings)
    return idata, mu, timings


def test_inference_data_shapes_and_dims(port_fit):
    idata, mu, timings = port_fit
    post = idata.posterior
    assert post["mu"].shape == (CHAINS, DRAWS, N)
    assert post["mu"].dims == ("chain", "draw", "mu_dim_0")
    assert post["sigma"].shape == (CHAINS, DRAWS)
    assert np.isfinite(post["mu"].values).all()
    assert (post["sigma"].values > 0).all()
    stats = idata["sample_stats"]
    vi = stats["variable_inclusion"]
    assert vi.shape == (CHAINS, DRAWS, 1, P_COLS)
    assert vi.dims == ("chain", "draw", "variable_inclusion_dim_0",
                       "variable_inclusion_dim_1")
    for name in ("mean_accept", "diverging", "tree_depth", "n_steps",
                 "step_size", "energy"):
        assert stats[name].shape == (CHAINS, DRAWS), name
    assert idata.observed_data["y"].shape == (N,)
    assert not np.array_equal(post["mu"].values[0], post["mu"].values[1])
    # uneven chunks (60 draws in chunks of <= 25) are all accounted for
    assert sum(timings["draw_chunk_sizes"]) == DRAWS
    assert len(timings["draw_chunk_sizes"]) == 3
    assert timings["tune_seconds"] > 0 and timings["draw_seconds_total"] > 0


def test_variable_inclusion_equals_recount_over_stored_forests(port_fit):
    idata, mu, _ = port_fit
    trees = mu.all_trees
    S = 2 ** (trees.config.max_depth + 1) - 1
    assert trees.split_var.shape == (CHAINS, DRAWS, M, S)
    assert trees.leaf.shape == (CHAINS, DRAWS, M, S, 1)
    assert trees.split_set.dtype == np.uint32
    vi = idata["sample_stats"]["variable_inclusion"].values
    recount = np.stack([(trees.split_var == j).sum(axis=(2, 3))
                        for j in range(P_COLS)], axis=-1)
    np.testing.assert_array_equal(vi[:, :, 0, :], recount)
    assert recount.sum() > 0
    # the stored forests reproduce the stored sum-of-trees draws
    import torch

    from pymc_bart_tpu_torch.ops.predict import forest_predict
    from pymc_bart_tpu_torch.ops.trees import Forest

    c, d = 1, DRAWS - 1
    forest = Forest(*(torch.from_numpy(np.ascontiguousarray(a[c, d]).view(
        np.int32) if a.dtype == np.uint32 else np.ascontiguousarray(a[c, d]))
        for a in (trees.split_var, trees.split_val, trees.split_set,
                  trees.leaf, trees.count, trees.slope)))
    pred = forest_predict(forest, torch.from_numpy(trees.X_train),
                          torch.from_numpy(trees.rules))[:, 0].numpy()
    np.testing.assert_allclose(pred, idata.posterior["mu"].values[c, d],
                               rtol=1e-4, atol=1e-4)


def test_same_seed_same_draws(port_fit):
    idata, _, _ = port_fit
    again, _ = _fit(tpmb, 0, device="cpu")      # other chunking, same seed
    np.testing.assert_array_equal(idata.posterior["mu"].values,
                                  again.posterior["mu"].values)
    np.testing.assert_array_equal(idata.posterior["sigma"].values,
                                  again.posterior["sigma"].values)
    other, _ = _fit(tpmb, 1, device="cpu")
    assert not np.array_equal(idata.posterior["sigma"].values,
                              other.posterior["sigma"].values)


def test_posterior_summaries_within_monte_carlo_band_of_jax(port_fit):
    idata, _, _ = port_fit
    _, _, f_true = _friedman(N, P_COLS)
    ref, _ = _fit(jpmb, 0)

    def summaries(idt):
        mu_hat = np.asarray(idt.posterior["mu"].values).mean(axis=(0, 1))
        return (float(np.sqrt(np.mean((mu_hat - f_true) ** 2))),
                float(np.asarray(idt.posterior["sigma"].values).mean()))

    rmse_t, sigma_t = summaries(idata)
    rmse_j, sigma_j = summaries(ref)
    assert abs(rmse_t - rmse_j) < 0.35, (rmse_t, rmse_j)
    assert abs(sigma_t - sigma_j) < 0.4, (sigma_t, sigma_j)
    assert rmse_t < 2.5       # far below the 4.8 of a constant prediction


@pytest.mark.parametrize("kwargs, word", [
    (dict(mesh=object()), "mesh"),
], ids=["mesh"])
def test_sample_refuses_arguments_that_wait(kwargs, word):
    """No argument waits any more: ``mesh`` runs
    (tests/test_torch_parallel.py), the other five are tested in
    tests/test_torch_checkpoint.py and tests/test_torch_debug_aids.py.  A
    ``mesh`` that is not a ``DeviceMesh`` over the JAX package's axes is
    refused."""
    X, Y, _ = _toy(30, 3)
    with tpmb.Model():
        mu = tpmb.BART("mu", X, Y, m=4)
        tpmb.Normal("y", mu, 1.0, observed=Y)
        with pytest.raises(TypeError, match=word):
            tpmb.sample(tune=1, draws=1, chains=1, device="cpu", **kwargs)


def _logistic(n, p, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    logit = 8 * (X[:, 0] - 0.5) + 5 * (X[:, 1] - 0.5)
    return X, rng.binomial(1, 1 / (1 + np.exp(-logit))).astype(np.float32)


def _fit_logistic(pmb, seed, **kw):
    X, Y = _logistic(N, P_COLS)
    with pmb.Model():
        lo = pmb.BART("lo", X, Y, m=M)
        pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=Y)
        idata = pmb.sample(tune=TUNE, draws=DRAWS, chains=CHAINS,
                           num_particles=PARTICLES, random_seed=seed,
                           convergence_checks=False, **kw)
    lo_hat = np.asarray(idata.posterior["lo"].values).mean(axis=(0, 1))
    acc = float(((lo_hat > 0) == (Y > 0.5)).mean())
    return idata, acc, float(lo_hat.mean()), float(np.abs(lo_hat).mean())


def test_logistic_model_within_monte_carlo_band_of_jax():
    """``y ~ Bernoulli(sigmoid(BART))``: no free parameter, so no NUTS step
    (``theta_size == 0``); the bernoulli code drives every PGBART step.  Over
    seeds 0..3 the two packages give train accuracy 0.84..0.91, mean posterior
    logit 0.03..0.10 and mean absolute logit 0.56..0.90 at this size; the
    bands are 0.1, 0.3 and 0.45."""
    idata, acc_t, mean_t, abs_t = _fit_logistic(tpmb, 0, device="cpu")
    post = idata.posterior["lo"].values
    assert post.shape == (CHAINS, DRAWS, N) and np.isfinite(post).all()
    assert set(idata.posterior.keys()) == {"lo"}          # theta_size == 0
    assert (idata["sample_stats"]["mean_accept"].values == 1.0).all()
    assert idata["sample_stats"]["variable_inclusion"].values.sum() > 0
    _, Y = _logistic(N, P_COLS)
    assert acc_t > max(Y.mean(), 1 - Y.mean()) + 0.05
    _, acc_j, mean_j, abs_j = _fit_logistic(jpmb, 0)
    assert abs(acc_t - acc_j) < 0.1, (acc_t, acc_j)
    assert abs(mean_t - mean_j) < 0.3, (mean_t, mean_j)
    assert abs(abs_t - abs_j) < 0.45, (abs_t, abs_j)


def test_sample_route_keyword(port_fit):
    """``pgbart_route`` forces a route; on the CPU both give the same draws
    (the fused route's plain version is the per-round route's)."""
    idata, _, _ = port_fit
    again, _ = _fit(tpmb, 0, device="cpu", pgbart_route="rounds")
    np.testing.assert_array_equal(idata.posterior["mu"].values,
                                  again.posterior["mu"].values)
    X, Y, _ = _toy(30, 3)
    with tpmb.Model():
        mu = tpmb.BART("mu", X, Y, m=4)
        tpmb.Normal("y", mu, 1.0, observed=Y)
        with pytest.raises(ValueError, match="pgbart_route"):
            tpmb.sample(tune=1, draws=1, chains=1, device="cpu",
                        pgbart_route="mega")


def _het_model(X, Y):
    # a scale link without a closed form: the scale forest's entry takes the
    # generic model likelihood, the mean forest its per-row precision
    w = tpmb.BART("w", X, Y, m=4, shape=(2, 30), separate_trees=True)
    return tpmb.Normal("y", w[0], 2.0 * tpmb.math.abs(w[1]), observed=Y)


def _categorical_model(X, Y):
    # one forest with two leaf values a node (joint trees, generic
    # likelihood)
    labels = (Y > Y.mean()) * 1.0
    lo = tpmb.BART("lo", X, labels, m=4, shape=(2, 30))
    return tpmb.Categorical("y", p=tpmb.math.softmax(lo.T, axis=-1),
                            observed=labels)


# each case that now runs: (BART name, value shape a draw, all_trees: the
# outputs of one store, or a list of one-output stores); None: still refused
_RUNS = {"bernoulli": ("mu", (30,), 1),
         "heteroscedastic": ("w", (2, 30), [1, 1]),
         "categorical": ("lo", (2, 30), 2), "linear": ("mu", (30,), 1),
         "two_outputs": ("mu", (2, 30), 2)}


@pytest.mark.parametrize("build, word", [
    (lambda X, Y: tpmb.Bernoulli(
        "y", tpmb.math.sigmoid(
            2.0 * tpmb.BART("mu", X, (Y > Y.mean()) * 1.0, m=4)),
        observed=(Y > Y.mean()) * 1.0), "fused likelihoods"),
    (_het_model, "fused likelihoods"),
    (_categorical_model, "n_outputs"),
    (lambda X, Y: tpmb.Bernoulli(
        "y", tpmb.math.sigmoid(tpmb.BART(
            "mu", X, (Y > Y.mean()) * 1.0, m=4, response="linear")),
        observed=(Y > Y.mean()) * 1.0), "response"),
    (lambda X, Y: tpmb.Normal(
        "y", tpmb.BART("mu", X, Y, m=4, shape=(2, 30))[0], 1.0, observed=Y),
     "n_outputs"),
], ids=["bernoulli", "heteroscedastic", "categorical", "linear",
        "two_outputs"])
def test_sample_refuses_models_that_wait(request, build, word):
    """The models that waited for the generic likelihood and joint forests,
    and the linear response under a non-Gaussian likelihood, now sample on
    the CPU (finite draws of the right shape, the per-round route's warning
    given, the stores laid out as in JAX)."""
    case = request.node.callspec.id
    X, Y, _ = _toy(30, 3)
    with tpmb.Model() as model:
        with pytest.warns() if word == "response" else _nullcontext():
            build(X, Y)
        if _RUNS[case] is None:
            with pytest.raises(NotImplementedError, match=word):
                tpmb.sample(tune=1, draws=1, chains=1, device="cpu")
            return
        with pytest.warns(UserWarning, match="per-round"):
            idata = tpmb.sample(tune=3, draws=4, chains=2, random_seed=1,
                                device="cpu", convergence_checks=False)
    name, shape, stores = _RUNS[case]
    post = idata.posterior[name].values
    assert post.shape == (2, 4) + shape and np.isfinite(post).all()
    trees = model.bart_rvs[0].all_trees
    if isinstance(stores, list):
        assert [t.n_outputs for t in trees] == stores
    else:
        assert trees.n_outputs == stores and trees.leaf.shape[:2] == (2, 4)
    assert idata["sample_stats"]["variable_inclusion"].values.sum() > 0


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_constant_sigma_and_hmc_algorithm_run():
    X, Y, _ = _toy(40, 3)
    with tpmb.Model():
        mu = tpmb.BART("mu", X, Y, m=4, max_depth=3)
        s = tpmb.HalfNormal("sigma", 2.0)
        tpmb.Normal("y", mu, s, observed=Y)
        idata = tpmb.sample(tune=5, draws=6, chains=2, num_particles=4,
                            random_seed=3, device="cpu", algorithm="hmc",
                            store_trees=False, convergence_checks=False)
    assert idata.posterior["mu"].shape == (2, 6, 40)
    assert mu.all_trees is None
    with tpmb.Model():
        mu = tpmb.BART("mu", X, Y, m=4, max_depth=3)
        tpmb.Normal("y", mu, 1.5, observed=Y)     # no free RV: PGBART only
        idata = tpmb.sample(tune=3, draws=4, chains=2, num_particles=4,
                            random_seed=3, device="cpu",
                            convergence_checks=False)
    assert idata.posterior["mu"].shape == (2, 4, 40)
    assert np.isfinite(idata.posterior["mu"].values).all()
