"""The check of the model ``bart_normal`` (``models/bart_normal.py``): the
numbers that decide whether a run of its cell is correct, from the
program's outputs and the inputs alone (plain NumPy).

Every fit of the window is an answer.  For each one (``numbers``):

* ``mu_gap``: the widest gap between a stored draw of ``mu`` and the sum of
  the leaf values that the stored forest of the same draw gives on the
  covariates the sampler routed on (``forest.jitter_duplicates``), in units
  of ``std(Y)``: on every row for a sample of draws, and on a sample of rows
  for every draw, both drawn from the run's seed.  It covers the committed
  trees, the prediction, the per-draw collection and the drain to the host.
* ``sigma_gap``: over the chains, the widest relative gap between the mean
  of the ``sigma`` draws and the mean residual scale
  ``sqrt(mean((Y - mu_draw)^2))`` of the ``mu`` draws: sigma's conditional
  posterior sits at the residual scale, so NUTS and its collection are held
  to the forest.
* ``rmse_f``: the root mean square gap between the posterior mean of ``mu``
  and the true function of the data.
* ``structure_errors``: outputs of the wrong shape, values that are not
  finite, split variables out of range, and chains that repeat another
  chain's draws.
"""

import numpy as np

from . import forest

# every number ``numbers`` reads; a cell's ``limits`` give each one a limit
NUMBERS = ("structure_errors", "mu_gap", "sigma_gap", "rmse_f")
# the sampler's seed of the duplicate-value jitter, from the fit's seed
JITTER_SALT = 0x5EED


def shape_errors(out, chains, draws, n):
    """Count of the fit's outputs of the wrong shape."""
    return int((out["mu"].shape != (chains, draws, n))
               + (out["sigma"].shape != (chains, draws))
               + (out["split_var"].shape[:2] != (chains, draws)))


def structure_errors(out, chains, draws, n, p):
    """Count of shape, finiteness and range faults in one fit's outputs."""
    bad = shape_errors(out, chains, draws, n)
    if bad:
        return bad
    mu, sigma, sv = out["mu"], out["sigma"], out["split_var"]
    bad += int(not np.isfinite(mu).all())
    bad += int(not (np.isfinite(sigma).all() and (sigma > 0).all()))
    bad += int(not np.isfinite(out["leaf"]).all())
    bad += int(((sv < -1) | (sv >= p)).any())
    # a chain equal to another chain: draws that were not gathered
    flat = mu.reshape(chains, -1)
    for c in range(1, chains):
        bad += int(any(np.array_equal(flat[c], flat[o]) for o in range(c)))
    return int(bad)


def fit_numbers(out, X, Y, f, draws_idx, rows_idx):
    """The numbers of one fit.  ``out`` holds the program's ``mu`` (C, D, n),
    ``sigma`` (C, D), the stored forests ``split_var`` / ``split_val`` /
    ``leaf`` (C, D, m, S[, 1]) and the fit's ``random_seed``; ``draws_idx``
    the (chain, draw) pairs whose forests are descended on every row,
    ``rows_idx`` the rows on which every draw's forest is descended."""
    mu = np.asarray(out["mu"], np.float64)
    sigma = np.asarray(out["sigma"], np.float64)
    y = np.asarray(Y, np.float64)
    Xr = forest.jitter_duplicates(X, int(out["random_seed"]) ^ JITTER_SALT)
    c_i, d_i = np.asarray(draws_idx).T
    ref = forest.predict(out["split_var"][c_i, d_i],
                         out["split_val"][c_i, d_i],
                         out["leaf"][c_i, d_i], Xr)
    gap = np.max(np.abs(mu[c_i, d_i] - ref))
    ref_rows = forest.predict(out["split_var"], out["split_val"], out["leaf"],
                              Xr[rows_idx])
    gap = max(gap, np.max(np.abs(mu[..., rows_idx] - ref_rows)))
    mu_gap = float(gap) / float(np.std(y))
    rms = np.sqrt(np.mean((y - mu) ** 2, axis=-1))              # (C, D)
    sigma_gap = float(np.max(np.abs(sigma.mean(1) / rms.mean(1) - 1.0)))
    rmse_f = float(np.sqrt(np.mean((mu.mean(axis=(0, 1)) - f) ** 2)))
    return {"mu_gap": mu_gap, "sigma_gap": sigma_gap, "rmse_f": rmse_f}


def numbers(out, data, kw, sizes, rng):
    """The numbers of one fit: ``out`` its outputs, ``data`` its data set
    ``(X, Y, f)``, ``kw`` the ``sample()`` arguments (``chains``,
    ``draws``), ``sizes`` the cell's ``check`` (``draws_per_fit``,
    ``rows_per_fit``) and ``rng`` the run's generator of the sampled draws
    and rows, shared by its fits in turn.  A fit whose outputs have the
    wrong shape reads ``structure_errors`` alone."""
    X, Y, f = data
    n, p = X.shape
    nums = {"structure_errors": structure_errors(
        out, kw["chains"], kw["draws"], n, p)}
    if shape_errors(out, kw["chains"], kw["draws"], n) == 0:
        idx = sample_draws(rng, kw["chains"], kw["draws"],
                           sizes["draws_per_fit"])
        rows = sample_rows(rng, n, sizes["rows_per_fit"])
        nums.update(fit_numbers(out, X, Y, f, idx, rows))
    return nums


def sample_rows(rng, n, k):
    """``k`` distinct rows drawn by ``rng``, in order."""
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def sample_draws(rng, chains, draws, k):
    """``k`` distinct (chain, draw) pairs drawn by ``rng``, the last draw of
    chain 0 always among them."""
    k = min(k, chains * draws)
    flat = rng.choice(chains * draws, size=k, replace=False)
    flat[0] = draws - 1
    flat = np.unique(flat)
    return np.stack([flat // draws, flat % draws], axis=1)
