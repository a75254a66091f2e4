"""The check of the model ``bart_bernoulli`` (``models/bart_bernoulli.py``):
the numbers that decide whether a run of its cell is correct, from the
program's outputs and the inputs alone (plain NumPy).

Every fit of the window is an answer.  For each one (``numbers``):

* ``lo_gap``: the widest gap, in logit units, between a stored draw of
  ``lo`` and the sum of the leaf values that the stored forest of the same
  draw gives on the covariates the sampler routed on
  (``forest.jitter_duplicates``): on every row for a sample of draws, and on
  a sample of rows for every draw, both drawn from the run's seed, as
  ``check.py`` reads ``mu_gap``.  It covers the committed trees, the
  prediction, the per-draw collection and the drain to the host.
* ``rate_gap``: over the chains, the widest gap between the mean of
  ``sigmoid(lo)`` over a sample of a chain's draws and the rows and the
  share of ones among the labels: a fitted logit with a constant term
  reproduces the base rate.
* ``rmse_p``: the root mean square gap between the mean of ``sigmoid(lo)``
  over the same sampled draws and the true probability ``sigmoid(f)`` of
  each row.
* ``structure_errors``: outputs of the wrong shape, values that are not
  finite, split variables out of range, and chains that repeat another
  chain's draws (on the first ``DUPLICATE_ROWS`` rows).

The cell's ``check`` gives the sample sizes: ``draws_per_fit`` and
``rows_per_fit`` for ``lo_gap``, ``draws_for_rates`` (a chain) for
``rate_gap`` and ``rmse_p``.  A fit's cost is then fixed by them and the
shapes, whatever its speed: the forests are descended all trees at once
(``descend``), and the rates read a fixed number of draws.
"""

import numpy as np

from . import check, forest

# every number ``numbers`` reads; a cell's ``limits`` give each one a limit
NUMBERS = ("structure_errors", "lo_gap", "rate_gap", "rmse_p")
# a chain repeats another where its draws equal the other's on these rows
DUPLICATE_ROWS = 256


def sigmoid(x):
    return 0.5 * (1.0 + np.tanh(0.5 * x))


def shape_errors(out, chains, draws, n):
    """Count of the fit's outputs of the wrong shape."""
    return int((out["lo"].shape != (chains, draws, n))
               + (out["split_var"].shape[:2] != (chains, draws)))


def structure_errors(out, chains, draws, n, p):
    """Count of shape, finiteness and range faults in one fit's outputs."""
    bad = shape_errors(out, chains, draws, n)
    if bad:
        return bad
    lo, sv = out["lo"], out["split_var"]
    bad += int(not np.isfinite(lo).all())
    bad += int(not np.isfinite(out["leaf"]).all())
    bad += int(((sv < -1) | (sv >= p)).any())
    flat = lo[..., :DUPLICATE_ROWS].reshape(chains, -1)
    for c in range(1, chains):
        bad += int(any(np.array_equal(flat[c], flat[o]) for o in range(c)))
    return int(bad)


def descend(split_var, split_val, leaf, X, block=8192):
    """Sum-of-trees prediction in float64 (..., n) of forests ``split_var``
    / ``split_val`` (..., m, S) with ``leaf`` (..., m, S[, 1]) on the rows of
    ``X`` (n, p), by the rule of ``forest.leaf_slots``: a row goes left where
    ``x <= split value``, a split on the last level of slots has no children
    and keeps its rows, and a tree equal to the same tree of the forest
    before it takes that tree's slots.  The other trees are descended at
    once, level by level, in blocks of rows, until no row of the block is at
    a split: the cost is the rows times those trees times the depth
    reached, whatever the number of splits (``forest.predict`` loops over
    the splits)."""
    split_var = np.asarray(split_var)
    S = split_var.shape[-1]
    lead = split_var.shape[:-1]
    m = lead[-1]
    sv = split_var.reshape(-1, S)
    sl = np.asarray(split_val, np.float32).reshape(-1, S)
    X = np.asarray(X, np.float32)
    T, (n, p) = sv.shape[0], X.shape
    new = np.ones(T, bool)
    new[m:] = ((sv[m:] != sv[:-m]) | (sl[m:] != sl[:-m])).any(axis=1)
    svf, slf = sv.reshape(-1).astype(np.int32), sl.reshape(-1)
    at0 = (np.flatnonzero(new).astype(np.int32) * S)[:, None]  # the roots
    slots = np.empty((at0.size, n), np.int32)
    for r0 in range(0, n, block):
        xb = X[r0:r0 + block]
        xf, xrow = xb.ravel(), (np.arange(len(xb), dtype=np.int32) * p)[None]
        at = np.repeat(at0, len(xb), axis=1)                 # flat slot
        for _level in range(int(np.log2(S + 1)) - 1):
            var = svf[at]
            slot = at - at0
            inner = (var >= 0) & (slot < S // 2)
            if not inner.any():
                break
            right = xf[xrow + np.maximum(var, 0)] > slf[at]
            at = np.where(inner, at + slot + 1 + right, at)
        slots[:, r0:r0 + len(xb)] = at - at0
    # each tree takes the slots of the last new tree at its place
    src = np.where(new, np.arange(T), 0).reshape(-1, m)
    src = np.maximum.accumulate(src, axis=0).reshape(-1)
    slot = slots[(np.cumsum(new) - 1)[src]]                     # (T, n)
    lf = np.asarray(leaf, np.float64).reshape(-1)
    pred = lf[(np.arange(T) * S)[:, None] + slot].reshape(lead + (n,))
    return pred.sum(axis=-2)


def rate_draws(rng, chains, draws, k):
    """``k`` distinct draws of each chain, drawn by ``rng``, in order:
    (chains, k)."""
    k = min(k, draws)
    return np.sort(np.stack([rng.choice(draws, size=k, replace=False)
                             for _c in range(chains)]), axis=1)


def fit_numbers(out, X, Y, f, draws_idx, rows_idx, rates_idx):
    """The numbers of one fit.  ``out`` holds the program's ``lo`` (C, D, n),
    the stored forests ``split_var`` / ``split_val`` / ``leaf`` (C, D, m,
    S[, 1]) and the fit's ``random_seed``; ``draws_idx`` the (chain, draw)
    pairs whose forests are descended on every row, ``rows_idx`` the rows on
    which every draw's forest is descended, ``rates_idx`` (C, k) the draws
    of each chain that the rates read."""
    lo = np.asarray(out["lo"])
    Xr = forest.jitter_duplicates(X, int(out["random_seed"])
                                  ^ check.JITTER_SALT)
    c_i, d_i = np.asarray(draws_idx).T
    ref = descend(out["split_var"][c_i, d_i], out["split_val"][c_i, d_i],
                  out["leaf"][c_i, d_i], Xr)
    gap = np.max(np.abs(lo[c_i, d_i].astype(np.float64) - ref))
    ref_rows = descend(out["split_var"], out["split_val"], out["leaf"],
                       Xr[rows_idx])
    gap = max(gap, np.max(np.abs(lo[..., rows_idx].astype(np.float64)
                                 - ref_rows)))
    # the probabilities in the draws' own precision, their means in float64
    chains = np.arange(lo.shape[0])[:, None]
    prob = sigmoid(lo[chains, rates_idx])                       # (C, k, n)
    rate = prob.mean(axis=(1, 2), dtype=np.float64)             # (C,)
    rate_gap = float(np.max(np.abs(rate - np.mean(np.asarray(Y, np.float64)))))
    rmse_p = float(np.sqrt(np.mean((prob.mean(axis=(0, 1), dtype=np.float64)
                                    - sigmoid(np.asarray(f, np.float64)))
                                   ** 2)))
    return {"lo_gap": float(gap), "rate_gap": rate_gap, "rmse_p": rmse_p}


def numbers(out, data, kw, sizes, rng):
    """The numbers of one fit: ``out`` its outputs, ``data`` its data set
    ``(X, Y, f)``, ``kw`` the ``sample()`` arguments (``chains``,
    ``draws``), ``sizes`` the cell's ``check`` (``draws_per_fit``,
    ``rows_per_fit``, ``draws_for_rates``) and ``rng`` the run's generator
    of the sampled draws and rows, shared by its fits in turn.  A fit whose
    outputs have the wrong shape reads ``structure_errors`` alone."""
    X, Y, f = data
    n, p = X.shape
    nums = {"structure_errors": structure_errors(
        out, kw["chains"], kw["draws"], n, p)}
    if shape_errors(out, kw["chains"], kw["draws"], n) == 0:
        idx = check.sample_draws(rng, kw["chains"], kw["draws"],
                                 sizes["draws_per_fit"])
        rows = check.sample_rows(rng, n, sizes["rows_per_fit"])
        rates = rate_draws(rng, kw["chains"], kw["draws"],
                           sizes["draws_for_rates"])
        nums.update(fit_numbers(out, X, Y, f, idx, rows, rates))
    return nums
