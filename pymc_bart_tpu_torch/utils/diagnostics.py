"""Convergence diagnostics: split-R-hat and bulk ESS.

Counterpart of ``pymc_bart_tpu/utils/diagnostics.py`` (NumPy only, copied).

The reference delegates diagnostics to arviz (deprecated
``plot_convergence`` points at arviz-plots, reference utils.py:99-131);
arviz is not part of this image, so the standard rank-normalized
split-R-hat and bulk effective sample size (Vehtari et al. 2021) are
provided natively.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..models.inference_data import InferenceData


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(chains, draws, ...) -> (2*chains, draws//2, ...)."""
    c, d = x.shape[:2]
    half = d // 2
    first = x[:, :half]
    second = x[:, half : 2 * half]
    return np.concatenate([first, second], axis=0)


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Rank-normalize draws across all chains (per remaining dims)."""
    shape = x.shape
    flat = x.reshape(-1, int(np.prod(shape[2:])) if x.ndim > 2 else 1)
    out = np.empty_like(flat, dtype=np.float64)
    n = flat.shape[0]
    from scipy.stats import norm

    for j in range(flat.shape[1]):
        ranks = np.argsort(np.argsort(flat[:, j])) + 1
        out[:, j] = norm.ppf((ranks - 0.375) / (n + 0.25))
    return out.reshape(shape)


def rhat(x: np.ndarray) -> np.ndarray:
    """Rank-normalized split-R-hat of (chains, draws, ...) samples."""
    x = _split_chains(np.asarray(x, np.float64))
    z = _rank_normalize(x)
    c, d = z.shape[:2]
    chain_means = z.mean(axis=1)
    chain_vars = z.var(axis=1, ddof=1)
    between = d * chain_means.var(axis=0, ddof=1)
    within = chain_vars.mean(axis=0)
    var_plus = (d - 1) / d * within + between / d
    return np.sqrt(var_plus / np.maximum(within, 1e-12))


def ess_bulk(x: np.ndarray) -> np.ndarray:
    """Bulk effective sample size of (chains, draws, ...) samples."""
    x = _split_chains(np.asarray(x, np.float64))
    z = _rank_normalize(x)
    c, d = z.shape[:2]
    extra = z.shape[2:]
    z2 = z.reshape(c, d, -1)
    ess = np.empty(z2.shape[2])
    for j in range(z2.shape[2]):
        ess[j] = _ess_mean(z2[:, :, j])
    return ess.reshape(extra) if extra else ess[0]


def _ess_mean(z: np.ndarray) -> float:
    """ESS via Geyer initial monotone sequence on per-chain autocorr."""
    c, d = z.shape
    if d < 4:
        return float(c * d)
    var_plus = 0.0
    acov = np.zeros((c, d))
    for i in range(c):
        zc = z[i] - z[i].mean()
        f = np.fft.rfft(zc, 2 * d)
        acf = np.fft.irfft(f * np.conj(f))[:d] / d
        acov[i] = acf
    chain_means = z.mean(axis=1)
    within = acov[:, 0].mean() * d / (d - 1.0)
    between = chain_means.var(ddof=1) if c > 1 else 0.0
    var_plus = within * (d - 1.0) / d + between
    if var_plus <= 0:
        return float(c * d)
    rho = 1.0 - (within - acov.mean(axis=0)) / var_plus
    rho[0] = 1.0
    # Geyer initial monotone positive sequence over lag pairs:
    # tau = -1 + 2 * sum_t (rho_{2t} + rho_{2t+1})
    total = 0.0
    prev = np.inf
    t = 0
    while 2 * t + 1 < d:
        pair = rho[2 * t] + rho[2 * t + 1]
        if pair <= 0:
            break
        pair = min(pair, prev)
        prev = pair
        total += pair
        t += 1
    tau = max(-1.0 + 2.0 * total, 1.0 / np.log10(c * d + 10))
    return float(c * d / tau)


def check_convergence(idata: InferenceData, rhat_threshold: float = 1.1,
                      max_slices: int = 64) -> Dict[str, float]:
    """Max split-R-hat per posterior variable (subsampled slices).

    For vector/array variables (e.g. per-row ``mu`` at n=50k) the check
    looks at ``max_slices`` evenly spaced scalar slices rather than every
    element — enough to flag non-convergence without an O(n) rank-sort
    pass after every ``sample()``.  Returns ``{var: max_rhat_checked}``;
    entries above ``rhat_threshold`` indicate chains that have not mixed
    (PyMC surfaces the same statistic through arviz after sampling —
    reference relies on ``pm.sample``'s convergence checks).
    """
    out: Dict[str, float] = {}
    for name in idata.posterior.keys():
        v = np.asarray(idata.posterior[name].values, np.float64)
        if v.ndim < 2 or v.shape[0] < 2 or v.shape[1] < 4:
            continue  # need >=2 chains and a few draws for split-R-hat
        flat = v.reshape(v.shape[0], v.shape[1], -1)
        k = flat.shape[2]
        idx = (np.linspace(0, k - 1, min(k, max_slices)).round().astype(int)
               if k > max_slices else np.arange(k))
        out[name] = float(np.max(rhat(flat[:, :, idx])))
    return out


def maybe_warn_convergence(idata: InferenceData,
                           rhat_threshold: float = 1.1) -> Dict[str, float]:
    """Warn (``UserWarning``) when any posterior variable's checked
    split-R-hat exceeds ``rhat_threshold``; returns the per-variable
    maxima either way."""
    import warnings

    rhats = check_convergence(idata, rhat_threshold=rhat_threshold)
    bad = {k: v for k, v in rhats.items() if v > rhat_threshold}
    if bad:
        worst = max(bad, key=bad.get)
        warnings.warn(
            f"split-R-hat exceeds {rhat_threshold:g} for "
            f"{sorted(bad)} (worst: {worst} = {bad[worst]:.2f}); chains "
            "have not converged for these quantities.  Consider more "
            "tune/draws, or ancestor_sampling=True for per-row BART "
            "functionals (PG path degeneracy).",
            UserWarning, stacklevel=3,
        )
    return rhats


def summary(idata: InferenceData, var_names=None) -> Dict[str, Dict[str, float]]:
    """Per-variable posterior mean/sd/R-hat/ESS table (dict of dicts)."""
    out: Dict[str, Dict[str, float]] = {}
    post = idata.posterior
    for name in post.keys():
        if var_names is not None and name not in var_names:
            continue
        v = np.asarray(post[name].values, np.float64)
        out[name] = {
            "mean": float(v.mean()),
            "sd": float(v.std()),
            "rhat_max": float(np.max(rhat(v))),
            "ess_bulk_min": float(np.min(ess_bulk(v))),
        }
    return out
