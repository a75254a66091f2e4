"""Small statistics helpers (HDI, R^2), NumPy only.

Counterpart of ``pymc_bart_tpu/utils/stats.py`` (copied: the port imports
nothing of the JAX package), standing in for arviz-stats and numba.
"""

from __future__ import annotations

import numpy as np

DEFAULT_CI_PROB = 0.94  # arviz rcParams["stats.ci_prob"] default


def hdi(ary: np.ndarray, prob: float = DEFAULT_CI_PROB, axis=None) -> np.ndarray:
    """Highest-density interval of samples along ``axis`` (default: axis 0
    after flattening leading dims like arviz's array_stats.hdi).

    Returns an array with the reduced axis replaced by a trailing
    dimension of size 2 (low, high).
    """
    ary = np.asarray(ary)
    if axis is None:
        ary = ary.reshape(-1)
        axis = 0
    ary = np.moveaxis(ary, axis, 0)
    n = ary.shape[0]
    sorted_ = np.sort(ary, axis=0)
    interval = max(1, int(np.floor(prob * n)))
    n_intervals = n - interval
    if n_intervals <= 0:
        low = sorted_[0]
        high = sorted_[-1]
    else:
        widths = sorted_[interval:] - sorted_[:n_intervals]
        min_idx = np.argmin(widths, axis=0)
        low = np.take_along_axis(sorted_, min_idx[None], axis=0)[0]
        high = np.take_along_axis(sorted_, (min_idx + interval)[None], axis=0)[0]
    return np.stack([low, high], axis=-1)


def pearsonr2(A: np.ndarray, B: np.ndarray) -> float:
    """Squared Pearson correlation of flattened arrays (reference
    utils.py:1314-1321, sans numba)."""
    A = np.asarray(A, dtype=np.float64).ravel()
    B = np.asarray(B, dtype=np.float64).ravel()
    am = A - A.mean()
    bm = B - B.mean()
    denom = (am**2).sum() * (bm**2).sum()
    if denom <= 0:
        return 0.0
    return float((am @ bm) ** 2 / denom)
