"""Interpretability data layer: PDP / ICE curves and submodel scoring.

Counterpart of ``pymc_bart_tpu/utils/interpret.py``: NumPy over the port's
predictions of stored draws, which run on the card (``device=None``) or on
the CPU (``device="cpu"``).  Rendering lives in ``utils/plots.py`` and
``utils/importance.py``.

* ``partial_dependence`` evaluates every requested covariate's partial
  dependence in one batched pass: the exclusion masks of all panels go
  through the count-weighted traversal together
  (``posterior.predict_draw_indices`` with ``masks``, chunked under its pass
  budget where the JAX package falls back to one pass a variable above a
  cell budget; the draws are the same either way).
* ``ice`` builds the (instances x grid) design of a variable once and runs
  one batched posterior prediction.
* ``SubmodelScorer`` caches one full-model prediction and scores any
  variable subset against it by paired R^2, vectorised over the samples.

The draw indices come from the caller's NumPy ``Generator`` in the JAX
package's order, so one seed picks the same draws on both.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .posterior import predict_draw_indices, sample_posterior

#: quantiles used when ``strategy="quantiles"`` and no spec is given
DEFAULT_GRID_QUANTILES = [0.05, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.95]
#: points used when ``strategy="linear"`` and no spec is given
DEFAULT_GRID_POINTS = 10
_F32_EPS = float(np.finfo(np.float32).eps)


def as_matrix(X):
    """Coerce a covariate container to ``(ndarray, column labels | None)``.

    Accepts numpy arrays plus anything pandas/polars-shaped (duck-typed
    on ``columns``/``to_numpy``).
    """
    labels = None
    if hasattr(X, "columns") and hasattr(X, "to_numpy"):
        labels = [str(c) for c in X.columns]
        X = X.to_numpy()
    return np.asarray(X, np.float64), labels


def evaluation_grid(X: np.ndarray, strategy: str, spec=None) -> np.ndarray:
    """Rows at which partial dependence is evaluated.

    strategy: ``"insample"`` (the training rows), ``"linear"`` (``spec``
    evenly spaced points per column), or ``"quantiles"`` (``spec`` = list
    of quantiles per column).  NaNs are ignored when computing ranges.
    """
    if strategy == "insample":
        return X
    if strategy == "linear":
        num = DEFAULT_GRID_POINTS if spec is None else int(spec)
        return np.linspace(np.nanmin(X, axis=0), np.nanmax(X, axis=0),
                           num=num, axis=0)
    if strategy == "quantiles":
        qs = DEFAULT_GRID_QUANTILES if spec is None else list(spec)
        return np.nanquantile(X, q=qs, axis=0)
    raise ValueError(
        f"{strategy} is not supported. Available options are 'insample', "
        "'linear' or 'quantiles'")


@dataclasses.dataclass
class CurveBundle:
    """Response curves of one covariate.

    xs: the covariate's grid values, shape (g,).
    curves: response draws, shape (c, g, k) — c is posterior samples for
    PDP or pinned instances for ICE; k is the output count.
    """

    var: int
    xs: np.ndarray
    curves: np.ndarray


def partial_dependence(
    all_trees,
    X: np.ndarray,
    var_idx: Sequence[int],
    strategy: str = "quantiles",
    spec=None,
    samples: int = 200,
    rng: Optional[np.random.Generator] = None,
    device=None,
) -> List[CurveBundle]:
    """Partial dependence of each variable in ``var_idx``.

    Predicts with every OTHER covariate integrated out by count-weighted
    traversal (the reference's fast PDP); one store's panels share one set
    of ``samples`` draws and one batched pass, a list of per-output stores
    takes one pass a variable.
    """
    if rng is None:
        rng = np.random.default_rng()
    grid = evaluation_grid(X, strategy, spec)
    p = X.shape[1]

    if not isinstance(all_trees, (list, tuple)):
        masks = np.ones((len(var_idx), p), bool)
        for row, var in enumerate(var_idx):
            masks[row, var] = False  # only the target covariate stays active
        idx = rng.integers(0, all_trees.n_total, size=samples)
        preds = predict_draw_indices(all_trees, grid, idx, device=device,
                                     masks=masks)
        return [CurveBundle(var, grid[:, var], preds[row])
                for row, var in enumerate(var_idx)]
    out = []
    for var in var_idx:
        excl = [j for j in range(p) if j != var]
        preds = sample_posterior(all_trees, grid, rng=rng, size=samples,
                                 excluded=excl, device=device)
        out.append(CurveBundle(var, grid[:, var], preds))
    return out


def ice(
    all_trees,
    X: np.ndarray,
    var_idx: Sequence[int],
    instances: int = 30,
    samples: int = 100,
    rng: Optional[np.random.Generator] = None,
    centered: bool = False,
    device=None,
) -> List[CurveBundle]:
    """Individual conditional expectation curves.

    For each variable: pick ``instances`` random training rows, pin every
    OTHER covariate to each instance's values, sweep the variable over
    all in-sample values, and average the response over ``samples``
    posterior draws.  The (instances x n) designs of one variable are
    stacked into a single prediction.
    """
    if rng is None:
        rng = np.random.default_rng()
    n, p = X.shape
    chosen = rng.choice(n, size=min(instances, n), replace=False)
    n_inst = chosen.size

    out = []
    for var in var_idx:
        # design: instance block i = X with all-but-var pinned to row i
        design = np.tile(X, (n_inst, 1))
        others = [j for j in range(p) if j != var]
        pinned = np.repeat(X[chosen][:, others], n, axis=0)
        design[:, others] = pinned
        preds = sample_posterior(all_trees, design, rng=rng, size=samples,
                                 device=device)
        k = preds.shape[-1]
        curves = preds.reshape(samples, n_inst, n, k).mean(axis=0)
        if centered:
            curves = curves - curves[:, :1, :]
        out.append(CurveBundle(var, X[:, var], curves))
    return out


def paired_r2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared Pearson correlation of matched samples.

    a, b: (samples, ...) — each sample's remaining axes are flattened and
    correlated; returns (samples,), vectorised over the sample axis.  A
    sample whose values spread by no more than float32 rounding (8 units
    in the last place of its largest value) counts as constant and scores
    0: the JAX package scores only an exactly constant one so, and leaves
    the R^2 of rounding noise to the order of a device's sums.
    """
    a = a.reshape(a.shape[0], -1).astype(np.float64)
    b = b.reshape(b.shape[0], -1).astype(np.float64)
    ac = a - a.mean(axis=1, keepdims=True)
    bc = b - b.mean(axis=1, keepdims=True)
    num = (ac * bc).sum(axis=1)
    saa, sbb = (ac * ac).sum(axis=1), (bc * bc).sum(axis=1)

    def noise(x):
        return a.shape[1] * (8 * _F32_EPS * np.abs(x).max(axis=1)) ** 2

    den = np.sqrt(saa * sbb)
    spread = (saa > noise(a)) & (sbb > noise(b)) & (den > 0)
    return np.where(spread, (num / np.maximum(den, 1e-300)) ** 2, 0.0)


@dataclasses.dataclass
class SubmodelScore:
    kept: tuple
    r2: np.ndarray        # (samples,) R^2 vs the full model
    preds: np.ndarray     # (samples, n, k) submodel predictions


class SubmodelScorer:
    """Scores variable subsets against the full model's predictions.

    Holds the posterior store, the evaluation rows, and one cached
    full-model prediction; ``score(kept)`` predicts with the complement
    of ``kept`` excluded and returns per-sample R^2 against the cache.
    """

    def __init__(self, all_trees, X: np.ndarray, samples: int,
                 rng: np.random.Generator, device=None):
        self.all_trees = all_trees
        self.X = X
        self.samples = samples
        self.rng = rng
        self.device = device
        self.n_vars = X.shape[1]
        self.full = sample_posterior(all_trees, X, rng=rng, size=samples,
                                     device=device)

    def score(self, kept: Sequence[int]) -> SubmodelScore:
        kept = tuple(kept)
        excluded = [j for j in range(self.n_vars) if j not in kept]
        preds = sample_posterior(self.all_trees, self.X, rng=self.rng,
                                 size=self.samples, excluded=excluded,
                                 device=self.device)
        return SubmodelScore(kept, paired_r2(self.full, preds), preds)
