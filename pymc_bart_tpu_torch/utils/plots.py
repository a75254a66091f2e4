"""Rendering layer for partial-dependence and ICE plots.

Counterpart of ``pymc_bart_tpu/utils/plots.py``.  Curve *computation* lives
in ``utils/interpret.py`` (batched predictions on the card); this module
only lays out panels and draws lines and bands.  ``matplotlib`` is imported
inside the plotting functions only, so that no import of the package needs
it.  The curves are smoothed by this module's own Savitzky-Golay filter
(``savgol_filter``, NumPy), where the JAX package calls SciPy's.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np

from .interpret import as_matrix, ice, partial_dependence
from .stats import DEFAULT_CI_PROB, hdi

_SMOOTH_GRID_POINTS = 200


# ---------------------------------------------------------------------------
# panel layout
# ---------------------------------------------------------------------------


def _panel_grid(layout, n_panels, sharex, sharey, figsize):
    """Figure + flat list of ``n_panels`` axes.

    layout: ``"long"`` (one column), ``"wide"`` (one row), or an
    ``(nrows, ncols)`` tuple — a too-small tuple is widened with a
    warning.
    """
    import matplotlib.pyplot as plt

    if layout == "long":
        shape = (n_panels, 1)
    elif layout == "wide":
        shape = (1, n_panels)
    elif isinstance(layout, tuple):
        nrows, ncols = layout
        if nrows * ncols < n_panels:
            warnings.warn(
                "The grid is smaller than the number of available variables "
                "to plot. Automatically adjusting the grid size."
            )
            nrows = -(-n_panels // ncols)
        shape = (nrows, ncols)
    else:
        raise ValueError(
            f"grid must be 'long', 'wide' or a tuple, got {layout!r}")

    fig, axmat = plt.subplots(*shape, sharex=sharex, sharey=sharey,
                              figsize=figsize)
    axes = list(np.ravel([axmat]))
    for extra in axes[n_panels:]:
        fig.delaxes(extra)
    return fig, axes[:n_panels]


def _resolve_axes(bartrv, n_vars, layout, sharey, figsize, ax):
    """(fig, axes, outputs-per-variable) honoring a user-supplied ax."""
    n_out = _output_count(bartrv)
    if ax is None:
        fig, axes = _panel_grid(layout, n_vars * n_out, False, sharey,
                                figsize)
    elif isinstance(ax, np.ndarray):
        axes, fig = list(np.ravel(ax)), np.ravel(ax)[0].get_figure()
    else:
        axes, fig = [ax], ax.get_figure()
    return fig, axes, n_out


def _output_count(bartrv) -> int:
    if isinstance(bartrv, list):
        return len(bartrv)
    return 1 if len(bartrv.shape) == 1 else bartrv.config.n_outputs


def _posterior_store(bartrv):
    rvs = bartrv if isinstance(bartrv, list) else [bartrv]
    if isinstance(bartrv, list) and not all(len(rv.shape) == 1 for rv in rvs):
        raise ValueError("List inputs must contain only 1D BART variables")
    if any(rv.all_trees is None for rv in rvs):
        raise ValueError(
            "BART variable has no sampled trees; run sample() first")
    return [rv.all_trees for rv in rvs] if isinstance(bartrv, list) \
        else bartrv.all_trees


def _axis_labels(col_names, var_idx):
    if col_names:
        return {v: col_names[v] for v in var_idx}
    return {v: f"X_{v}" for v in var_idx}


def _response_label(Y) -> str:
    name = getattr(Y, "name", None)
    return f"Partial {name}" if name is not None else "Partial Y"


# ---------------------------------------------------------------------------
# smoothing / bands
# ---------------------------------------------------------------------------


def savgol_filter(x, window_length: int = 55, polyorder: int = 2,
                  axis: int = 0) -> np.ndarray:
    """Savitzky-Golay smoothing along ``axis``, as
    ``scipy.signal.savgol_filter(x, window_length, polyorder, axis=axis)``
    with its defaults (``deriv=0``, ``mode="interp"``): each point of the
    interior is the value at the window's centre of the least-squares
    polynomial of degree ``polyorder`` over the ``window_length`` points
    around it; the first and last ``window_length // 2`` points take the
    polynomial fitted to the first / last window.  ``window_length`` must be
    odd, greater than ``polyorder`` and at most the length of ``x``."""
    x = np.moveaxis(np.asarray(x, np.float64), axis, 0)
    n = x.shape[0]
    if window_length % 2 != 1 or not polyorder < window_length <= n:
        raise ValueError(
            f"savgol_filter: window_length={window_length} must be odd, "
            f"above polyorder={polyorder} and at most the {n} points")
    half = window_length // 2
    # the fit on a centred, scaled abscissa: the same fitted values, a
    # better-conditioned design matrix
    t = (np.arange(window_length) - half) / max(half, 1)
    V = np.vander(t, polyorder + 1, increasing=True)
    fit = V @ np.linalg.pinv(V)          # window values -> fitted values
    out = np.empty_like(x)
    windows = np.lib.stride_tricks.sliding_window_view(x, window_length,
                                                       axis=0)
    out[half:n - half] = windows @ fit[half]
    out[:half] = np.tensordot(fit[:half], x[:window_length], axes=(1, 0))
    out[n - half:] = np.tensordot(fit[window_length - half:],
                                  x[n - window_length:], axes=(1, 0))
    return np.moveaxis(out, 0, axis)


def _smooth_on_grid(xs, ys, smooth_kwargs=None):
    """Interpolate curve(s) onto a dense grid and Savitzky-Golay filter.

    xs (g,); ys (g,) or (g, c).  Returns (grid, smoothed) with the same
    trailing shape.  1-D linear interpolation per curve (the grid is a
    single axis), then a polynomial smoothing window.
    """
    opts = {"window_length": 55, "polyorder": 2, **(smooth_kwargs or {})}
    grid = np.linspace(np.nanmin(xs), np.nanmax(xs), _SMOOTH_GRID_POINTS)
    grid[0] = 0.5 * (grid[0] + grid[1])
    order = np.argsort(xs)
    ys2 = ys[order].reshape(len(xs), -1)
    dense = np.empty((grid.size, ys2.shape[1]))
    for c in range(ys2.shape[1]):
        dense[:, c] = np.interp(grid, xs[order], ys2[:, c])
    smoothed = savgol_filter(dense, axis=0, **opts)
    return grid, smoothed.reshape((grid.size,) + ys[order].shape[1:])


def _credible_band(ax, xs, draws, smooth, smooth_kwargs, color, alpha):
    """Fill the HDI band of ``draws`` (c, g) over ``xs`` (g,)."""
    band = hdi(draws, DEFAULT_CI_PROB, axis=0)  # (g, 2)
    if smooth:
        grid, band = _smooth_on_grid(xs, band, smooth_kwargs)
    else:
        order = np.argsort(xs)
        grid, band = xs[order], band[order]
    ax.fill_between(grid, band[:, 0], band[:, 1], color=color, alpha=alpha)


# ---------------------------------------------------------------------------
# public plots
# ---------------------------------------------------------------------------


def plot_convergence(idata, var_name=None, kind="ecdf", figsize=None, ax=None):
    """Deprecated in the reference (reference ``utils.py:99-131``) — kept
    for API parity; warns and does nothing."""
    warnings.warn(
        "This function has been deprecated. "
        "Use a dedicated convergence-diagnostics plot instead.",
        FutureWarning,
    )


def plot_pdp(
    bartrv,
    X,
    Y=None,
    xs_interval: str = "quantiles",
    xs_values=None,
    var_idx=None,
    var_discrete=None,
    func: Optional[Callable] = None,
    samples: int = 200,
    ref_line: bool = True,
    random_seed: Optional[int] = None,
    sharey: bool = True,
    smooth: bool = True,
    grid: str = "long",
    color="C0",
    color_mean: str = "C0",
    alpha: float = 0.1,
    figsize=None,
    smooth_kwargs: Optional[Dict[str, Any]] = None,
    ax=None,
    device=None,
):
    """Partial dependence plot (capability parity: reference
    ``utils.py:278-450``; curves from ``interpret.partial_dependence``,
    predicted on ``device``: the GPU for None, ``"cpu"`` on request).
    """
    X, col_names = as_matrix(X)
    var_idx = list(var_idx) if var_idx is not None else list(range(X.shape[1]))
    discrete = set(var_discrete or [])
    labels = _axis_labels(col_names, var_idx)
    rng = np.random.default_rng(random_seed)

    bundles = partial_dependence(
        _posterior_store(bartrv), X, var_idx, strategy=xs_interval,
        spec=xs_values, samples=samples, rng=rng, device=device)
    if func is not None:
        for b in bundles:
            b.curves = func(b.curves)

    fig, axes, n_out = _resolve_axes(bartrv, len(var_idx), grid, sharey,
                                     figsize, ax)

    panel = 0
    panel_means = []
    for b in bundles:
        for out in range(n_out):
            draws = b.curves[:, :, out]  # (samples, g)
            panel_means.append(draws.mean())
            target = axes[panel]
            if b.var in discrete:
                _, first = np.unique(b.xs, return_index=True)
                centers = draws.mean(0)[first]
                band = hdi(draws, prob=DEFAULT_CI_PROB, axis=0)[first]
                target.errorbar(
                    b.xs[first], centers,
                    (centers - band[:, 0], band[:, 1] - centers),
                    fmt=".", color=color)
                target.set_xticks(b.xs[first])
            else:
                _credible_band(target, b.xs, draws, smooth, smooth_kwargs,
                               color, alpha)
                if smooth:
                    gx, gy = _smooth_on_grid(b.xs, draws.mean(0),
                                             smooth_kwargs)
                    target.plot(gx, gy, color=color_mean)
                else:
                    order = np.argsort(b.xs)
                    target.plot(b.xs[order], draws.mean(0)[order],
                                color=color_mean)
            target.set_xlabel(labels[b.var])
            panel += 1

    if ref_line and panel_means:
        level = float(np.mean(panel_means))
        for target in axes:
            target.axhline(level, color="0.7", linestyle="--")

    fig.text(-0.05, 0.5, _response_label(Y), va="center",
             rotation="vertical", fontsize=15)
    return axes


def plot_ice(
    bartrv,
    X,
    Y=None,
    var_idx=None,
    var_discrete=None,
    func: Optional[Callable] = None,
    centered: bool = True,
    samples: int = 100,
    instances: int = 30,
    random_seed: Optional[int] = None,
    sharey: bool = True,
    smooth: bool = True,
    grid: str = "long",
    color="C0",
    color_mean: str = "C0",
    alpha: float = 0.1,
    figsize=None,
    smooth_kwargs: Optional[Dict[str, Any]] = None,
    ax=None,
    device=None,
):
    """Individual conditional expectation plot (capability parity:
    reference ``utils.py:134-275``; curves from ``interpret.ice``, which
    batches all instances into one predict call, on ``device``)."""
    X, col_names = as_matrix(X)
    var_idx = list(var_idx) if var_idx is not None else list(range(X.shape[1]))
    discrete = set(var_discrete or [])
    labels = _axis_labels(col_names, var_idx)
    rng = np.random.default_rng(random_seed)

    bundles = ice(_posterior_store(bartrv), X, var_idx, instances=instances,
                  samples=samples, rng=rng, centered=False, device=device)
    if func is not None:
        for b in bundles:
            b.curves = func(b.curves)

    fig, axes, n_out = _resolve_axes(bartrv, len(var_idx), grid, sharey,
                                     figsize, ax)

    panel = 0
    for b in bundles:
        for out in range(n_out):
            curves = b.curves[:, :, out]  # (instances, g)
            if centered:
                curves = curves - curves[:, :1]
            target = axes[panel]
            if b.var in discrete:
                target.plot(b.xs, curves.mean(0), "o", color=color_mean)
                target.plot(b.xs, curves.T, ".", color=color, alpha=alpha)
            elif smooth:
                gx, gy = _smooth_on_grid(b.xs, curves.T, smooth_kwargs)
                target.plot(gx, gy.mean(1), color=color_mean)
                target.plot(gx, gy, color=color, alpha=alpha)
            else:
                order = np.argsort(b.xs)
                target.plot(b.xs[order], curves.mean(0)[order],
                            color=color_mean)
                target.plot(b.xs[order], curves.T[order], color=color,
                            alpha=alpha)
            target.set_xlabel(labels[b.var])
            panel += 1

    fig.text(-0.05, 0.5, _response_label(Y), va="center",
             rotation="vertical", fontsize=15)
    return axes
