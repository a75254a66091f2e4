"""Variable inclusion and variable importance.

Counterpart of ``pymc_bart_tpu/utils/importance.py``: the variable-selection
toolkit (get_variable_inclusion, plot_variable_inclusion,
compute_variable_importance, vi_to_kulprit, plot_variable_importance,
plot_scatter_submodels — reference ``pymc_bart/utils.py``), built on the
``interpret.SubmodelScorer`` data layer: one cached full-model
prediction, every submodel scored by vectorized paired R^2 against it,
exclusion integrated out on the card (``device=None``; ``"cpu"`` on the
CPU) by count-weighted traversal.  ``matplotlib`` is imported inside the
plotting functions only.

The inclusion statistic is stored natively as int arrays (chain, draw,
bart_var, covariate); the reference's base64-varint string wire format
(produced by its native sampler) is also accepted and decoded.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .codec import decode_vi, encode_vi
from .interpret import SubmodelScorer, as_matrix, paired_r2
from .stats import DEFAULT_CI_PROB, hdi


# ---------------------------------------------------------------------------
# inclusion counts
# ---------------------------------------------------------------------------


def _inclusion_matrix(idata, n_vars: int, model=None, bart_var_name=None,
                      bart_var_names: Optional[Sequence[str]] = None
                      ) -> np.ndarray:
    """Per-draw inclusion counts, flattened to (total_draws, n_vars).

    Handles the native 4-D int layout (chain, draw, bart_var, covariate)
    and the reference's per-draw base64-varint strings.
    """
    da = idata["sample_stats"]["variable_inclusion"]
    vals = np.asarray(getattr(da, "values", da))

    if vals.dtype.kind in "OUS":  # reference string wire format
        return np.array([decode_vi(str(s), n_vars) for s in vals.ravel()])

    if vals.ndim == 4 and vals.shape[2] > 1:
        if bart_var_names:
            order = [b.name for b in model.bart_rvs]
            picks = [vals[:, :, order.index(nm), :n_vars]
                     for nm in bart_var_names]
            return sum(p.reshape(-1, n_vars) for p in picks)
        if model is None or bart_var_name is None:
            raise ValueError(
                "The InferenceData was generated from a model with "
                "multiple BART variables, please provide the model and "
                "the name of the BART variable for which you want to "
                "compute the variable inclusion."
            )
        which = [b.name for b in model.bart_rvs].index(bart_var_name)
        vals = vals[:, :, which, :]
    elif vals.ndim == 4:
        vals = vals[:, :, 0, :]
    return vals.reshape(-1, vals.shape[-1])[:, :n_vars]


def export_variable_inclusion(idata, model=None, bart_var_name=None,
                              inplace: bool = False) -> np.ndarray:
    """Emit the reference's ``sample_stats`` wire format: one base64-varint
    string per (chain, draw) of per-covariate split counts (reference
    utils.py:750-762 consuming what its native sampler emits per draw,
    encoded per utils.py:1343-1373).

    The native layout here is a 4-D int array; this converts it so
    reference-tooling consumers (or a reference-produced-InferenceData
    comparison) can read the stats.  Returns an object array of shape
    (chain, draw); with ``inplace=True`` it is also attached to
    ``idata.sample_stats`` as ``variable_inclusion_encoded``.
    """
    da = idata["sample_stats"]["variable_inclusion"]
    vals = np.asarray(getattr(da, "values", da))
    if vals.dtype.kind in "OUS":
        out = vals.reshape(vals.shape[:2]).astype(object)
    else:
        if vals.ndim == 4 and vals.shape[2] > 1:
            if model is None or bart_var_name is None:
                raise ValueError(
                    "multiple BART variables: provide model= and "
                    "bart_var_name= to select which forest to export")
            which = [b.name for b in model.bart_rvs].index(bart_var_name)
            vals = vals[:, :, which, :]
        elif vals.ndim == 4:
            vals = vals[:, :, 0, :]
        chains, draws = vals.shape[:2]
        out = np.empty((chains, draws), object)
        for c in range(chains):
            for d in range(draws):
                out[c, d] = encode_vi(vals[c, d])
    if inplace:
        from ..models.inference_data import DataArray

        idata["sample_stats"]["variable_inclusion_encoded"] = DataArray(
            out, ["chain", "draw"], name="variable_inclusion_encoded")
    return out


def get_variable_inclusion(idata, X, model=None, bart_var_name=None,
                           labels=None, to_kulprit: bool = False):
    """Normalized per-covariate inclusion frequencies, sorted descending.

    With ``to_kulprit=True`` returns the nested submodel label paths for
    Kulprit's projection workflow instead.
    """
    X_arr, col_names = as_matrix(X)
    n_vars = X_arr.shape[1]
    totals = _inclusion_matrix(idata, n_vars, model, bart_var_name).sum(0)
    grand = totals.sum()
    share = totals / grand if grand > 0 else np.full(n_vars, 1.0 / n_vars)
    order = np.argsort(share)[::-1]

    if labels is None:
        labels = ([col_names[i] for i in order] if col_names
                  else [str(i) for i in order])

    if to_kulprit:
        return [labels[:j] for j in range(n_vars + 1)]
    return share[order], labels


def plot_variable_inclusion(idata, X, labels=None, figsize=None,
                            plot_kwargs=None, ax=None):
    """Line plot of normalized inclusion with a uniform reference line."""
    import matplotlib.pyplot as plt

    opts = plot_kwargs or {}
    share, labels = get_variable_inclusion(idata, X, labels=labels)
    n_vars = len(labels)

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize or (8, 3))
    ax.axhline(1 / n_vars, color="0.5", linestyle="--")
    ax.plot(share, color=opts.get("color", "k"),
            marker=opts.get("marker", "o"), ls=opts.get("ls", "-"))
    ax.set_xticks(np.arange(n_vars),
                  _cumulative_labels(labels),
                  rotation=opts.get("rotation", 0))
    ax.set_ylim(0, 1)
    return ax


def _cumulative_labels(names) -> List[str]:
    """['a', 'b', 'c'] -> ['a', '+ b', '+ c'] (nested-submodel style)."""
    return [nm if i == 0 else f"+ {nm}" for i, nm in enumerate(names)]


# ---------------------------------------------------------------------------
# variable importance
# ---------------------------------------------------------------------------


def generate_sequences(n_vars, i_var, include):
    """All exclusion sets formed by adding one variable to ``include``
    (kept for reference API parity; the backward search below uses
    ``SubmodelScorer`` directly)."""
    if i_var:
        return [tuple(include + [i]) for i in range(n_vars) if i not in include]
    return [()]


def _rank_descending(idata, n_vars, model, bart_var_names) -> np.ndarray:
    single = bart_var_names[0] if len(bart_var_names) == 1 else None
    many = bart_var_names if len(bart_var_names) > 1 else None
    totals = _inclusion_matrix(idata, n_vars, model, single,
                               bart_var_names=many).sum(axis=0)
    return np.argsort(totals)[::-1]


def _backward_sweep(scorer: SubmodelScorer, active: List[int],
                    sizes_down_to: int):
    """Backward elimination from ``active`` down to ``sizes_down_to``
    variables: at each step drop the variable whose removal keeps R^2
    highest.  Returns (rows descending by size, drop order)."""
    rows = []
    dropped = []
    while len(active) > sizes_down_to:
        best = None
        for cand in active:
            trial = scorer.score([v for v in active if v != cand])
            if best is None or trial.r2.mean() > best[1].r2.mean():
                best = (cand, trial)
        cand, row = best
        active.remove(cand)
        dropped.append(cand)
        rows.append(row)
    return rows, dropped


def compute_variable_importance(
    idata: Any,
    bartrv,
    X,
    model=None,
    method: str = "VI",
    fixed: int = 0,
    samples: int = 50,
    random_seed: Optional[int] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Rank covariates and score nested submodels against the full model.

    method:
      * ``"VI"`` — rank by inclusion counts; score the nested top-j sets.
      * ``"backward"`` — full backward elimination (O(p^2) submodels).
      * ``"backward_VI"`` — pin the ``fixed`` least-included covariates
        as never-kept, VI-score the largest ``fixed+1`` submodels,
        backward-search the rest.

    Returns dict(indices, labels, r2_mean, r2_hdi, preds, preds_all) —
    submodels ordered from smallest (1 covariate) to largest (all).
    ``device=None`` predicts on the GPU, ``"cpu"`` on the CPU.
    """
    if method not in ("VI", "backward", "backward_VI"):
        raise ValueError("method must be 'VI', 'backward' or 'backward_VI'")

    if isinstance(bartrv, list):
        if not all(len(rv.shape) == 1 for rv in bartrv):
            raise ValueError("List inputs must contain only 1D BART variables")
        all_trees: Any = [rv.all_trees for rv in bartrv]
        bart_var_names = [rv.name for rv in bartrv]
    else:
        all_trees = bartrv.all_trees
        bart_var_names = [bartrv.name]

    X_arr, col_names = as_matrix(X)
    n_vars = X_arr.shape[1]
    names = np.asarray(col_names if col_names
                       else np.arange(n_vars).astype(str))

    rng = np.random.default_rng(random_seed)
    scorer = SubmodelScorer(all_trees, X_arr, samples, rng, device)

    # rows[j] = SubmodelScore of the submodel with j+1 covariates
    if method == "VI":
        order = _rank_descending(idata, n_vars, model, bart_var_names)
        rows = [scorer.score(order[:j + 1]) for j in range(n_vars)]
        indices = list(order)

    elif method == "backward":
        survivors = list(range(n_vars))
        down = [scorer.score(survivors)]  # full model first
        swept, dropped = _backward_sweep(scorer, survivors, 1)
        down += swept
        rows = down[::-1]
        indices = survivors[::-1] + dropped[::-1]

    else:  # backward_VI
        if not 0 < fixed < n_vars:
            raise ValueError(
                "fixed must be greater than 0 and less than the number "
                "of variables")
        order = _rank_descending(idata, n_vars, model, bart_var_names)
        pinned_out = list(order[n_vars - fixed:])  # least included
        # VI part: the fixed+1 largest submodels
        vi_rows = [scorer.score(order[:j + 1])
                   for j in range(n_vars - fixed - 1, n_vars)]
        # backward part over the remaining candidates
        survivors = [v for v in range(n_vars) if v not in pinned_out]
        swept, dropped = _backward_sweep(scorer, survivors, 1)
        rows = swept[::-1] + vi_rows
        indices = survivors[::-1] + dropped[::-1] + pinned_out

    r2_mean = np.array([row.r2.mean() for row in rows])
    r2_hdi_ = np.array([hdi(row.r2, prob=DEFAULT_CI_PROB) for row in rows])
    preds = np.stack([row.preds for row in rows])

    return {
        "indices": np.asarray(indices),
        "labels": np.array(_cumulative_labels(names[indices])),
        "r2_mean": r2_mean,
        "r2_hdi": r2_hdi_,
        "preds": preds.squeeze(),
        "preds_all": scorer.full.squeeze(),
    }


def vi_to_kulprit(vi_results: dict) -> List[List[str]]:
    """Export importance results as Kulprit nested submodel paths."""
    clean = [label.strip("+ ") for label in vi_results["labels"]]
    return [clean[:j] for j in range(len(clean))]


# ---------------------------------------------------------------------------
# importance rendering
# ---------------------------------------------------------------------------


def _pick_submodels(vi_results, submodels):
    chosen = np.sort(vi_results["indices"] if submodels is None
                     else np.asarray(submodels))
    return chosen


def plot_variable_importance(vi_results: dict, submodels=None, labels=None,
                             figsize=None, plot_kwargs=None, ax=None):
    """Submodel R^2 errorbars with the full-model self-agreement band.

    The reference band is the R^2 between successive full-model
    prediction samples — the ceiling any submodel can reach.
    """
    import matplotlib.pyplot as plt

    chosen = _pick_submodels(vi_results, submodels)
    r2_mean = vi_results["r2_mean"][chosen]
    r2_hdi_ = vi_results["r2_hdi"][chosen]
    full = vi_results["preds_all"]
    if labels is None:
        labels = vi_results["labels"][chosen]
    n_shown = len(chosen)
    opts = plot_kwargs or {}

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize or (8, 3))

    ceiling = paired_r2(full[:-1], full[1:])
    err_lo = np.clip(r2_mean - r2_hdi_[:, 0], 0, None)
    err_hi = np.clip(r2_hdi_[:, 1] - r2_mean, 0, None)
    ticks = np.arange(n_shown)

    ax.errorbar(ticks, r2_mean, np.array((err_lo, err_hi)),
                color=opts.get("color_r2", "k"),
                fmt=opts.get("marker_r2", "o"),
                mfc=opts.get("marker_fc_r2", "white"))
    ax.axhline(ceiling.mean(), ls=opts.get("ls_ref", "--"),
               color=opts.get("color_ref", "grey"))
    ax.fill_between([-0.5, n_shown - 0.5],
                    *hdi(ceiling, prob=DEFAULT_CI_PROB),
                    alpha=0.1, color=opts.get("color_ref", "grey"))
    ax.set_xticks(ticks, labels, rotation=opts.get("rotation", 0))
    ax.set_ylabel("R²", rotation=0, labelpad=12)
    ax.set_ylim(0, 1)
    ax.set_xlim(-0.5, n_shown - 0.5)
    return ax


def plot_scatter_submodels(vi_results: dict, func=None, submodels=None,
                           grid: str = "long", labels=None, figsize=None,
                           plot_kwargs=None, ax=None):
    """Scatter each submodel's predictions against the full model's, with
    a 45-degree reference; categorical (3-D) predictions get one panel
    row per category."""
    from .plots import _panel_grid

    chosen = _pick_submodels(vi_results, submodels)
    sub = vi_results["preds"][chosen]
    full = vi_results["preds_all"]
    if labels is None:
        labels = vi_results["labels"][chosen]
    if func is not None:
        sub, full = func(sub), func(full)
    opts = plot_kwargs or {}

    n_cats = full.shape[-1] if full.ndim > 2 else None
    n_panels = len(chosen) * (n_cats or 1)
    if ax is None:
        _, axes = _panel_grid(grid, n_panels, True, True, figsize)
    else:
        axes = list(np.ravel(ax))

    lo = min(float(np.min(sub)), float(np.min(full)))
    hi = max(float(np.max(sub)), float(np.max(full)))

    def _one(axis, x, y, x_label, color, title=None):
        axis.plot(x, y, marker=opts.get("marker_scatter", "."), ls="",
                  color=color, alpha=opts.get("alpha_scatter", 0.1))
        axis.set(xlabel=x_label, ylabel="ref model")
        if title:
            axis.set_title(title)
        axis.axline([lo, lo], [hi, hi], color=opts.get("color_ref", "0.5"),
                    ls=opts.get("ls_ref", "--"))

    if n_cats is None:
        for axis, preds, x_label in zip(axes, sub, labels):
            _one(axis, preds, full, x_label,
                 opts.get("color_scatter", "C0"))
    else:
        panel = 0
        for cat in range(n_cats):
            for preds, x_label in zip(sub, labels):
                _one(axes[panel], preds[..., cat], full[..., cat], x_label,
                     opts.get("color_scatter", f"C{cat}"),
                     title=f"Category {cat}")
                panel += 1
    return axes
