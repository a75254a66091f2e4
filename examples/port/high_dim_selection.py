"""High-dimensional variable selection (BASELINE config 5), on the
PyTorch/CUDA port (``pymc_bart_tpu_torch``).

Sparse signal in p=1000 covariates: only the first 5 columns matter.  The
same data, seed, model and budget as ``examples/high_dim_selection.py``:
PGBART's tuning-phase split-prior adaptation and the variable-inclusion
statistic recover the active set; PDP and ICE plots then show the
per-variable effects (where matplotlib is not installed, their curves are
computed and not drawn).  Each PGBART step is one launch of the whole-step
kernel ``csrc/draw.cu`` (its form for wide X); the plots' predictions run
on the same device.

Run on a CUDA device: python examples/port/high_dim_selection.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))

import numpy as np

import pymc_bart_tpu_torch as pmb


def main(device=None):
    """Fit and screen; returns ``top5`` (the five columns of highest
    inclusion, sorted) and ``inclusion_mass`` (the inclusion share of the 5
    active columns).  ``device``: None runs on the CUDA device, ``"cpu"``
    on the CPU."""
    rng = np.random.default_rng(7)
    n, p, k_active = 400, 1000, 5
    X = rng.uniform(size=(n, p))
    f_true = (
        10 * np.sin(np.pi * X[:, 0] * X[:, 1])
        + 20 * (X[:, 2] - 0.5) ** 2
        + 10 * X[:, 3]
        + 5 * X[:, 4]
    )
    Y = f_true + rng.normal(0, 1.0, n)

    with pmb.Model():
        mu = pmb.BART("mu", X, Y, m=50)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)
        idata = pmb.sample(tune=300, draws=300, chains=2, random_seed=0,
                           progressbar=True, device=device)

    vi_norm, labels = pmb.get_variable_inclusion(idata, X)
    cols = np.array([int(str(lbl).split("_")[-1]) for lbl in labels])
    top5 = sorted(cols[:k_active].tolist())
    mass = float(np.asarray(vi_norm)[cols < k_active].sum())
    print("top-5 variables by inclusion:", top5)
    print("inclusion mass on the 5 active columns:", mass)

    # compute_variable_importance on the full p=1000 grid would evaluate
    # ~1000 submodels: at this dimensionality the screening workflow is
    # inclusion ranking (above) followed by refitting a small model on the
    # selected columns; see friedman_regression.py for a low-dimensional
    # problem.

    try:
        import matplotlib
    except ImportError:
        matplotlib = None
    if matplotlib is None:
        # a host without matplotlib: the curves the two plots would draw,
        # computed on the same device
        from pymc_bart_tpu_torch.utils import interpret

        interpret.partial_dependence(mu.all_trees, X, range(k_active),
                                     samples=200, device=device)
        interpret.ice(mu.all_trees, X, [0, 3], instances=30, samples=100,
                      device=device)
        print("PDP/ICE curves computed for the active columns "
              "(matplotlib is not installed: nothing rendered)")
    else:
        matplotlib.use("Agg")
        pmb.plot_pdp(mu, X=X, Y=Y, var_idx=list(range(k_active)),
                     device=device)
        pmb.plot_ice(mu, X=X, Y=Y, var_idx=[0, 3], device=device)
        print("PDP/ICE rendered for the active columns")
    return {"top5": top5, "inclusion_mass": mass}


if __name__ == "__main__":
    main()
