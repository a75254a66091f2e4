"""Multi-output heteroscedastic BART: shape=(2, n) for mean and scale
(BASELINE config 4), on the PyTorch/CUDA port (``pymc_bart_tpu_torch``).

The same data, seed, model and budget as ``examples/heteroscedastic.py``.

Run on a CUDA device: python examples/port/heteroscedastic.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))

import numpy as np

import pymc_bart_tpu_torch as pmb


def main(device=None):
    """Fit mean and scale; returns ``corr_mean_output`` (the mean output
    against the true mean) and the mean |scale| where the true sd is high
    (``scale_hi``) and low (``scale_lo``).  ``device``: None runs on the
    CUDA device, ``"cpu"`` on the CPU."""
    rng = np.random.default_rng(0)
    n = 300
    X = rng.uniform(-1, 1, size=(n, 2))
    mu_true = 3 * np.sin(2 * X[:, 0])
    sd_true = 0.2 + 1.5 * (X[:, 1] > 0)
    Y = rng.normal(mu_true, sd_true)

    with pmb.Model():
        # separate_trees gives each output its own forest, and each forest's
        # step one launch of the whole-step kernel csrc/draw.cu on the card:
        # the mean forest Gaussian with a per-row precision from |w[1]| + c,
        # the scale forest with the het_abs code
        w = pmb.BART("w", X, Y, m=30, shape=(2, n), separate_trees=True)
        pmb.Normal("y", w[0], pmb.math.abs(w[1]) + 0.05, observed=Y)
        idata = pmb.sample(tune=300, draws=300, chains=2, random_seed=0,
                           device=device)

    w_post = idata.posterior["w"].values.mean(axis=(0, 1))
    corr = float(np.corrcoef(w_post[0], mu_true)[0, 1])
    hi = float(np.abs(w_post[1])[X[:, 1] > 0].mean())
    lo = float(np.abs(w_post[1])[X[:, 1] <= 0].mean())
    print("corr(mean output, true mean):", round(corr, 3))
    print("mean |scale| where sd_true high:", round(hi, 3),
          "low:", round(lo, 3))
    return {"corr_mean_output": corr, "scale_hi": hi, "scale_lo": lo}


if __name__ == "__main__":
    main()
