"""Gaussian BART regression on the Friedman-5 benchmark (BASELINE config 1),
on the PyTorch/CUDA port (``pymc_bart_tpu_torch``).

The same data, seeds, model and budget as
``examples/friedman_regression.py``.  Every PGBART step is one launch of the
whole-step kernel ``csrc/draw.cu`` (Gaussian code); sigma is updated by
NUTS.

Run on a CUDA device: python examples/port/friedman_regression.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))

import numpy as np

import pymc_bart_tpu_torch as pmb


def main(device=None):
    """Fit Friedman-5; returns ``rmse`` (against the true function),
    ``sigma`` (posterior mean), ``inclusion`` (the five covariates of
    highest inclusion, in order) and ``inclusion_share`` (their shares).  ``device``: None runs
    on the CUDA device, ``"cpu"`` on the CPU."""
    rng = np.random.default_rng(0)
    n, p = 500, 10
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
        idata = pmb.sample(tune=300, draws=300, chains=4, random_seed=0,
                           progressbar=True, device=device)

    fhat = idata.posterior["mu"].values.mean(axis=(0, 1))
    rmse = float(np.sqrt(np.mean((fhat - f_true) ** 2)))
    sigma_mean = float(idata.posterior["sigma"].values.mean())
    print(f"RMSE vs true function: {rmse:.3f} (noise sd 1.0)")
    print(f"sigma posterior mean:  {sigma_mean:.3f}")

    vi_norm, labels = pmb.get_variable_inclusion(idata, X)
    inclusion = dict(zip(labels[:5], np.asarray(vi_norm[:5]).round(3)))
    print("variable inclusion (sorted):", inclusion)
    return {"rmse": rmse, "sigma": sigma_mean,
            "inclusion": [str(k) for k in inclusion],
            "inclusion_share": [float(v) for v in inclusion.values()]}


if __name__ == "__main__":
    main()
