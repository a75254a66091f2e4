"""Out-of-sample prediction via mutable Data containers (the reference's
pm.Data/set_data contract), on the PyTorch/CUDA port
(``pymc_bart_tpu_torch``).

The same data, seed, model and budget as ``examples/out_of_sample.py``.
Each PGBART step is one launch of the whole-step kernel ``csrc/draw.cu``
(Gaussian code); the predictions on the new rows run on the same device.

Run on a CUDA device: python examples/port/out_of_sample.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))

import numpy as np

import pymc_bart_tpu_torch as pmb


def main(device=None):
    """Fit, then predict 50 new rows; returns ``rmse`` of the predicted mean
    against the true function there and ``std_f_test``, the spread of that
    function.  ``device``: None runs on the CUDA device, ``"cpu"`` on the
    CPU."""
    rng = np.random.default_rng(0)
    n = 200
    X = rng.uniform(-2, 2, size=(n, 3))
    f = np.sin(X[:, 0]) * 3 + X[:, 1] ** 2
    Y = f + rng.normal(0, 0.3, n)

    X_test = rng.uniform(-2, 2, size=(50, 3))
    f_test = np.sin(X_test[:, 0]) * 3 + X_test[:, 1] ** 2

    with pmb.Model():
        xd = pmb.Data("xd", X)
        mu = pmb.BART("mu", xd, Y, m=30)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)
        idata = pmb.sample(tune=300, draws=300, chains=2, random_seed=0,
                           device=device)

        pmb.set_data({"xd": X_test})
        ppc = pmb.sample_posterior_predictive(
            idata, sample_vars=["mu", "y"], extend_inferencedata=False,
            device=device)

    mu_test = ppc.posterior_predictive["mu"].values.mean(axis=(0, 1))
    rmse = float(np.sqrt(np.mean((mu_test - f_test) ** 2)))
    print(f"out-of-sample RMSE: {rmse:.3f} (noise sd 0.3)")
    return {"rmse": rmse, "std_f_test": float(np.std(f_test))}


if __name__ == "__main__":
    main()
