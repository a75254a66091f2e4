"""Coal-mining disasters: BART rate over time with a Poisson likelihood,
on the PyTorch/CUDA port (``pymc_bart_tpu_torch``).

The same data, seeds, model and budget as ``examples/coal_disasters.py``.
The Poisson likelihood has no closed-form code, so every PGBART step takes
the per-round route: the growth kernel ``csrc/grow.cu`` and the resampling
kernel ``csrc/smc.cu`` on the card, the winner and its refinement in plain
PyTorch under the model's own log-likelihood.

Run on a CUDA device: python examples/port/coal_disasters.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))

import numpy as np

import pymc_bart_tpu_torch as pmb

# number of disasters per year, 1851-1962 (Jarrett 1979 / Carlin et al.)
DISASTERS = np.array([
    4, 5, 4, 0, 1, 4, 3, 4, 0, 6, 3, 3, 4, 0, 2, 6, 3, 3, 5, 4, 5, 3, 1,
    4, 4, 1, 5, 5, 3, 4, 2, 5, 2, 2, 3, 4, 2, 1, 3, 2, 2, 1, 1, 1, 1, 3,
    0, 0, 1, 0, 1, 1, 0, 0, 3, 1, 0, 3, 2, 2, 0, 1, 1, 1, 0, 1, 0, 1, 0,
    0, 0, 2, 1, 0, 0, 0, 1, 1, 0, 2, 3, 3, 1, 1, 2, 1, 1, 1, 1, 2, 4, 2,
    0, 0, 0, 1, 4, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 1,
])
YEARS = np.arange(1851, 1963)


def main(n_bins: int = 56, device=None):
    """Fit the rate; returns ``{"early": ..., "late": ...}``, the posterior
    mean rate before 1890 and after 1900.  ``device``: None runs on the
    CUDA device (and raises where there is none), ``"cpu"`` on the CPU."""
    edges = np.linspace(YEARS[0], YEARS[-1] + 1, n_bins + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    counts, _ = np.histogram(np.repeat(YEARS, DISASTERS), bins=edges)
    exposure = np.diff(edges)  # years per bin

    X = centers[:, None]
    Y = counts.astype(float)

    with pmb.Model():
        mu = pmb.BART("mu", X, np.log1p(Y), m=20)
        pmb.Poisson("y", mu=pmb.math.exp(mu) * exposure / exposure.mean(),
                    observed=Y)
        idata = pmb.sample(tune=300, draws=300, chains=2, random_seed=0,
                           device=device)

    rate = np.exp(idata.posterior["mu"].values).mean(axis=(0, 1))
    early = float(rate[centers < 1890].mean())
    late = float(rate[centers > 1900].mean())
    print(f"posterior mean rate before 1890: {early:.2f}, after 1900: {late:.2f}")
    print("expected: a clear drop (~3x) after the 1880s-90s")
    print(pmb.summary(idata))
    return {"early": early, "late": late}


if __name__ == "__main__":
    main()
