"""Friedman #1 (Friedman 1991, Ann. Statist. 19(1), "Multivariate adaptive
regression splines"; the benchmark function of Chipman, George & McCulloch
2010, Ann. Appl. Stat. 4(1), "BART", sections 5-6).

A frozen copy of the repository's ``bench.py::friedman``: X uniform on
[0, 1]^p, the true function of the first five columns, Gaussian noise."""

import numpy as np


def true_f(X):
    """The noise-free response of the rows of ``X`` (float64)."""
    X = np.asarray(X, np.float64)
    return (10 * np.sin(np.pi * X[:, 0] * X[:, 1])
            + 20 * (X[:, 2] - 0.5) ** 2 + 10 * X[:, 3] + 5 * X[:, 4])


def generate(n, p, seed, noise_sd=1.0):
    """``(X float32 (n, p), Y float32 (n,), f float64 (n,))`` from one
    NumPy generator seeded with ``seed``, drawn in ``bench.py``'s order."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    f = true_f(X)
    Y = (f + rng.normal(0, noise_sd, n)).astype(np.float32)
    return X, Y, f
