"""The large-n classification data of the repository's
``bench.py::config_large_n_logistic``: X uniform on [0, 1]^p, the true logit
``4 sin(pi x0 x1) + 4 x3 - 2`` and a Bernoulli label of its sigmoid (the
classifier of Chipman, George & McCulloch 2010, Ann. Appl. Stat. 4(1),
"BART", section 4; pymc-bart's ``Bernoulli(p=sigmoid(BART))``)."""

import numpy as np


def true_f(X):
    """The true logit of the rows of ``X`` (float64)."""
    X = np.asarray(X, np.float64)
    return 4 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 4 * X[:, 3] - 2


def generate(n, p, seed):
    """``(X float32 (n, p), Y float32 (n,) in {0, 1}, f float64 (n,))``, f
    the true logit, from one NumPy generator seeded with ``seed``, drawn in
    ``bench.py``'s order."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    f = true_f(X)
    Y = rng.binomial(1, 1 / (1 + np.exp(-f))).astype(np.float32)
    return X, Y, f
