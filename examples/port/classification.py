"""Binary and 3-class classification with BART (BASELINE config 3 and the
reference's categorical-hawks pattern), on the PyTorch/CUDA port
(``pymc_bart_tpu_torch``).

The same data, seeds, models and budgets as ``examples/classification.py``.

Run on a CUDA device: python examples/port/classification.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))

import numpy as np

import pymc_bart_tpu_torch as pmb


def _majority_rate(labels):
    return float(np.bincount(labels.astype(int)).max() / len(labels))


def binary(device=None):
    """Bernoulli(sigmoid(BART)): each PGBART step is one launch of the
    whole-step kernel ``csrc/draw.cu`` (Bernoulli code).  Returns the train
    ``accuracy``, the ``majority_rate`` and the Bayes rule's ``bayes_rate``.
    ``device``: None runs on the CUDA device, ``"cpu"`` on the CPU."""
    rng = np.random.default_rng(0)
    n = 300
    X = rng.normal(size=(n, 4))
    p_true = 1 / (1 + np.exp(-(2 * X[:, 0] - 1.5 * X[:, 1])))
    Y = rng.binomial(1, p_true).astype(float)

    with pmb.Model():
        lo = pmb.BART("lo", X, Y, m=25)
        pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=Y)
        idata = pmb.sample(tune=300, draws=300, chains=2, random_seed=1,
                           device=device)

    lo_hat = idata.posterior["lo"].values.mean(axis=(0, 1))
    acc = float(((lo_hat > 0) == (Y > 0.5)).mean())
    bayes = float(np.maximum(p_true, 1 - p_true).mean())
    majority = _majority_rate(Y)
    print(f"binary: train accuracy {acc:.3f} "
          f"(Bayes ~{bayes:.3f}, majority class {majority:.3f})")
    return {"accuracy": acc, "majority_rate": majority, "bayes_rate": bayes}


def categorical(device=None):
    """Categorical(softmax(BART.T)) with one forest a class.  Returns the
    train ``accuracy`` and the ``majority_rate``.  ``device``: None runs on
    the CUDA device, ``"cpu"`` on the CPU."""
    rng = np.random.default_rng(1)
    n, n_class = 120, 3
    X = rng.normal(size=(n, 4))
    logits = np.stack([2 * X[:, 0], 2 * X[:, 1], -X[:, 0] - X[:, 1]], axis=1)
    Y = np.array([rng.choice(n_class, p=np.exp(l) / np.exp(l).sum())
                  for l in logits]).astype(float)

    with pmb.Model():
        # separate_trees gives each class its own forest, and each forest's
        # step one launch of the whole-step kernel csrc/draw.cu with the
        # cat_logit code on the card
        lo = pmb.BART("logodds", X, Y, m=10, shape=(n_class, n),
                      separate_trees=True)
        pmb.Categorical("y", p=pmb.math.softmax(lo.T, axis=-1), observed=Y)
        idata = pmb.sample(tune=300, draws=300, chains=1, random_seed=2,
                           batch=(0.5, 0.5), device=device)

    post = idata.posterior["logodds"].values.mean(axis=(0, 1))  # (3, n)
    acc = float((post.argmax(axis=0) == Y).mean())
    majority = _majority_rate(Y)
    print(f"categorical: train accuracy {acc:.3f} "
          f"(majority class {majority:.3f})")
    return {"accuracy": acc, "majority_rate": majority}


if __name__ == "__main__":
    binary()
    categorical()
