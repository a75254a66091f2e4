"""Posterior tree storage.

Counterpart of ``pymc_bart_tpu/utils/posterior.py``: the ``PosteriorForests``
container that ``sample()`` attaches to a fitted BART RV.  The prediction
functions (``predict_draw_indices``, ``sample_posterior``) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import BartConfig


@dataclasses.dataclass
class PosteriorForests:
    """All sampled forests of one BART RV: arrays (chains, draws, m, S[, k]).

    This is the ``all_trees`` equivalent attached to a fitted BART RV.
    ``split_set`` is ``uint32``, as in the JAX package's container.
    """

    split_var: np.ndarray
    split_val: np.ndarray
    split_set: np.ndarray
    leaf: np.ndarray
    count: np.ndarray
    slope: np.ndarray
    config: BartConfig
    rules: np.ndarray  # int32[p]
    X_train: np.ndarray

    @property
    def n_chains(self) -> int:
        return self.split_var.shape[0]

    @property
    def n_draws(self) -> int:
        return self.split_var.shape[1]

    @property
    def n_total(self) -> int:
        return self.n_chains * self.n_draws

    @property
    def n_outputs(self) -> int:
        return self.leaf.shape[-1]

    def flat(self) -> "PosteriorForests":
        """Merge (chains, draws) into one draw axis."""
        def f(a):
            return a.reshape((-1,) + a.shape[2:])
        return dataclasses.replace(
            self, split_var=f(self.split_var), split_val=f(self.split_val),
            split_set=f(self.split_set), leaf=f(self.leaf), count=f(self.count),
            slope=f(self.slope),
        )
