"""Posterior tree storage and the sum-of-trees prediction of stored draws.

Counterpart of ``pymc_bart_tpu/utils/posterior.py``: the ``PosteriorForests``
container that ``sample()`` attaches to a fitted BART RV (a list of them, one
per output, for a ``separate_trees`` variable), and the prediction of chosen
draws on any X (``predict_draw_indices``, ``sample_posterior``) with
``ops/predict.py`` on the card, also under several exclusion masks at once
(``predict_draw_indices(..., masks=)``, every PDP panel in one batched
pass; JAX's ``predict_draw_indices_multimask``).
Draw indices come from the caller's NumPy ``Generator``, as in the JAX
package, so one seed picks the same draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import BartConfig
from ..ops.predict import forest_predict, forest_predict_excluded
from ..ops.trees import Forest, rules_all_continuous

# rows x trees x draws of one prediction pass: bounds the (draws, m, n)
# index tensors of the traversal (the excluded path also times the slots)
_PASS_ELEMENTS = 2**24


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

    def select(self, idx: np.ndarray, device="cpu") -> Forest:
        """Gather draws by flat index into a stacked Forest (len(idx), m, S)
        on ``device`` (``split_set`` as its int32 bit pattern)."""
        src = self.flat() if self.split_var.ndim == 4 else self

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a[idx])).to(device)

        return Forest(t(src.split_var), t(src.split_val),
                      t(src.split_set.view(np.int32)), t(src.leaf),
                      t(src.count), t(src.slope))


def predict_draw_indices(all_trees: PosteriorForests, X, idx,
                         excluded: Optional[Sequence[int]] = None,
                         device=None, masks=None) -> np.ndarray:
    """Predictions of specific flat draw indices: (len(idx), n, k).

    ``excluded``: covariates integrated out of the routing
    (``ops.predict.forest_predict_excluded``).  ``masks``: bool (M, p)
    exclusion masks (True = integrated out) in place of ``excluded``; every
    mask goes through one batched pass (the stored draws gain a mask axis)
    and the result is (M, len(idx), n, k).  Passes are chunked over masks
    and draws to stay under ``_PASS_ELEMENTS`` index entries.
    ``device=None`` runs on the GPU (and raises where there is none);
    ``"cpu"`` on the CPU."""
    from ..sampler.compound import resolve_device

    device = resolve_device(device)
    X = torch.as_tensor(np.ascontiguousarray(np.asarray(X, np.float32)),
                        device=device)
    rules_np = np.asarray(all_trees.rules, np.int32)
    rules = torch.as_tensor(rules_np, device=device)
    all_cont = rules_all_continuous(rules_np)       # read here, on the host
    idx = np.asarray(idx)
    depth = all_trees.config.max_depth
    n, p = X.shape
    k = all_trees.n_outputs
    many = masks is not None
    if not many and excluded is not None and len(excluded) > 0:
        masks = np.zeros((1, p), bool)
        masks[0, np.asarray(excluded, int)] = True
    per_pass = all_trees.split_var.shape[-2] * n      # one mask, one draw
    if masks is not None:
        masks = torch.as_tensor(np.asarray(masks, bool), device=device)
        per_pass *= 2**depth
    M = 1 if masks is None else masks.shape[0]
    m_chunk = max(1, min(M, _PASS_ELEMENTS // per_pass))
    d_chunk = max(1, _PASS_ELEMENTS // (per_pass * m_chunk))
    out = torch.empty((M, len(idx), n, k), dtype=torch.float32,
                      device=device)
    for lo in range(0, len(idx), d_chunk):
        sel = all_trees.select(idx[lo:lo + d_chunk], device)
        if masks is None:
            out[0, lo:lo + d_chunk] = forest_predict(sel, X, rules, depth,
                                                     all_cont=all_cont)
            continue
        for mlo in range(0, M, m_chunk):
            mk = masks[mlo:mlo + m_chunk]
            batched = Forest(*(
                getattr(sel, f.name)[None].expand(
                    (mk.shape[0],) + getattr(sel, f.name).shape)
                for f in dataclasses.fields(sel)))
            out[mlo:mlo + m_chunk, lo:lo + d_chunk] = forest_predict_excluded(
                batched, X, rules, mk, depth, all_cont=all_cont)
    out = out.cpu().numpy()
    return out if many else out[0]


def sample_posterior(all_trees, X, rng=None, size=None,
                     excluded: Optional[Sequence[int]] = None,
                     device=None) -> np.ndarray:
    """Samples from the BART posterior: draw indices chosen uniformly at
    random from the stored draws by ``rng`` (a NumPy ``Generator``), the
    result shaped ``(*size, n_obs, n_outputs)``.  ``all_trees`` is one
    ``PosteriorForests`` or a list of them, one per output (an output's
    draws are chosen independently, in list order)."""
    if rng is None:
        rng = np.random.default_rng()
    if size is None:
        size_iter = ()
    elif isinstance(size, int):
        size_iter = (size,)
    else:
        size_iter = tuple(size)
    flatten_size = int(np.prod(size_iter)) if size_iter else 1

    if isinstance(all_trees, (list, tuple)):
        parts = []
        for pf in all_trees:
            idx = rng.integers(0, pf.n_total, size=flatten_size)
            pred = predict_draw_indices(pf, X, idx, excluded, device)
            parts.append(pred[..., 0])
        stacked = np.stack(parts, axis=-1)             # (fs, n, n_out)
        return stacked.reshape((*size_iter, -1, len(all_trees)))

    idx = rng.integers(0, all_trees.n_total, size=flatten_size)
    pred = predict_draw_indices(all_trees, X, idx, excluded, device)
    return pred.reshape((*size_iter, -1, all_trees.n_outputs))
