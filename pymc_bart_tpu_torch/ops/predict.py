"""Branchless sum-of-trees prediction (PyTorch).

Counterpart of ``pymc_bart_tpu/ops/predict.py`` (fast path only; the
``*_excluded`` interpretability traversals are not ported yet).  Every
function takes any leading batch axes on the tree tensors (chains, trees,
draws) where the JAX package uses ``vmap``: ``D`` rounds of
``node = 2*node + 1 + go_right`` with gathers.

A leaf predicts ``leaf + slope * x[:, parent_split_var]``; slope is zero
for the constant response, so both responses share these functions.
"""

from __future__ import annotations

import torch

from .trees import Forest, decide_left


def _x_at(X: torch.Tensor, var_c: torch.Tensor) -> torch.Tensor:
    """X[i, var_c[..., i]] -> [..., n] for X (n, p)."""
    n = X.shape[0]
    rows = torch.arange(n, device=X.device)
    return X[rows.expand(var_c.shape), var_c]


def tree_leaf_index(split_var, split_val, split_set, X, rules, depth: int):
    """Node slot reached by each row of X after ``depth`` descent rounds.

    split_var/split_val/split_set: [..., S]; X: float32[n, p]; rules int32[p].
    Returns int64[..., n] node slots (for ``depth < max_depth`` the row's
    node in the depth-truncated tree).
    """
    n, p = X.shape
    batch = split_var.shape[:-1]
    idx = torch.zeros(batch + (n,), dtype=torch.int64, device=X.device)
    sv64 = split_var.to(torch.int64)
    for _ in range(depth):
        var = torch.gather(sv64, -1, idx)
        var_c = var.clamp(0, p - 1)
        xv = _x_at(X, var_c)
        left = decide_left(xv, torch.gather(split_val, -1, idx),
                           torch.gather(split_set, -1, idx), rules[var_c])
        child = 2 * idx + 1 + (~left).to(torch.int64)
        idx = torch.where(var >= 0, child, idx)
    return idx


def leaf_values_at(split_var, leaf, slope, X, idx):
    """Leaf response at node slots ``idx`` per row: float32[..., n, k].

    split_var [..., S]; leaf/slope [..., S, k]; idx int64[..., n].
    """
    p = X.shape[1]
    k = leaf.shape[-1]
    idx = idx.to(torch.int64)
    parent = ((idx - 1) // 2).clamp_min(0)
    pvar = torch.gather(split_var.to(torch.int64), -1, parent)
    pvar_c = pvar.clamp(0, p - 1)
    xp = _x_at(X, pvar_c)
    xp = torch.where((idx > 0) & (pvar >= 0), torch.nan_to_num(xp, nan=0.0),
                     torch.zeros_like(xp))
    gidx = idx.unsqueeze(-1).expand(idx.shape + (k,))
    return (torch.gather(leaf, -2, gidx)
            + torch.gather(slope, -2, gidx) * xp.unsqueeze(-1))


def tree_predict(split_var, split_val, split_set, leaf, slope, X, rules,
                 depth: int):
    """Per-tree prediction: float32[..., n, k]."""
    idx = tree_leaf_index(split_var, split_val, split_set, X, rules, depth)
    return leaf_values_at(split_var, leaf, slope, X, idx)


def forest_predict(forest: Forest, X, rules, depth: int | None = None):
    """Sum-of-trees prediction over the m-tree axis: float32[..., n, k]."""
    if depth is None:
        depth = _max_depth_of(forest.split_var.shape[-1])
    per_tree = tree_predict(forest.split_var, forest.split_val,
                            forest.split_set, forest.leaf, forest.slope,
                            X, rules, depth)
    return per_tree.sum(dim=-3)


def _max_depth_of(n_nodes: int) -> int:
    d = 0
    while 2 ** (d + 2) - 1 <= n_nodes:
        d += 1
    return d
