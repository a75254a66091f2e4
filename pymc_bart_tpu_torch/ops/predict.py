"""Branchless sum-of-trees prediction (PyTorch).

Counterpart of ``pymc_bart_tpu/ops/predict.py``.  Every function takes any
leading batch axes on the tree tensors (chains, trees, draws) where the JAX
package uses ``vmap``.  The fast path: ``D`` rounds of
``node = 2*node + 1 + go_right`` with gathers.  The excluded path
(``*_excluded``): level by level, a row's mass flows down the tree, and at a
node that splits on an excluded covariate to both children in proportion to
their training row counts (the reference's fast-PDP semantics).

A leaf predicts ``leaf + slope * x[:, parent_split_var]``; slope is zero
for the constant response, so both responses share these functions.
"""

from __future__ import annotations

import torch

from .trees import Forest, decide_left, level_slots


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


def _x_cols(XT: torch.Tensor, var_c: torch.Tensor) -> torch.Tensor:
    """X[:, var_c[..., g]] -> [..., n, G] for ``XT`` = X transposed (p, n)."""
    return XT[var_c].transpose(-1, -2)


def _excluded_at(excluded_mask, var_c):
    """``excluded_mask[var_c]``; a (M, p) mask gives leading index ``i`` of
    ``var_c`` (M, ..., G) the covariates of mask ``i``."""
    if excluded_mask.dim() == 1:
        return excluded_mask[var_c]
    M, p = excluded_mask.shape
    view = excluded_mask.reshape((M,) + (1,) * (var_c.dim() - 2) + (p,))
    return torch.gather(view.expand(var_c.shape[:-1] + (p,)), -1, var_c)


def tree_predict_excluded(split_var, split_val, split_set, leaf, count, slope,
                          X, rules, excluded_mask, depth: int):
    """Per-tree prediction with the covariates marked in ``excluded_mask``
    (bool[p]) integrated out by row-count-weighted mass propagation:
    float32[..., n, k].  A leaf's linear term still reads the covariate:
    exclusion integrates out routing, not leaf functions.  A (M, p) mask
    holds one exclusion set for each index of the tree tensors' first axis
    (M): every mask in one pass."""
    n, p = X.shape
    batch = split_var.shape[:-1]
    dev = X.device
    XT = X.t()
    out = torch.zeros(batch + (n, leaf.shape[-1]), dtype=torch.float32,
                      device=dev)
    mass = torch.ones(batch + (n, 1), dtype=torch.float32, device=dev)
    for d in range(depth + 1):
        lo, hi = level_slots(d)
        var = split_var[..., lo:hi]                                  # (..., G)
        var_c = var.clamp(0, p - 1).to(torch.int64)
        internal = (var >= 0) & (d < depth)
        slots = torch.arange(lo, hi, device=dev)
        parent = torch.div(slots - 1, 2, rounding_mode="floor").clamp_min(0)
        pvar = split_var[..., parent]
        xp = _x_cols(XT, pvar.clamp(0, p - 1).to(torch.int64))     # (...,n,G)
        xp = torch.where(((slots > 0) & (pvar >= 0)).unsqueeze(-2),
                         torch.nan_to_num(xp, nan=0.0), torch.zeros_like(xp))
        level_vals = (leaf[..., lo:hi, :].unsqueeze(-3)
                      + slope[..., lo:hi, :].unsqueeze(-3) * xp.unsqueeze(-1))
        on_leaf = mass * (~internal).to(torch.float32).unsqueeze(-2)
        out = out + (on_leaf.unsqueeze(-1) * level_vals).sum(-2)
        if d == depth:
            break
        left = decide_left(_x_cols(XT, var_c), split_val[..., lo:hi].unsqueeze(-2),
                           split_set[..., lo:hi].unsqueeze(-2),
                           rules[var_c].unsqueeze(-2))
        cl = count[..., 2 * slots + 1]
        cr = count[..., 2 * slots + 2]
        frac_l = cl / (cl + cr).clamp_min(1e-12)
        excl = _excluded_at(excluded_mask, var_c) & (var >= 0)
        p_left = torch.where(excl.unsqueeze(-2), frac_l.unsqueeze(-2),
                             left.to(torch.float32))
        m_int = mass * internal.to(torch.float32).unsqueeze(-2)
        mass = torch.stack([m_int * p_left, m_int * (1.0 - p_left)],
                           dim=-1).reshape(batch + (n, 2 * (hi - lo)))
    return out


def forest_predict_excluded(forest: Forest, X, rules, excluded_mask,
                            depth: int | None = None):
    """Sum-of-trees prediction with exclusion: float32[..., n, k]."""
    if depth is None:
        depth = _max_depth_of(forest.split_var.shape[-1])
    per_tree = tree_predict_excluded(
        forest.split_var, forest.split_val, forest.split_set, forest.leaf,
        forest.count, forest.slope, X, rules, excluded_mask, depth)
    return per_tree.sum(dim=-3)


def _max_depth_of(n_nodes: int) -> int:
    d = 0
    while 2 ** (d + 2) - 1 <= n_nodes:
        d += 1
    return d
