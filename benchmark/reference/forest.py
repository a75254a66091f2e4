"""Plain NumPy sum-of-trees prediction of stored forests.

Trees are fixed-depth complete binary trees in slot layout: the root is slot
0, the children of slot ``i`` are ``2i + 1`` (left) and ``2i + 2`` (right),
a split variable of ``-1`` marks a leaf, and a row goes left where
``x <= split value`` (the continuous split rule).  The sum of the leaf
values a row reaches in each tree is the forest's prediction."""

import numpy as np


def jitter_duplicates(X, seed):
    """The covariates the sampler grows and routes on: in each column, the
    values that occur more than once get a uniform jitter well below the
    column's smallest gap between distinct values, drawn in column order
    from one NumPy generator seeded with ``seed`` (every column continuous).
    """
    X = np.array(X, np.float32, copy=True)
    rng = np.random.default_rng(seed)
    for j in range(X.shape[1]):
        col = X[:, j]
        finite = np.isfinite(col)
        vals, counts = np.unique(col[finite], return_counts=True)
        if vals.size == 0 or not (counts > 1).any():
            continue
        scale = 1e-6 * max(float(np.nanstd(col)), abs(float(vals[0])), 1.0)
        if vals.size > 1:
            scale = min(scale, 0.4 * float(np.min(np.diff(vals))))
        dup = finite & np.isin(col, vals[counts > 1])
        col[dup] += rng.uniform(-scale, scale,
                                int(dup.sum())).astype(np.float32)
        X[:, j] = col
    return X


def leaf_slots(split_var, split_val, X):
    """The slot each row reaches in each tree: int64 (..., m, n) for
    ``split_var`` / ``split_val`` (..., m, S) and ``X`` (n, p)."""
    split_var = np.asarray(split_var)
    S = split_var.shape[-1]
    depth = int(np.log2(S + 1)) - 1
    lead = split_var.shape[:-1]
    sv = split_var.reshape(-1, S)
    sl = np.asarray(split_val, np.float32).reshape(-1, S)
    n = X.shape[0]
    node = np.zeros((sv.shape[0], n), np.int64)
    rows = np.arange(n)[None, :]
    trees = np.arange(sv.shape[0])[:, None]
    for _ in range(depth):
        var = sv[trees, node]
        inner = var >= 0
        x = X[rows, np.where(inner, var, 0)]
        left = x <= sl[trees, node]
        child = 2 * node + np.where(left, 1, 2)
        node = np.where(inner, child, node)
    return node.reshape(lead + (n,))


def predict(split_var, split_val, leaf, X, block=4096):
    """Sum-of-trees prediction (..., n) in float64 of forests
    ``split_var`` / ``split_val`` (..., m, S) and ``leaf`` (..., m, S) or
    (..., m, S, 1), on the rows of ``X`` (n, p), in blocks of rows."""
    leaf = np.asarray(leaf)
    if leaf.ndim == np.ndim(split_var) + 1:
        leaf = leaf[..., 0]
    m, S = leaf.shape[-2:]
    lead = leaf.shape[:-2]
    lf = leaf.reshape(-1, S).astype(np.float64)
    trees = np.arange(lf.shape[0])[:, None]
    X = np.asarray(X, np.float32)
    out = []
    for r0 in range(0, X.shape[0], block):
        slots = leaf_slots(split_var, split_val, X[r0:r0 + block])
        vals = lf[trees, slots.reshape(lf.shape[0], -1)]
        out.append(vals.reshape(lead + (m, -1)).sum(axis=-2))
    return np.concatenate(out, axis=-1)
