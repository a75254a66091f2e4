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
    ``split_var`` / ``split_val`` (..., m, S) and ``X`` (n, p).

    A tree is descended inner node by inner node, parents first, each
    sending the rows that reach it to its children; a split on the last
    level of slots has no children and keeps its rows.  A tree equal to the
    same tree of the forest before it (a stored forest repeats the trees a
    draw did not update) takes that tree's slots."""
    split_var = np.asarray(split_var)
    S = split_var.shape[-1]
    lead = split_var.shape[:-1]
    m = lead[-1] if lead else 1
    sv = split_var.reshape(-1, S)
    sl = np.asarray(split_val, np.float32).reshape(-1, S)
    Xt = np.asarray(X, np.float32).T.copy()                     # (p, n)
    T, n = sv.shape[0], Xt.shape[1]
    new = np.ones(T, bool)
    new[m:] = ((sv[m:] != sv[:-m]) | (sl[m:] != sl[:-m])).any(axis=1)
    trees = np.flatnonzero(new)
    node = np.zeros((trees.size, n), np.int64)
    inner = sv[trees, :S // 2] >= 0
    for k, s in zip(*(a.tolist() for a in np.nonzero(inner))):
        t = trees[k]
        at = node[k] == s
        x = Xt[sv[t, s], at]
        node[k, at] = np.where(x <= sl[t, s], 2 * s + 1, 2 * s + 2)
    # each tree takes the slots of the last new tree at its place
    src = np.where(new, np.arange(T), 0).reshape(-1, m)
    src = np.maximum.accumulate(src, axis=0).reshape(-1)
    return node[(np.cumsum(new) - 1)[src]].reshape(lead + (n,))


def predict(split_var, split_val, leaf, X, block=4096):
    """Sum-of-trees prediction in float64 of forests ``split_var`` /
    ``split_val`` (..., m, S) with ``leaf`` (..., m, S) or (..., m, S, k),
    on the rows of ``X`` (n, p), in blocks of rows: (..., n) for one output
    (``leaf`` (..., m, S) or k = 1), (..., k, n) for k > 1 outputs."""
    leaf = np.asarray(leaf)
    if leaf.ndim == np.ndim(split_var):
        leaf = leaf[..., None]
    m, S, k = leaf.shape[-3:]
    lead = leaf.shape[:-3]
    lf = leaf.reshape(-1, S, k).astype(np.float64)
    trees = np.arange(lf.shape[0])[:, None]
    X = np.asarray(X, np.float32)
    out = []
    for r0 in range(0, X.shape[0], block):
        slots = leaf_slots(split_var, split_val, X[r0:r0 + block])
        vals = lf[trees, slots.reshape(lf.shape[0], -1)]     # (T, rows, k)
        vals = vals.reshape(lead + (m, -1, k)).sum(axis=-3)
        out.append(np.moveaxis(vals, -1, -2))
    got = np.concatenate(out, axis=-1)
    return got[..., 0, :] if k == 1 else got
