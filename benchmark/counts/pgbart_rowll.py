"""Float operations and bytes of a PGBART draw step of a one-output BART
forest with the constant response under a likelihood that does not collapse
onto node statistics, the Bernoulli logit ``y ~ Bernoulli(sigmoid(F))``: a
prediction row a particle and the exact row log-likelihood
``y F - softplus(F)`` after every level, no leaf refinement.

Counted from the model's shapes as the work of one tree update, so the count
is the same whichever kernel, or how many kernels, carry the update out.
Shapes: ``C`` chains, ``P`` particles, ``n`` rows, ``p`` covariates, ``m``
trees, ``D`` the depth (``S = 2^(D+1) - 1`` node slots, ``G = 2^D - 1``
inner slots), ``B`` trees updated a draw step.  A transcendental counts as
one operation.  Every input is read once and every output written once, in
float32 (4 bytes); the row Gumbels are generated where they are used."""

from .pgbart import F32, batch_trees

# per row and particle, one log-likelihood term and its sum: F = noi + pred,
# y F, |F|, exp, log1p, max(F, 0), the softplus add, the difference, the add
# of the row sum
LL_OPS = 9
# per row, particle and level besides it: the routing compare, the Gumbel
# compare of the split-value pick and the left child's residual sum
LEVEL_OPS = 3
# per row and chain: the other trees' sum and the residual, and the commit
ROW_OPS = 3


def tree_update(C, P, n, p, D):
    """``(flops, bytes)`` of one tree update of every chain: the
    log-likelihood of every particle at the root and after each of the D
    levels, the level work, the residual and the commit.  Bytes: the tree's
    split variables, split values, leaves and counts read and written, its
    prediction row read and written, and its random numbers (grow, variable
    and two leaf draws for every particle's inner slots, D - 1 resampling
    uniforms and the winner's)."""
    S, G = 2 ** (D + 1) - 1, 2 ** D - 1
    flops = C * (P * n * (LL_OPS * (D + 1) + LEVEL_OPS * D) + ROW_OPS * n)
    nbytes = F32 * C * (2 * 4 * S + 2 * n + P * G * 4 + D)
    return flops, nbytes


def step_shared_bytes(C, n, p, m, D):
    """Bytes a draw step reads or writes once whatever the batch: X, the
    labels, the sum of trees read and written, the split variables of the
    forest for the inclusion counts, the split prior and the counts."""
    S = 2 ** (D + 1) - 1
    return F32 * (n * p + n + 2 * C * n + C * m * S + 2 * C * p)


def rowll_tree_updates(C, P, n, p, m, D, batch_frac):
    """``(flops, bytes)`` of the tree updates of one draw step."""
    B = batch_trees(m, batch_frac)
    f1, b1 = tree_update(C, P, n, p, D)
    return B * f1, B * b1 + step_shared_bytes(C, n, p, m, D)
