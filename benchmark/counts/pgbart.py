"""Float operations and bytes of a PGBART draw step of a Gaussian BART
forest with the constant response, counted from the model's shapes.

Re-expressed from ``chip_smoke.py``'s per-launch bound arithmetic (the
``pgbart_step_fused`` entry of ``phase_timing`` and ``bign_bytes``) as the
work of one tree update, so the count is the same whichever kernel, or how
many kernels, carry the update out.  Shapes: ``C`` chains, ``P`` particles,
``n`` rows, ``p`` covariates, ``m`` trees, ``D`` the depth (``S = 2^(D+1) - 1``
node slots, ``G = 2^D - 1`` inner slots), ``R`` refinement sweeps, ``B``
trees updated a draw step.  Every input is read once and every output
written once, in float32 (4 bytes)."""

F32 = 4


def batch_trees(m, frac):
    """Trees updated a step: ``PgbartConfig.batch_size`` (Python's round)."""
    return max(1, int(round(m * frac)))


def tree_update(C, P, n, p, m, D, R):
    """``(flops, bytes)`` of one tree update of every chain.

    Operations: per row, particle and level the routing compare, the Gumbel
    compare of the split-value pick, the child-sum add and the difference,
    square, weight and add of the particle's log-likelihood (7); per row and
    pass of the R refinement sweeps, the winner's prediction and the new
    residual, the gather, difference, square, weight and add (5).
    Bytes: the tree's six node arrays read and written, its prediction row
    read and written, and its random numbers (split picks, variables, leaf
    noise and salts for every particle's inner slots, resampling, selection,
    refinement noise and acceptance), the row Gumbels excepted: they are
    generated where they are used."""
    S, G = 2 ** (D + 1) - 1, 2 ** D - 1
    Rb = max(R, 1)
    flops = C * (D * P * n * 7 + (R + 2) * n * 5)
    nbytes = F32 * C * (2 * 6 * S + 2 * n
                        + P * G * 5 + D + 1 + Rb * S + Rb)
    return flops, nbytes


def step_shared_bytes(C, n, p, m, D):
    """Bytes a draw step reads or writes once whatever the batch: X, y, the
    Gaussian precision of each row, the sum of trees read and written, the
    split variables of the forest for the inclusion counts, the split prior,
    the leaf scale and the counts themselves."""
    S = 2 ** (D + 1) - 1
    return F32 * (n * p + n + C * n + 2 * C * n + C * m * S + 2 * C * p + C)


def rejuvenation_move(C, n, D):
    """Float operations of one grow / prune / change move on one tree of
    every chain: the node's rows (D compares a row), the split decision,
    two masked residual sums (2 a row each), the proposed predictions (2),
    and the likelihood of the proposed and the current predictions
    (difference, square, weight, add: 4 a row each)."""
    return C * n * (D + 1 + 4 + 2 + 8)


def pgbart_tree_updates(C, P, n, p, m, D, R, batch_frac):
    """``(flops, bytes)`` of the tree updates of one draw step."""
    B = batch_trees(m, batch_frac)
    f1, b1 = tree_update(C, P, n, p, m, D, R)
    return B * f1, B * b1 + step_shared_bytes(C, n, p, m, D)


def draw_step_flops(C, P, n, p, m, D, R, batch_frac, rejuv_moves=0):
    """Float operations of one draw step: the tree updates (each with its
    winner's prediction) and ``rejuv_moves`` rejuvenation moves a chain."""
    flops, _ = pgbart_tree_updates(C, P, n, p, m, D, R, batch_frac)
    return flops + rejuv_moves * rejuvenation_move(C, n, D)


def floor_seconds(flops, nbytes, peak):
    """The least time the card could take: the larger of the bytes over its
    memory bandwidth and the operations over its float32 rate."""
    return max(nbytes / peak["hbm_bytes_per_s"], flops / peak["fp32_flops"])
