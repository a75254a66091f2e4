"""The BART classifier ``y ~ Bernoulli(sigmoid(F))``, ``F`` a sum of ``m``
trees, in plain PyTorch and float32: the descent of a forest to the sum of
trees, the Bernoulli-logit log-likelihood, and one particle-Gibbs update of
one tree of one chain (Chipman, George & McCulloch 2010, Ann. Appl. Stat.
4(1), section 4, the classifier; Lakshminarayanan, Roy & Teh 2015,
"Particle Gibbs for Bayesian Additive Regression Trees", AISTATS, the
conditional SMC tree update; pymc-bart's ``Bernoulli(p=sigmoid(BART))``).

The forest is the port's layout: a tree of depth ``D`` is ``S = 2^(D+1) - 1``
node slots, the root at slot 0 and the children of slot ``s`` at ``2s + 1``
(left) and ``2s + 2`` (right); ``split_var`` (m, S) holds a node's covariate
or ``-1`` at a leaf, ``split_val`` (m, S) its threshold (a row goes left
where ``x <= split_val``), ``leaf`` (m, S) its value (an inner node keeps
the value it had as a leaf) and ``count`` (m, S) the training rows that
reach it.

One tree update (``update_tree``) runs ``P`` particles, particle 0 the
current tree, through ``D`` rounds, one a level of the tree ("the
depth-synchronous rounds of the large-n formulation"), and commits one of
them.  It reads its random numbers from explicit blocks (a ``StepRands`` of
the port, or any object with the same fields, with the row Gumbels ``rg``
given) at tree ``b`` of the step and chain ``c``:

* ``ug`` (B, C, P, 2^D - 1): a node grows where ``ug < alpha (1 + d)^-beta``;
* ``uv``: its split variable, by inverse CDF of the split prior ``alpha_vec``;
* ``rg`` (B, D, C, P, n): its split value is ``X`` at the node's row with the
  largest Gumbel, ties to the lowest row;
* ``eps`` (B, C, P, 1, 2 (2^D - 1)): the children's leaf noise;
* ``ures`` (B, D, C): the systematic resampling after each level but the
  last; ``usel`` (B, C): the winner.

Departures from PG-BART as published, each as the port and pymc-bart have
it:

1. Trees have a fixed depth ``D``: a node on level ``D`` never splits.
2. Growth is depth-synchronous: every particle proposes a split for each of
   its leaves on level ``d`` in round ``d``, and the particles are weighted
   and resampled once a round, where the paper expands one node of a
   particle at a time.
3. The split value is ``X`` at a row drawn uniformly among the node's rows
   (a value weighted by its multiplicity, not uniform over distinct
   values), and a split that leaves a child without rows is taken back: the
   node stays a leaf.
4. A new leaf's value is pymc-bart's: the mean over the leaf's rows of the
   pseudo-residual ``y - (sum of the other trees)``, over ``m``, plus
   ``N(0, leaf_sd)`` noise, for the Bernoulli likelihood too; no leaf
   refinement follows (``num_refinements = 0``).
5. A particle's weight is updated by the change of the exact full-data
   log-likelihood ``sum(y F - softplus(F))`` at ``F`` = the other trees plus
   the particle's prediction on the levels grown so far (an inner node's
   rows keep its leaf value until they move down).
6. Resampling is systematic and gated: particles 1..P-1 are resampled among
   themselves where their effective sample size falls below ``(P - 1) / 2``
   and take the log-mean weight; particle 0 is never resampled.
7. The winner is drawn by inverse CDF of the final weights on ``usel``.
8. Sums that reach a decision take the rule of the port's
   ``pymc_bart_tpu_torch/ops/sums.py``, the one import from the port:
   sums over rows in float64 rounded to float32 once (``sum64``), sums over
   particles in index order (``seq_sum``, ``seq_cumsum``), quotients by a
   count rounded once (``true_div``), the split prior's CDF in float64
   (``alpha_cdf_of``).  The same numbers then give the same decisions
   wherever they are added.

TF32 is off, so that no float32 product here rounds to 10 bits.
"""

from __future__ import annotations

import dataclasses

import torch

from pymc_bart_tpu_torch.ops.sums import (alpha_cdf_of, seq_cumsum, seq_sum,
                                          sum64, true_div)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32 = torch.float32


@dataclasses.dataclass
class Tree:
    """One tree: ``split_var`` int32 (S,), ``split_val``, ``leaf`` and
    ``count`` float32 (S,)."""

    split_var: torch.Tensor
    split_val: torch.Tensor
    leaf: torch.Tensor
    count: torch.Tensor


def depth_of(S: int) -> int:
    """The depth ``D`` of a tree of ``S = 2^(D+1) - 1`` slots."""
    return (S + 1).bit_length() - 2


def leaf_slots(split_var, split_val, X):
    """int64 (m, n): the slot each row of ``X`` (n, p) reaches in each tree
    of ``split_var`` / ``split_val`` (m, S), descending ``D`` levels."""
    m, S = split_var.shape
    n = X.shape[0]
    rows = torch.arange(n, device=X.device)[None, :]
    node = torch.zeros((m, n), dtype=torch.int64, device=X.device)
    for _ in range(depth_of(S)):
        var = split_var.gather(1, node).to(torch.int64)
        val = split_val.gather(1, node)
        x = X[rows, var.clamp_min(0)]
        node = torch.where(var >= 0, 2 * node + 1 + (~(x <= val)).long(),
                           node)
    return node


def forest_predict(split_var, split_val, leaf, X):
    """The sum of trees (n,) on the rows of ``X``: each tree's leaf value at
    the slot a row reaches, added over the trees in float32."""
    return leaf.gather(1, leaf_slots(split_var, split_val, X)).sum(dim=0)


def softplus(F):
    """``log(1 + exp(F))`` without overflow."""
    return F.clamp_min(0.0) + torch.log1p(torch.exp(-F.abs()))


def bernoulli_loglik(F, y):
    """``sum(y F - softplus(F))`` over the last axis (a sum over rows:
    float64, rounded once)."""
    return sum64(y * F - softplus(F))


def resample(ll, ll_prev, log_w, u):
    """One gated systematic resampling of the particles (P,): returns
    ``(log_w, take, ll_prev)``, ``take`` the ancestor of each particle."""
    P = ll.shape[0]
    lw1 = log_w + ll - ll_prev
    rest = lw1[1:]
    top = rest.max()
    w = torch.exp(rest - top)
    total = seq_sum(w)
    probs = w / total
    ess = 1.0 / torch.clamp_min(seq_sum(probs * probs), 1e-38)
    take = torch.arange(P, device=ll.device)
    if bool(ess < 0.5 * (P - 1)):
        positions = true_div(u + torch.arange(P - 1, dtype=F32,
                                              device=ll.device), P - 1)
        cdf = seq_cumsum(probs)
        cdf = cdf / cdf[-1:]
        anc = torch.searchsorted(cdf, positions) + 1
        take = torch.cat([take[:1], anc.clamp(1, P - 1)])
        log_mean = top + torch.log(true_div(total, P - 1))
        lw1 = torch.cat([lw1[:1], log_mean.expand(P - 1)])
    return lw1, take, ll[take]


def update_tree(tree: Tree, F, X, y, alpha_vec, leaf_sd, rands, b: int,
                c: int, *, m: int, alpha: float = 0.95, beta: float = 2.0):
    """One particle-Gibbs update of ``tree`` in chain ``c``.

    ``F`` (n,): the current sum of trees, ``tree``'s prediction included;
    ``X`` (n, p), ``y`` (n,) the labels in {0, 1}; ``alpha_vec`` (p,) the
    split prior's weights and ``leaf_sd`` (0-d) the leaf noise's scale of the
    chain; ``rands``: the step's blocks, read at tree ``b`` and chain ``c``
    (module docstring); ``m`` trees in the forest; ``alpha``, ``beta`` the
    tree prior.  Returns ``(the committed Tree, the new sum of trees (n,))``.
    """
    n, p = X.shape
    S = tree.split_var.shape[0]
    D = depth_of(S)
    P = rands.ug.shape[2]
    dev = X.device

    pred_j = tree.leaf[leaf_slots(tree.split_var[None], tree.split_val[None],
                                  X)[0]]
    noi = F - pred_j                      # the other trees
    resid = y - noi
    root_r = sum64(resid)
    root_mu = true_div(true_div(root_r, n), m)
    cdf = alpha_cdf_of(alpha_vec[None])[0]
    total = cdf[-1]

    # particle 0: the current tree; the others: one root leaf
    sv = torch.full((P, S), -1, dtype=torch.int32, device=dev)
    sl = torch.zeros((P, S), dtype=F32, device=dev)
    lf = torch.zeros((P, S), dtype=F32, device=dev)
    ct = torch.zeros((P, S), dtype=F32, device=dev)
    rs = torch.zeros((P, S), dtype=F32, device=dev)      # sum of resid
    lf[:, 0], ct[:, 0], rs[:, 0] = root_mu, float(n), root_r
    sv[0], sl[0], lf[0], ct[0] = (tree.split_var, tree.split_val, tree.leaf,
                                  tree.count)
    li = torch.zeros((P, n), dtype=torch.int64, device=dev)  # row -> slot
    pred = lf[:, :1].expand(P, n).clone()

    def loglik(pr):
        return bernoulli_loglik(noi + pr, y)

    ll = loglik(pred)
    log_w, ll_prev = ll, ll

    for d in range(D):
        lo, G = 2**d - 1, 2**d
        p_grow = float(alpha * (1.0 + d) ** (-beta))
        ug = rands.ug[b, c, :, lo:lo + G]
        uv = rands.uv[b, c, :, lo:lo + G]
        eps = rands.eps[b, c, :, 0, 2 * lo:2 * lo + 2 * G]
        rg = rands.rg[b, d, c]                                   # (P, n)
        for q in range(P):
            for g in range(G):
                s = lo + g
                at = li[q] == s                   # the node's rows
                if q == 0:
                    # the current tree: its splits route its rows again
                    if int(sv[q, s]) < 0:
                        continue
                    var, val, grow = int(sv[q, s]), sl[q, s], False
                else:
                    if not (bool(ug[q, g] < p_grow) and int(sv[q, s]) < 0
                            and bool(ct[q, s] >= 2.0)):
                        continue
                    var = int(torch.searchsorted(
                        cdf, (uv[q, g] * total).reshape(1)).clamp(0, p - 1))
                    gum = torch.where(at, rg[q], -torch.inf)
                    val, grow = X[int(torch.argmax(gum)), var], True
                left = at & (X[:, var] <= val)
                if grow:
                    cl = left.sum().to(F32)
                    rl = sum64(torch.where(left, resid, 0.0))
                    cr, rr = ct[q, s] - cl, rs[q, s] - rl
                    if not (bool(cl > 0.5) and bool(cr > 0.5)):
                        continue                   # an empty child: no split
                    sv[q, s], sl[q, s] = var, val
                    for k, (c_k, r_k) in enumerate(((cl, rl), (cr, rr))):
                        ch = 2 * s + 1 + k
                        lf[q, ch] = (true_div(r_k / c_k.clamp_min(1.0), m)
                                     + eps[q, 2 * g + k] * leaf_sd)
                        ct[q, ch], rs[q, ch] = c_k, r_k
                # the node's rows move to its children
                li[q] = torch.where(at, 2 * s + 1 + (~left).long(), li[q])
                pred[q] = torch.where(at, lf[q].gather(0, li[q]), pred[q])
        ll = loglik(pred)
        if d < D - 1:
            log_w, take, ll_prev = resample(ll, ll_prev, log_w,
                                            rands.ures[b, d, c])
            sv, sl, lf, ct, rs, li, pred = (
                a[take] for a in (sv, sl, lf, ct, rs, li, pred))
        else:
            log_w = log_w + ll - ll_prev

    cdf_w = seq_cumsum(torch.exp(log_w - log_w.max()))
    u = rands.usel[b, c] * cdf_w[-1]
    w = int((cdf_w < u).sum().clamp(0, P - 1))
    return Tree(sv[w], sl[w], lf[w], ct[w]), noi + pred[w]
