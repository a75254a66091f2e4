"""Retained-path rejuvenation: grow / prune / change Metropolis moves on the
committed trees (``PgbartConfig(ancestor_sampling=True)``), batched over
chains (PyTorch).

Counterpart of ``pymc_bart_tpu/sampler/rejuvenate.py``, which derives the
moves and their acceptance ratios (the tree-structured counterpart of
Particle Gibbs with Ancestor Sampling; Chipman, George & McCulloch 1998).
After each PGBART step every committed tree gets ``rejuvenation_sweeps``
moves, one tree after another (Gibbs-sequential in the sum of trees, as the
JAX ``fori_loop``).  A move is grow (probability 0.25), prune (0.25) or
change (0.5): grow splits a leaf with two or more rows, prune merges a node
whose children are leaves, change re-draws such a node's variable, value and
children's values.  Proposals come from the sampler's implied prior, so the
acceptance is the likelihood ratio times the depth-prior and
candidate-count terms of ``_one_move``.

Chains are the leading tensor axis.  Every chain takes its own branch: the
branches share their work (grow and change both split a node with the same
variable and row draws; prune and change pick the same node), so one move
walks one node's rows once, proposes one split and one merge and evaluates
the likelihood twice, and ``torch.where`` picks each chain's branch, as
``lax.switch`` does under ``vmap``.  Nothing synchronises with the host
inside a sweep.  The random numbers of each move are inputs
(``RejuvRands``): the tests feed the JAX package's, ``draw_rejuv_rands``
draws them from the sampler's ``torch.Generator``.

Under row sharding (``rows``, JAX's ``data_axis``) the rows of X, the
targets, the predictions and ``RejuvRands.row_gum`` are one rank's: the
split value is ``sums.gumbel_pick``'s over every shard and the counts,
residual sums and likelihood sums are reduced over the data group, so every
shard takes the same decisions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..config import BartConfig, PgbartConfig
from ..ops.sums import alpha_cdf_of, gumbel_pick, sum64, true_div
from ..ops.trees import decide_left
from ..parallel.mesh import row_sum

# move choice: grow below 0.25, prune below 0.5, change above
P_GROW_MOVE, P_PRUNE_MOVE = 0.25, 0.5


@dataclasses.dataclass
class RejuvRands:
    """Random numbers of ``M`` moves for ``C`` chains, in the order
    ``_one_move`` of the JAX package draws them from its seven keys."""

    u_move: torch.Tensor   # float32[M, C] branch
    g_node: torch.Tensor   # float32[M, C, S] Gumbels of the node pick
    u_var: torch.Tensor    # float32[M, C] split variable
    row_gum: torch.Tensor  # float32[M, C, n] Gumbels of the split-value row
    salt: torch.Tensor     # int64[M, C] subset-rule salt (uint32 value)
    eps: torch.Tensor      # float32[M, C, 2, k] children's leaf normals
    u_acc: torch.Tensor    # float32[M, C] acceptance

    def move(self, i: int) -> "RejuvRands":
        """The randoms of move ``i`` (the move axis dropped)."""
        return RejuvRands(*(getattr(self, f.name)[i]
                            for f in dataclasses.fields(self)))

    def shard(self, chains: slice, rows=None) -> "RejuvRands":
        """The numbers of the chains ``chains`` (and the row Gumbels of the
        rows ``rows``) out of numbers drawn for every chain (axis 1)."""
        out = {}
        for f in dataclasses.fields(self):
            a = getattr(self, f.name)[:, chains]
            if f.name == "row_gum" and rows is not None:
                a = a[..., rows]
            out[f.name] = a.contiguous()
        return RejuvRands(**out)


def gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel draws: -log(-log(u)), u clamped away from 0 and 1."""
    f32 = torch.float32
    u = torch.rand(tuple(shape), generator=gen, device=device, dtype=f32)
    u = u.clamp_(torch.finfo(f32).tiny, 1.0 - 2.0**-24)
    return u.log_().neg_().log_().neg_()


def draw_rejuv_rands(gen: torch.Generator, *, moves: int, C: int, S: int,
                     n: int, k: int, device) -> RejuvRands:
    """The randoms of ``moves`` moves for ``C`` chains from ``gen``."""
    def unif(*shape):
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float32)

    return RejuvRands(
        u_move=unif(moves, C), g_node=gumbel(gen, (moves, C, S), device),
        u_var=unif(moves, C), row_gum=gumbel(gen, (moves, C, n), device),
        salt=torch.randint(0, 2**32, (moves, C), generator=gen,
                           device=device, dtype=torch.int64),
        eps=torch.randn((moves, C, 2, k), generator=gen, device=device,
                        dtype=torch.float32),
        u_acc=unif(moves, C))


def depth_of_slots(S: int, device) -> torch.Tensor:
    """Depth of each node slot: int64[S]."""
    return torch.floor(torch.log2(torch.arange(S, dtype=torch.float64,
                                               device=device) + 1)
                       ).to(torch.int64)


def _at(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[c, idx[c]]`` for a (C, S) tensor and (C,) slots."""
    return a.gather(1, idx[:, None])[:, 0]


def _decide(xv, split_val, split_set, rule, all_cont: bool):
    """``decide_left``; with every rule continuous, its first case alone."""
    if all_cont:
        return xv <= split_val
    return decide_left(xv, split_val, split_set, rule)


def rows_at_node(sv, sl, st, rules, XT, node, D: int,
                 all_cont: bool = False) -> torch.Tensor:
    """bool[C, n]: the rows routed to slot ``node[c]`` of each chain's tree.

    The ``D`` steps of the ancestor chain root-ward are taken together: the
    step ``t`` child ``c_t = ((node + 1) >> t) - 1`` (valid while above the
    root) and its parent; each row must go the child's way at every valid
    step.  One gather of the ancestors' splits, one of their columns (whole
    rows of ``XT`` (p, n), never a per-row gather).
    """
    p = XT.shape[0]
    up = (node + 1)[:, None] >> torch.arange(D + 1, device=node.device)
    child, par = up[:, :D] - 1, up[:, 1:] - 1                    # (C, D)
    par = par.clamp_min(0)
    j = sv.gather(1, par).clamp(0, p - 1).to(torch.int64)
    left = _decide(XT[j], sl.gather(1, par)[..., None],
                   st.gather(1, par)[..., None], rules[j][..., None],
                   all_cont)                                     # (C, D, n)
    ok = (left == ((child & 1) == 1)[..., None]) | (child <= 0)[..., None]
    return ok.all(dim=1)


def _salt_bits(salt: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 -> the int32 bit pattern ``split_set`` holds."""
    return torch.where(salt >= 2**31, salt - 2**32, salt).to(torch.int32)


def _one_move(r: RejuvRands, sv, sl, st, lf, ct, pred, XT, resid, sum_noi,
              alpha_cdf, leaf_sd, rules, cfg: BartConfig, ll_of: Callable,
              depth, all_cont: bool = False, rows=None):
    """One grow, prune or change attempt on one tree of each chain.

    ``sv``/``sl``/``st``/``ct`` (C, S), ``lf`` (C, S, k), ``pred`` /
    ``resid`` / ``sum_noi`` (C, n, k), ``XT`` (p, n), ``alpha_cdf`` (C, p),
    ``leaf_sd`` (C, k), ``rules`` (p,), ``depth`` int64[S]; ``r`` holds one
    move's randoms (``RejuvRands.move``).  ``ll_of(sum_noi, pred) -> (C,)``.
    ``all_cont``: every split rule is continuous (the decisions are then
    ``x <= value`` alone).  ``rows``: the row arrays are this rank's of a
    row-sharded model (``ll_of`` reduces its own sums).
    Returns the (possibly unchanged) ``(sv, sl, st, lf, ct, pred)`` and the
    accept decision bool[C].
    """
    S = sv.shape[1]
    p = XT.shape[0]
    D, m = cfg.max_depth, cfg.m
    dev = sv.device
    f32 = torch.float32
    slots = torch.arange(S, device=dev)
    child_l = (2 * slots + 1).clamp_max(S - 1)
    child_r = (2 * slots + 2).clamp_max(S - 1)
    is_last = depth >= D
    inner = depth < D

    is_leaf = sv < 0
    grow_cand = is_leaf & (ct >= 2.0) & inner
    prune_cand = ~is_leaf & is_leaf[:, child_l] & is_leaf[:, child_r] & ~is_last
    n_grow = grow_cand.sum(1).to(f32)
    n_prune = prune_cand.sum(1).to(f32)

    grow = r.u_move < P_GROW_MOVE
    prune = ~grow & (r.u_move < P_PRUNE_MOVE)
    ninf = torch.full_like(r.g_node, float("-inf"))
    node = torch.where(
        grow, torch.argmax(torch.where(grow_cand, r.g_node, ninf), 1),
        torch.argmax(torch.where(prune_cand, r.g_node, ninf), 1))
    d = depth[node].to(f32)
    mask = rows_at_node(sv, sl, st, rules, XT, node, D, all_cont)
    cnt = _at(ct, node)

    # the split proposal of grow and change: variable from the split
    # weights, value at the node's row of largest Gumbel (lowest index on a
    # tie), salt for the subset rule
    var = torch.searchsorted(alpha_cdf, r.u_var[:, None] * alpha_cdf[:, -1:]
                             ).clamp(0, p - 1)[:, 0]
    xcol = XT[var]                                               # (C, n)
    val = gumbel_pick(r.row_gum, mask, xcol, rows)           # (C,)
    left = mask & _decide(xcol, val[:, None], r.salt[:, None],
                          rules[var][:, None], all_cont)
    cl = row_sum(left.sum(1), rows).to(f32)
    cr = cnt - cl
    zero = torch.zeros_like(resid)
    rs_t = sum64(torch.where(mask[:, :, None], resid, zero), dim=1,
                 rows=rows)                                      # (C, k)
    rs_l = sum64(torch.where(left[:, :, None], resid, zero), dim=1,
                 rows=rows)
    rs_r = rs_t - rs_l
    noise = r.eps * leaf_sd[:, None, :]                              # (C,2,k)
    mu_l = true_div(rs_l / cl.clamp_min(1.0)[:, None], m) + noise[:, 0]
    mu_r = true_div(rs_r / cr.clamp_min(1.0)[:, None], m) + noise[:, 1]
    # the merge proposal of prune
    mu_s = true_div(rs_t / cnt.clamp_min(1.0)[:, None], m) + noise[:, 0]

    inside = mask[:, :, None]
    split_pred = torch.where(
        inside, torch.where(left[:, :, None], mu_l[:, None], mu_r[:, None]),
        pred)
    pred_new = torch.where(prune[:, None, None],
                           torch.where(inside, mu_s[:, None], pred),
                           split_pred)
    dll = ll_of(sum_noi, pred_new) - ll_of(sum_noi, pred)

    def p_grow_at(dd):
        return cfg.alpha * (1.0 + dd) ** (-cfg.beta)

    pg_d = p_grow_at(d)
    child_stay = torch.where(d + 1.0 < D, 2.0 * torch.log1p(-p_grow_at(d + 1.0)),
                             torch.zeros_like(d))
    at_node = slots == node[:, None]
    l_i, r_i = 2 * node + 1, 2 * node + 2
    at_kids = (slots == l_i[:, None]) | (slots == r_i[:, None])
    # reverse-move candidates of the proposed trees
    leaf_g = is_leaf & ~at_node
    n_prune_g = (~leaf_g & leaf_g[:, child_l] & leaf_g[:, child_r]
                 & ~is_last).sum(1).to(f32)
    n_grow_p = ((is_leaf | at_node) & (torch.where(at_kids, 0.0, ct) >= 2.0)
                & inner).sum(1).to(f32)
    # (the JAX package's order of the terms, so that both round alike)
    log_a_grow = (dll + torch.log(pg_d) - torch.log1p(-pg_d) + child_stay
                  + torch.log(n_grow.clamp_min(1.0))
                  - torch.log(n_prune_g.clamp_min(1.0)))
    log_a_prune = (dll - torch.log(pg_d) + torch.log1p(-pg_d) - child_stay
                   + torch.log(n_prune.clamp_min(1.0))
                   - torch.log(n_grow_p.clamp_min(1.0)))
    split_ok = (cl > 0.5) & (cr > 0.5)
    ok = torch.where(grow, (n_grow > 0.5) & split_ok,
                     torch.where(prune, n_prune > 0.5,
                                 (n_prune > 0.5) & split_ok))
    log_a = torch.where(grow, log_a_grow, torch.where(prune, log_a_prune, dll))
    acc = ok & (torch.log(r.u_acc) < log_a)

    split_acc = (acc & ~prune)[:, None]
    prune_acc = (acc & prune)[:, None]
    at_l, at_r = slots == l_i[:, None], slots == r_i[:, None]
    sv2 = torch.where(at_node & split_acc, var[:, None].to(sv.dtype),
                      torch.where(at_node & prune_acc, -1, sv))
    sl2 = torch.where(at_node & split_acc, val[:, None], sl)
    st2 = torch.where(at_node & split_acc, _salt_bits(r.salt)[:, None], st)
    ct2 = torch.where(split_acc & at_l, cl[:, None],
                      torch.where(split_acc & at_r, cr[:, None],
                                  torch.where(prune_acc & at_kids, 0.0, ct)))
    kk = (slice(None), slice(None), None)
    lf2 = torch.where(
        (split_acc & at_l)[kk], mu_l[:, None],
        torch.where((split_acc & at_r)[kk], mu_r[:, None],
                    torch.where((prune_acc & at_node)[kk], mu_s[:, None],
                                torch.where((prune_acc & at_kids)[kk], 0.0,
                                            lf))))
    pred2 = torch.where(acc[:, None, None], pred_new, pred)
    return sv2, sl2, st2, lf2, ct2, pred2, acc


def rejuvenate_forest(state, rands: RejuvRands, X, Y_target, rules,
                      cfg: BartConfig, pg: PgbartConfig, ll_of: Callable,
                      all_cont: bool = False, rows=None):
    """``pg.rejuvenation_sweeps`` sweeps of one move per tree over every
    chain's committed forest (``PgbartState`` with a leading chain axis,
    UPDATED IN PLACE and returned).  ``Y_target`` is (n, k) or (C, n, k);
    ``rands`` holds ``m * rejuvenation_sweeps`` moves; ``all_cont``: every
    rule of ``rules`` is continuous; ``rows``: see ``_one_move``."""
    m = cfg.m
    n, _p = X.shape
    k = cfg.n_outputs
    moves = m * max(int(pg.rejuvenation_sweeps), 1)
    if rands.u_move.shape[0] != moves:
        raise ValueError(f"rands holds {rands.u_move.shape[0]} moves, the "
                         f"sweeps take {moves}")
    XT = X.t().contiguous()
    Y = Y_target.reshape(-1, n, k)
    alpha_cdf = alpha_cdf_of(state.alpha_vec)
    depth = depth_of_slots(cfg.n_nodes, X.device)
    f = state.forest
    for i in range(moves):
        jt = i % m
        pred = state.tree_pred[:, jt]
        sum_noi = state.sum_trees - pred
        sv, sl, st, lf, ct, pred2, _acc = _one_move(
            rands.move(i), f.split_var[:, jt], f.split_val[:, jt],
            f.split_set[:, jt], f.leaf[:, jt], f.count[:, jt], pred, XT,
            Y - sum_noi, sum_noi, alpha_cdf, state.leaf_sd, rules, cfg, ll_of,
            depth, all_cont, rows)
        f.split_var[:, jt] = sv
        f.split_val[:, jt] = sl
        f.split_set[:, jt] = st
        f.leaf[:, jt] = lf
        f.count[:, jt] = ct
        state.tree_pred[:, jt] = pred2
        state.sum_trees = sum_noi + pred2
    return state
