"""No-U-Turn sampler (iterative, multinomial), batched over chains.

Counterpart of ``pymc_bart_tpu/sampler/nuts.py``.  The JAX function is a
per-chain ``while_loop`` whose trip count differs between chains; here all
chains advance together under per-chain ``active`` masks:

* the outer loop doubles the trajectory up to ``max_tree_depth`` times and
  stops when EVERY chain has stopped (the one host synchronisation per
  doubling); a chain that has stopped keeps its state through
  ``torch.where``;
* a doubling at depth ``j`` is ``2^j`` leapfrog steps for all chains at once
  (one ``torch.autograd.grad`` of the summed log-density each), carrying a
  progressive multinomial sample of the proposal;
* the generalized U-turn criterion is checked for every balanced subtree via
  per-level checkpoints: when leaf ``i`` starts a size-``2^h`` subtree its
  momentum and the running momentum sum are stored at level ``h``; when leaf
  ``i`` completes one the subtree's momentum sum is compared with both end
  momenta.  Which levels start or complete at leaf ``i`` is the same for
  every chain, so it is decided on the host.

``logp_fn`` maps ``theta (C, d)`` to per-chain log-densities ``(C,)``.
Step-size dual averaging and diagonal mass adaptation reuse ``hmc.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import tracing
from .hmc import (HmcState, adapt, finalize_adaptation, init_state,  # noqa: F401
                  value_and_grad)

_DIVERGENCE = 1000.0


@tracing.spanned("nuts_step")
def nuts_step(gen: torch.Generator, state: HmcState, logp_fn: Callable,
              tuning: bool, max_tree_depth: int = 8,
              target_accept: float = 0.8, full_stats: bool = False):
    """One NUTS transition per chain.

    Returns (new_state, accept_prob (C,)), or with ``full_stats=True``
    (new_state, dict) carrying per-chain sampler statistics (accept,
    diverging, tree_depth, n_steps, step_size, energy).
    """
    theta = state.theta
    C, d = theta.shape
    dev = theta.device
    L = max_tree_depth
    step = torch.exp(state.log_step)
    inv_mass = state.inv_mass
    neg_inf = torch.full((C,), float("-inf"), device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    r0 = torch.randn((C, d), generator=gen, device=dev) / torch.sqrt(inv_mass)
    logp0, grad0 = value_and_grad(logp_fn, theta)
    h0 = logp0 - 0.5 * (r0 * r0 * inv_mass).sum(dim=1)

    def w2(mask, a, b):  # per-chain blend of (C, d) values
        return torch.where(mask[:, None], a, b)

    def build_subtree(z, r, grad, eps, depth):
        """2^depth leapfrog steps from (z, r) for every chain."""
        n_leaves = 2**depth
        u_sel = rand(n_leaves, C)
        r_sum = torch.zeros_like(r)
        z_prop = z
        logp_prop = neg_inf
        log_w = neg_inf
        turning = torch.zeros((C,), dtype=torch.bool, device=dev)
        diverged = torch.zeros((C,), dtype=torch.bool, device=dev)
        sum_acc = torch.zeros((C,), device=dev)
        r_first_ck = [None] * (depth + 1)
        rsum_ck = [None] * (depth + 1)
        e = eps[:, None]
        leapfrog = tracing.span("nuts_leapfrog")
        for i in range(n_leaves):
            with leapfrog:
                r_half = r + 0.5 * e * grad
                z = z + e * r_half * inv_mass
                logp, grad = value_and_grad(logp_fn, z)
                r = r_half + 0.5 * e * grad
            energy = logp - 0.5 * (r * r * inv_mass).sum(dim=1)
            w_leaf = energy - h0
            new_div = ~(w_leaf > -_DIVERGENCE) | ~torch.isfinite(w_leaf)
            w_leaf = torch.where(new_div, neg_inf, w_leaf)
            sum_acc = sum_acc + torch.exp(w_leaf.clamp_max(0.0))

            # progressive multinomial proposal within the subtree
            new_log_w = torch.logaddexp(log_w, w_leaf)
            take_new = torch.log(u_sel[i]) < w_leaf - new_log_w
            z_prop = w2(take_new, z, z_prop)
            logp_prop = torch.where(take_new, logp, logp_prop)
            log_w = new_log_w

            # per-level checkpoints for balanced-subtree U-turn checks
            for h in range(depth + 1):
                if i % (2**h) == 0:
                    r_first_ck[h] = r
                    rsum_ck[h] = r_sum
            r_sum = r_sum + r
            for h in range(1, depth + 1):
                if (i + 1) % (2**h) == 0:
                    v = (r_sum - rsum_ck[h]) * inv_mass
                    turning = turning | ((v * r_first_ck[h]).sum(dim=1) <= 0.0) \
                        | ((v * r).sum(dim=1) <= 0.0)
            diverged = diverged | new_div
        return (z, r, grad, r_sum, z_prop, logp_prop, log_w, turning,
                diverged, sum_acc)

    depth_c = torch.zeros((C,), dtype=torch.int32, device=dev)
    turning = torch.zeros((C,), dtype=torch.bool, device=dev)
    diverged = torch.zeros((C,), dtype=torch.bool, device=dev)
    z_l = z_r = theta
    r_l = r_r = r0
    g_l = g_r = grad0
    r_sum = r0
    z_prop = theta
    logp_prop = logp0
    log_w = torch.zeros((C,), device=dev)
    sum_acc = torch.zeros((C,), device=dev)
    n_leaves_tot = torch.zeros((C,), dtype=torch.int32, device=dev)

    doublings = 0
    for depth in range(L):
        active = ~(turning | diverged)
        if not bool(active.any()):      # the one host sync per doubling
            break
        doublings += 1
        go_right = rand(C) < 0.5
        u_bias = rand(C)
        eps = torch.where(go_right, step, -step)
        (z_e, r_e, g_e, r_sum_sub, z_ps, logp_ps, log_w_sub, turn_sub,
         div_sub, acc_sub) = build_subtree(
            w2(go_right, z_r, z_l), w2(go_right, r_r, r_l),
            w2(go_right, g_r, g_l), eps, depth)

        left = active & ~go_right
        right = active & go_right
        z_l, r_l, g_l = w2(left, z_e, z_l), w2(left, r_e, r_l), w2(left, g_e, g_l)
        z_r, r_r, g_r = (w2(right, z_e, z_r), w2(right, r_e, r_r),
                         w2(right, g_e, g_r))

        # biased progressive sampling across the doubling
        ok = ~(turn_sub | div_sub)
        accept_sub = (torch.log(u_bias) < (log_w_sub - log_w)) & ok & active
        z_prop = w2(accept_sub, z_ps, z_prop)
        logp_prop = torch.where(accept_sub, logp_ps, logp_prop)
        log_w = torch.where(
            active,
            torch.logaddexp(log_w, torch.where(ok, log_w_sub, neg_inf)),
            log_w)

        r_sum = w2(active, r_sum + r_sum_sub, r_sum)
        v = r_sum * inv_mass
        turn_all = turn_sub | ((v * r_l).sum(dim=1) <= 0.0) \
            | ((v * r_r).sum(dim=1) <= 0.0)
        turning = torch.where(active, turn_all, turning)
        diverged = diverged | (div_sub & active)
        sum_acc = torch.where(active, sum_acc + acc_sub, sum_acc)
        one = active.to(torch.int32)
        depth_c = depth_c + one
        n_leaves_tot = n_leaves_tot + one * (2**depth)

    # a check a doubling entered, one more where the loop stopped early; the
    # leapfrogs run for all chains at once
    tracing.count("host_syncs", doublings + (doublings < L))
    tracing.count("nuts_leapfrogs", 2**doublings - 1)

    theta_new = z_prop
    accept_prob = sum_acc / n_leaves_tot.to(torch.float32).clamp_min(1.0)

    if tuning:
        new_state = adapt(state, theta_new, accept_prob, target_accept)
    else:
        new_state = dataclasses.replace(state, theta=theta_new)
    if full_stats:
        stats = {
            "accept": accept_prob,
            "diverging": diverged,
            "tree_depth": depth_c,
            "n_steps": n_leaves_tot,
            "step_size": step,
            "energy": -logp_prop,
        }
        return new_state, stats
    return new_state, accept_prob
