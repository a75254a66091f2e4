"""Hamiltonian Monte Carlo for the non-BART free RVs, batched over chains.

Counterpart of ``pymc_bart_tpu/sampler/hmc.py``.  Every field of
``HmcState`` carries a leading chain axis ``C``; ``logp_fn`` maps
``theta (C, d)`` to the per-chain log-density ``(C,)``.  Chains are
independent, so the gradient of the summed log-density is each chain's own
gradient (one ``torch.autograd.grad`` call per leapfrog).

Adaptation (during tuning): dual-averaging step size targeting 0.8
acceptance (Hoffman & Gelman 2014, Algorithm 5) and a diagonal mass matrix
from a Welford variance estimate of the draws.

A row-sharded model's log-density is a ``ShardedLogp``: its observed part is
summed over the data group, so that every shard follows the same trajectory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .. import tracing
from ..parallel.mesh import RowShard, row_sum


@dataclasses.dataclass
class HmcState:
    theta: torch.Tensor            # float32[C, d] unconstrained parameters
    log_step: torch.Tensor         # float32[C] log step size
    # dual averaging state
    da_log_step_avg: torch.Tensor  # float32[C]
    da_h: torch.Tensor             # float32[C]
    da_count: torch.Tensor         # float32[C]
    # Welford for diagonal mass adaptation
    wf_count: torch.Tensor         # float32[C]
    wf_mean: torch.Tensor          # float32[C, d]
    wf_m2: torch.Tensor            # float32[C, d]
    inv_mass: torch.Tensor         # float32[C, d]


def init_state(theta0: torch.Tensor) -> HmcState:
    """``theta0`` (C, d) on the device the sampler runs on."""
    theta0 = theta0.to(torch.float32)
    C, _d = theta0.shape
    dev = theta0.device
    log01 = torch.full((C,), math.log(0.1), dtype=torch.float32, device=dev)
    zc = torch.zeros((C,), dtype=torch.float32, device=dev)
    return HmcState(
        theta=theta0, log_step=log01.clone(), da_log_step_avg=log01.clone(),
        da_h=zc.clone(), da_count=zc.clone(), wf_count=zc.clone(),
        wf_mean=torch.zeros_like(theta0), wf_m2=torch.zeros_like(theta0),
        inv_mass=torch.ones_like(theta0),
    )


@dataclasses.dataclass
class ShardedLogp:
    """The log-density of a model whose rows are sharded over a data group
    (JAX's ``_sum_over`` / ``_sum_grad_over`` pair): ``shared(theta)`` (C,)
    is the prior and the log-Jacobian, taken once; ``local(theta)`` (C,) the
    observed terms of this rank's rows."""

    shared: Callable
    local: Callable
    rows: RowShard


def value_and_grad(logp_fn: Callable, theta: torch.Tensor):
    """Per-chain log-density (C,) and its gradient (C, d).  For a
    ``ShardedLogp`` the local part's value and gradient (autograd, one rank's
    rows) are summed over the data group OUTSIDE autograd and ``vmap``, where
    a collective cannot run, and the shared part's are added once: every
    shard gets the same value and gradient."""
    if isinstance(logp_fn, ShardedLogp):
        v_s, g_s = value_and_grad(logp_fn.shared, theta)
        v_l, g_l = value_and_grad(logp_fn.local, theta)
        tot = row_sum(torch.cat([v_l[:, None], g_l], dim=1).to(torch.float64),
                      logp_fn.rows).to(theta.dtype)
        return v_s + tot[:, 0], g_s + tot[:, 1:]
    theta = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        val = logp_fn(theta)
        grad = (torch.autograd.grad(val.sum(), theta, allow_unused=True)[0]
                if val.requires_grad else None)
    if grad is None:     # a part of a ShardedLogp that theta does not enter
        grad = torch.zeros_like(theta)
    return val.detach(), grad


def adapt(state: HmcState, theta_new, accept_prob,
          target_accept: float) -> HmcState:
    """Dual averaging + Welford mass adaptation (shared with NUTS)."""
    mu = math.log(10.0) + math.log(0.1)
    count = state.da_count + 1.0
    kappa, gamma, t0 = 0.75, 0.05, 10.0
    eta = 1.0 / (count + t0)
    h = (1.0 - eta) * state.da_h + eta * (target_accept - accept_prob)
    log_step = mu - torch.sqrt(count) / gamma * h
    w = count ** (-kappa)
    log_step_avg = w * log_step + (1.0 - w) * state.da_log_step_avg
    wf_count = state.wf_count + 1.0
    delta = theta_new - state.wf_mean
    wf_mean = state.wf_mean + delta / wf_count[:, None]
    wf_m2 = state.wf_m2 + delta * (theta_new - wf_mean)
    var = wf_m2 / (wf_count - 1.0).clamp_min(1.0)[:, None]
    inv_mass = torch.where((wf_count > 50.0)[:, None], var.clamp_min(1e-6),
                           state.inv_mass)
    return HmcState(theta=theta_new, log_step=log_step,
                    da_log_step_avg=log_step_avg, da_h=h, da_count=count,
                    wf_count=wf_count, wf_mean=wf_mean, wf_m2=wf_m2,
                    inv_mass=inv_mass)


def hmc_step(gen: torch.Generator, state: HmcState, logp_fn: Callable,
             tuning: bool, max_leapfrog: int = 32,
             target_accept: float = 0.8):
    """One HMC transition per chain.  Returns (new_state, accept_prob (C,))."""
    theta = state.theta
    C, d = theta.shape
    dev = theta.device
    step = torch.exp(state.log_step)[:, None]
    inv_mass = state.inv_mass

    r0 = torch.randn((C, d), generator=gen, device=dev) / torch.sqrt(inv_mass)
    logp0, grad = value_and_grad(logp_fn, theta)
    h0 = logp0 - 0.5 * (r0 * r0 * inv_mass).sum(dim=1)
    n_steps = torch.randint(1, max_leapfrog + 1, (C,), generator=gen,
                            device=dev)
    u_acc = torch.rand((C,), generator=gen, device=dev)

    q, r, logp1 = theta, r0, logp0
    tracing.count("host_syncs")
    for i in range(int(n_steps.max())):     # one host sync per step
        do = (i < n_steps)[:, None]
        r_half = r + 0.5 * step * grad
        q_new = q + step * r_half * inv_mass
        logp_new, grad_new = value_and_grad(logp_fn, q_new)
        r_new = r_half + 0.5 * step * grad_new
        q = torch.where(do, q_new, q)
        r = torch.where(do, r_new, r)
        grad = torch.where(do, grad_new, grad)
        logp1 = torch.where(do[:, 0], logp_new, logp1)
    h1 = logp1 - 0.5 * (r * r * inv_mass).sum(dim=1)
    log_accept = (h1 - h0).clamp_max(0.0)
    log_accept = torch.where(torch.isfinite(log_accept), log_accept,
                             torch.full_like(log_accept, float("-inf")))
    accept_prob = torch.exp(log_accept)
    accept = torch.log(u_acc) < log_accept
    theta_new = torch.where(accept[:, None], q, theta)

    if tuning:
        new_state = adapt(state, theta_new, accept_prob, target_accept)
    else:
        new_state = dataclasses.replace(state, theta=theta_new)
    return new_state, accept_prob


def finalize_adaptation(state: HmcState) -> HmcState:
    """Freeze the dual-averaged step size at the end of tuning."""
    return dataclasses.replace(state, log_step=state.da_log_step_avg)
