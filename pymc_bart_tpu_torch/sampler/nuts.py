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

A doubling has static shapes and takes no host decision, so on a CUDA device
a fit's ``Graphs`` captures each depth's doubling once as a CUDA graph and
replays it (``nuts_step(..., graphs=...)``); the random numbers are drawn
outside the graphs, in the eager order, into buffers the graphs read, so
both ways give the same numbers.

``logp_fn`` maps ``theta (C, d)`` to per-chain log-densities ``(C,)``.
Step-size dual averaging and diagonal mass adaptation reuse ``hmc.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch

from .. import tracing
from .hmc import (HmcState, ShardedLogp, adapt,  # noqa: F401
                  finalize_adaptation, init_state, value_and_grad)

_DIVERGENCE = 1000.0

# False sends every transition down the eager path (tests compare the two)
_GRAPHS = True


@dataclasses.dataclass
class _Tree:
    """The trajectory a transition carries from one doubling to the next:
    both ends, the momentum sum, the proposal and its weight, the stop
    flags and the statistics, every field with a leading chain axis."""

    z_l: torch.Tensor
    z_r: torch.Tensor
    r_l: torch.Tensor
    r_r: torch.Tensor
    g_l: torch.Tensor
    g_r: torch.Tensor
    r_sum: torch.Tensor
    z_prop: torch.Tensor
    logp_prop: torch.Tensor
    log_w: torch.Tensor
    turning: torch.Tensor
    diverged: torch.Tensor
    sum_acc: torch.Tensor
    depth_c: torch.Tensor
    n_leaves: torch.Tensor

    def copy_(self, other: "_Tree"):
        for f in dataclasses.fields(self):
            getattr(self, f.name).copy_(getattr(other, f.name))


def _w2(mask, a, b):  # per-chain blend of (C, d) values
    return torch.where(mask[:, None], a, b)


def _open(logp_fn, theta, log_step, inv_mass, r0):
    """The transition's start from ``theta`` with standard normal draws
    ``r0``: the tree of one leaf, the initial energy ``h0`` and the step."""
    C = theta.shape[0]
    dev = theta.device
    step = torch.exp(log_step)
    r0 = r0 / torch.sqrt(inv_mass)
    logp0, grad0 = value_and_grad(logp_fn, theta)
    h0 = logp0 - 0.5 * (r0 * r0 * inv_mass).sum(dim=1)
    zero = torch.zeros((C,), device=dev)
    no = torch.zeros((C,), dtype=torch.bool, device=dev)
    none = torch.zeros((C,), dtype=torch.int32, device=dev)
    tree = _Tree(z_l=theta, z_r=theta, r_l=r0, r_r=r0, g_l=grad0, g_r=grad0,
                 r_sum=r0, z_prop=theta, logp_prop=logp0, log_w=zero,
                 turning=no, diverged=no, sum_acc=zero, depth_c=none,
                 n_leaves=none)
    return tree, h0, step


def build_subtree(logp_fn, z, r, grad, eps, depth, u_sel, h0, inv_mass,
                  leapfrog):
    """2^depth leapfrog steps from (z, r) for every chain; ``u_sel``
    (2^depth, C) the multinomial draws, ``leapfrog`` the span around each
    leapfrog."""
    C = z.shape[0]
    n_leaves = 2**depth
    neg_inf = torch.full((C,), float("-inf"), device=z.device)
    r_sum = torch.zeros_like(r)
    z_prop = z
    logp_prop = neg_inf
    log_w = neg_inf
    turning = torch.zeros((C,), dtype=torch.bool, device=z.device)
    diverged = torch.zeros((C,), dtype=torch.bool, device=z.device)
    sum_acc = torch.zeros((C,), device=z.device)
    r_first_ck = [None] * (depth + 1)
    rsum_ck = [None] * (depth + 1)
    e = eps[:, None]
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
        z_prop = _w2(take_new, z, z_prop)
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
    return (z, r, grad, r_sum, z_prop, logp_prop, log_w, turning, diverged,
            sum_acc)


def _double(logp_fn, t: _Tree, depth, u_go, u_bias, u_sel, h0, step,
            inv_mass, leapfrog) -> _Tree:
    """Doubling ``depth`` of every chain still running: a subtree of
    ``2^depth`` leaves to the side ``u_go < 0.5`` picks, merged into ``t``
    with the biased progressive sample (``u_bias``)."""
    active = ~(t.turning | t.diverged)
    go_right = u_go < 0.5
    eps = torch.where(go_right, step, -step)
    (z_e, r_e, g_e, r_sum_sub, z_ps, logp_ps, log_w_sub, turn_sub,
     div_sub, acc_sub) = build_subtree(
        logp_fn, _w2(go_right, t.z_r, t.z_l), _w2(go_right, t.r_r, t.r_l),
        _w2(go_right, t.g_r, t.g_l), eps, depth, u_sel, h0, inv_mass,
        leapfrog)

    left = active & ~go_right
    right = active & go_right
    r_l, r_r = _w2(left, r_e, t.r_l), _w2(right, r_e, t.r_r)

    # biased progressive sampling across the doubling
    neg_inf = torch.full_like(t.log_w, float("-inf"))
    ok = ~(turn_sub | div_sub)
    accept_sub = (torch.log(u_bias) < (log_w_sub - t.log_w)) & ok & active

    r_sum = _w2(active, t.r_sum + r_sum_sub, t.r_sum)
    v = r_sum * inv_mass
    turn_all = turn_sub | ((v * r_l).sum(dim=1) <= 0.0) \
        | ((v * r_r).sum(dim=1) <= 0.0)
    one = active.to(torch.int32)
    return _Tree(
        z_l=_w2(left, z_e, t.z_l), z_r=_w2(right, z_e, t.z_r),
        r_l=r_l, r_r=r_r,
        g_l=_w2(left, g_e, t.g_l), g_r=_w2(right, g_e, t.g_r),
        r_sum=r_sum,
        z_prop=_w2(accept_sub, z_ps, t.z_prop),
        logp_prop=torch.where(accept_sub, logp_ps, t.logp_prop),
        log_w=torch.where(
            active,
            torch.logaddexp(t.log_w, torch.where(ok, log_w_sub, neg_inf)),
            t.log_w),
        turning=torch.where(active, turn_all, t.turning),
        diverged=t.diverged | (div_sub & active),
        sum_acc=torch.where(active, t.sum_acc + acc_sub, t.sum_acc),
        depth_c=t.depth_c + one,
        n_leaves=t.n_leaves + one * (2**depth))


class _Block:
    """The buffers a fit's NUTS graphs read and write, at fixed addresses:
    the state's inputs, the random draws of a transition and the tree a
    doubling carries to the next."""

    def __init__(self, C: int, d: int, L: int, dev: torch.device):
        def f(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.theta, self.log_step, self.inv_mass = f(C, d), f(C), f(C, d)
        self.r0, self.u_go, self.u_bias = f(C, d), f(C), f(C)
        self.u_sel = f(2 ** (L - 1), C)
        self.h0, self.step = f(C), f(C)
        self.more = f(dtype=torch.bool)      # a chain still runs
        self.tree = _Tree(
            z_l=f(C, d), z_r=f(C, d), r_l=f(C, d), r_r=f(C, d),
            g_l=f(C, d), g_r=f(C, d), r_sum=f(C, d), z_prop=f(C, d),
            logp_prop=f(C), log_w=f(C), turning=f(C, dtype=torch.bool),
            diverged=f(C, dtype=torch.bool), sum_acc=f(C),
            depth_c=f(C, dtype=torch.int32),
            n_leaves=f(C, dtype=torch.int32))

    def doubling(self, logp_fn, depth: int, leapfrog):
        """Doubling ``depth`` on the block in place; depth 0 first opens
        the transition from ``theta``.  Capture-safe: no host decision, no
        copy from the host."""
        if depth == 0:
            t, h0, step = _open(logp_fn, self.theta, self.log_step,
                                self.inv_mass, self.r0)
            self.h0.copy_(h0)
            self.step.copy_(step)
        else:
            t, h0, step = self.tree, self.h0, self.step
        t = _double(logp_fn, t, depth, self.u_go, self.u_bias,
                    self.u_sel[: 2**depth], h0, step, self.inv_mass, leapfrog)
        self.tree.copy_(t)
        self.more.copy_((~(t.turning | t.diverged)).any())


class Graphs:
    """A fit's NUTS doublings as CUDA graphs, one a tree depth, captured the
    second time the fit reaches that depth (the first ran eagerly, which
    warms it up; a depth reached once, as deep trees early in tuning are,
    costs no capture) and replayed then and afterwards; depth 0's graph
    also opens the transition.
    Every graph shares one private memory pool and the buffers of one
    ``_Block``.  A capture that fails sends the rest of the fit down the
    eager path.  ``close`` drops the graphs and their memory.

    The ``logp_fn`` given with it must be one object for the fit and read
    its other inputs from tensors whose addresses stay fixed; another
    ``logp_fn``, chain count, dimension or depth limit starts afresh."""

    def __init__(self):
        self.failed = False
        self.close()

    def close(self):
        self._graphs = {}
        self._ran = set()        # depths run eagerly once
        self._block = None
        self._key = None
        self._pool = self._stream = None

    def _prepare(self, state: HmcState, logp_fn, L: int) -> _Block:
        theta = state.theta
        key = (logp_fn, tuple(theta.shape), L, theta.device)
        if self._key != key:
            self.close()
            self._key = key
            self._block = _Block(*theta.shape, L, theta.device)
        blk = self._block
        blk.theta.copy_(theta)
        blk.log_step.copy_(state.log_step)
        blk.inv_mass.copy_(state.inv_mass)
        return blk

    def _capture(self, logp_fn, depth: int):
        """Doubling ``depth`` captured (captured work does not run: the
        block is left as it is), or None where the capture failed: the fit
        then runs eagerly from here."""
        if self._stream is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device=self._block.theta.device)
        g = torch.cuda.CUDAGraph()
        here = torch.cuda.current_stream(self._stream.device)
        self._stream.wait_stream(here)
        try:
            with tracing.span("nuts_capture"), \
                    torch.cuda.stream(self._stream):
                g.capture_begin(pool=self._pool)
                try:
                    self._block.doubling(logp_fn, depth,
                                         contextlib.nullcontext())
                finally:
                    g.capture_end()
        except RuntimeError:
            self.failed = True
            self._graphs = {}
            return None
        here.wait_stream(self._stream)
        self._graphs[depth] = g
        tracing.count("nuts_graph_captures")
        return g

    def run(self, gen, state: HmcState, logp_fn, L: int):
        """The doublings of one transition, drawing from ``gen`` in the
        eager path's order: ``(tree, step, doublings)``, the tree's fields
        that outlive the transition copied out of the block."""
        blk = self._prepare(state, logp_fn, L)
        blk.r0.normal_(generator=gen)
        doublings = 0
        for depth in range(L):
            # every chain runs the first doubling; the check a doubling
            # after it is the one host sync
            if depth and not bool(blk.more):
                break
            doublings += 1
            blk.u_go.uniform_(generator=gen)
            blk.u_bias.uniform_(generator=gen)
            blk.u_sel[: 2**depth].uniform_(generator=gen)
            g = self._graphs.get(depth)
            if g is None and depth in self._ran and not self.failed:
                g = self._capture(logp_fn, depth)
            if g is not None:
                leapfrogs = tracing.span("nuts_leapfrog").start()
                g.replay()
                leapfrogs.stop(calls=2**depth)
                tracing.count("nuts_graph_replays")
                continue
            blk.doubling(logp_fn, depth, tracing.span("nuts_leapfrog"))
            tracing.count("nuts_eager_doublings")
            self._ran.add(depth)
        tracing.count("host_syncs", doublings - 1 + (doublings < L))
        t = blk.tree
        t = dataclasses.replace(
            t, z_prop=t.z_prop.clone(), diverged=t.diverged.clone(),
            depth_c=t.depth_c.clone(), n_leaves=t.n_leaves.clone())
        return t, blk.step.clone(), doublings


def _graph_path(device: torch.device, logp_fn, graphs: Optional[Graphs]):
    """Whether a transition runs as CUDA graphs: a CUDA state, a fit's
    ``Graphs`` whose capture has not failed, and a log-density without a
    collective (a ``ShardedLogp`` sums its rows over the data group outside
    autograd)."""
    return (_GRAPHS and graphs is not None and not graphs.failed
            and device.type == "cuda"
            and not isinstance(logp_fn, ShardedLogp))


@tracing.spanned("nuts_step")
def nuts_step(gen: torch.Generator, state: HmcState, logp_fn: Callable,
              tuning: bool, max_tree_depth: int = 8,
              target_accept: float = 0.8, full_stats: bool = False,
              graphs: Optional[Graphs] = None):
    """One NUTS transition per chain.

    Returns (new_state, accept_prob (C,)), or with ``full_stats=True``
    (new_state, dict) carrying per-chain sampler statistics (accept,
    diverging, tree_depth, n_steps, step_size, energy).  ``graphs``: the
    fit's ``Graphs``, with which a transition on a CUDA device replays its
    doublings as CUDA graphs (``_graph_path``); the draws and results are
    those of the eager path.
    """
    theta = state.theta
    C, d = theta.shape
    dev = theta.device
    L = max_tree_depth

    if _graph_path(dev, logp_fn, graphs):
        t, step, doublings = graphs.run(gen, state, logp_fn, L)
    else:
        def rand(*shape):
            return torch.rand(shape, generator=gen, device=dev)

        r0 = torch.randn((C, d), generator=gen, device=dev)
        t, h0, step = _open(logp_fn, theta, state.log_step, state.inv_mass,
                            r0)
        leapfrog = tracing.span("nuts_leapfrog")
        doublings = 0
        for depth in range(L):
            # the one host sync per doubling
            if not bool((~(t.turning | t.diverged)).any()):
                break
            doublings += 1
            u_go, u_bias = rand(C), rand(C)
            t = _double(logp_fn, t, depth, u_go, u_bias, rand(2**depth, C),
                        h0, step, state.inv_mass, leapfrog)
        # a check a doubling entered, one more where the loop stopped early
        tracing.count("host_syncs", doublings + (doublings < L))
        tracing.count("nuts_eager_doublings", doublings)
    # the leapfrogs run for all chains at once
    tracing.count("nuts_leapfrogs", 2**doublings - 1)

    theta_new = t.z_prop
    accept_prob = t.sum_acc / t.n_leaves.to(torch.float32).clamp_min(1.0)

    if tuning:
        new_state = adapt(state, theta_new, accept_prob, target_accept)
    else:
        new_state = dataclasses.replace(state, theta=theta_new)
    if full_stats:
        stats = {
            "accept": accept_prob,
            "diverging": t.diverged,
            "tree_depth": t.depth_c,
            "n_steps": t.n_leaves,
            "step_size": step,
            "energy": -t.logp_prop,
        }
        return new_state, stats
    return new_state, accept_prob
