"""PGBART: the particle-Gibbs BART step, batched over chains (PyTorch).

Counterpart of ``pymc_bart_tpu/sampler/pgbart.py`` for the closed-form
likelihood codes (gauss, bernoulli, het_abs, het_exp, cat_logit) with one
output and the generic model likelihood (``lik="generic"``: a ``loglik_fn``
closure over the model, any number of outputs), each with the constant,
linear and mix responses.  ``pgbart_step`` is the counterpart of
``_pgbart_step_dispatch``; it has three routes:

* ``"bign"``: the whole step in the large-n formulation (``ops/bign.py``:
  rows spread over the card, node-space sufficient statistics for the
  Gaussian code, row Gumbels generated inside the kernel), taken where its
  gate admits the configuration and a chain's rows do not fit the shared
  memory of the whole-step kernel's cluster (``fused_rows_on_chip``);
* ``"fused"``: the whole step in one launch (``ops/draw.py``: a thread-block
  cluster per chain, row Gumbels generated inside the kernel too), taken
  wherever else its gate admits the configuration;
* ``"rounds"``: per tree ``D`` growth rounds (``ops/grow.py``), ``D-1`` SMC
  resampling steps (``ops/smc.py``) and one winner selection with Metropolis
  leaf refinement (``ops/select.py``), then the forest and sum-of-trees
  commit and, while tuning, the split-prior and Welford ``leaf_sd``
  adaptation (``step_rounds``).  With ``impl="plain"`` this route is the
  plain version of the fused one.  The selection kernel is Gaussian, for the
  constant, linear and mix responses; the other codes select and refine in
  plain PyTorch on every device, as the JAX package does in XLA (a linear or
  mix winner's prediction keeps its slope term).  The linear
  and mix responses, the generic likelihood and joint forests of ``k >= 2``
  outputs run here alone (both whole-step gates refuse them); for the
  generic likelihood each round's particle log-likelihood is the model's,
  evaluated batched over chains and particles (``batched_loglik``).

Chains are a leading tensor axis ``C`` where the JAX package uses ``vmap``.
The step TAKES its random numbers (``StepRands``) as an argument, in the
layout of ``pymc_bart_tpu/ops/draw_pallas.py::_rands_reference`` with the
tree axis first and the chain axis second; ``draw_rands`` makes one step's
blocks from a ``torch.Generator``.  Tests feed the JAX package's own blocks.

With ``PgbartConfig(ancestor_sampling=True)`` and the constant response,
every route is followed by the retained-path rejuvenation sweeps of
``sampler/rejuvenate.py`` (plain PyTorch on the returned state; their random
numbers are ``pgbart_step``'s argument ``rejuv``).

Row sharding (``rows``: a ``parallel.mesh.RowShard``, JAX's ``data_axis``):
X, the targets, the row data and every per-row field of the state hold this
rank's rows; the tree state is replicated.  The step then takes the
per-round route with the plain growth round (``ops.grow.grow_round_plain``
reduces the child statistics, the split-value winner and the likelihood
sums over the data group, as the JAX package's XLA round does with its
Pallas kernels off), the SMC resampling of the replicated weights, and a
plain selection whose sums are reduced too.  The node-space Gaussian mode
(``suff_stats``, JAX's ``suff_gauss``: per-node count, sum r and sum r^2,
no row pass until the winner's prediction) serves a scalar precision there
and, unsharded, the plain per-round route from ``NODE_SPACE_ROWS`` rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import tracing
from ..config import BartConfig, PgbartConfig
from ..ops import bign as _bign
from ..ops import draw as _draw
from ..ops.grow import fixed_moments, grow_round, grow_round_plain, node_ll
from ..ops.predict import tree_predict
from ..ops.select import select_refine, select_refine_nodes, select_refine_plain
from ..ops.smc import smc_resample
from ..ops.sums import (FIXED_BITS, alpha_cdf_of, chain_exponent, from_fixed,
                        pow2, sum64, true_div)
from ..ops.trees import Forest, init_forest, rules_all_continuous
from ..parallel.mesh import row_sum
from .rejuvenate import RejuvRands, gumbel, rejuvenate_forest

# rows from which the plain per-round route takes the node-space Gaussian
# mode by itself (JAX's _SEG_MATMUL_N gate of suff_gauss)
NODE_SPACE_ROWS = 16384


@dataclasses.dataclass
class PgbartState:
    """Carried sampler state of one BART variable, all chains (axis 0)."""

    forest: Forest            # (C, m, S) tensors; leaf (C, m, S, k)
    tree_pred: torch.Tensor   # float32[C, m, n, k] cached per-tree predictions
    sum_trees: torch.Tensor   # float32[C, n, k]
    alpha_vec: torch.Tensor   # float32[C, p] adaptive split-variable weights
    leaf_sd: torch.Tensor     # float32[C, k] leaf-value proposal scale
    # Welford accumulator over per-tree predictions, for leaf_sd adaptation
    wf_count: torch.Tensor    # float32[C]
    wf_mean: torch.Tensor     # float32[C, n, k]
    wf_m2: torch.Tensor       # float32[C, n, k]
    batch_offset: torch.Tensor  # int32[C] rotating tree pointer
    iteration: torch.Tensor   # int32[C] Gibbs iterations done

    # the per-row fields and their row axes (one shard's rows under row
    # sharding; not a dataclass field)
    ROW_AXES = {"tree_pred": 2, "sum_trees": 1, "wf_mean": 1, "wf_m2": 1}

    def clone(self) -> "PgbartState":
        out = {f.name: getattr(self, f.name).clone()
               for f in dataclasses.fields(self)}
        return PgbartState(**out)


@dataclasses.dataclass
class StepRands:
    """Random blocks of one step: ``B`` trees, ``C`` chains.

    ``rg`` holds Gumbel draws, or is ``None`` when they are to be generated
    from ``seed`` (inside the kernel on the ``"bign"`` and ``"fused"`` routes,
    written out by the same generator for the ``"rounds"`` route); ``epsr`` is UNSCALED
    standard normal (the step multiplies by ``0.3 * leaf_sd``); ``sb`` is the
    ``int32`` bit pattern of the JAX ``uint32`` salts.  ``umix`` and ``gsel``
    are drawn for the linear and mix responses only (``draw_rands(response=
    ...)``): the children's slope coins and the winner's Gumbels (the winner
    is ``argmax(log_w + gsel)``, ``jax.random.categorical``); that route's
    refinement reads ``epsr``/``uacc`` and no ``usel``.
    """

    ug: torch.Tensor    # float32[B, C, P, Gtot] grow uniforms
    uv: torch.Tensor    # float32[B, C, P, Gtot] split-variable uniforms
    rg: Optional[torch.Tensor]  # float32[B, D, C, P, n] row Gumbels
    eps: torch.Tensor   # float32[B, C, P, k, 2*Gtot] child leaf normals
    sb: torch.Tensor    # int32[B, C, P, Gtot] subset-rule salts
    ures: torch.Tensor  # float32[B, D, C] resampling uniforms
    usel: torch.Tensor  # float32[B, C] selection uniforms
    epsr: torch.Tensor  # float32[B, C, R, k, S] refinement normals
    uacc: torch.Tensor  # float32[B, C, R] refinement accept uniforms
    # int32[2]: the 64-bit seed of the in-kernel row Gumbels, on the device
    seed: Optional[torch.Tensor] = None
    umix: Optional[torch.Tensor] = None  # float32[B, C, P, 2*Gtot]
    gsel: Optional[torch.Tensor] = None  # float32[B, C, P] winner Gumbels
    # where these chains and rows sit among all of them: the generated row
    # Gumbels are keyed by the global chain and row (``shard``)
    chains: Optional[int] = None  # every chain of the draw (None: C)
    chain0: int = 0
    row0: int = 0

    # the chain axis of each block (the rows of rg are its last axis)
    _CHAIN_AXIS = {"ug": 1, "uv": 1, "rg": 2, "eps": 1, "sb": 1, "ures": 2,
                   "usel": 1, "epsr": 1, "uacc": 1, "umix": 1, "gsel": 1}

    def shard(self, chains: slice, rows: Optional[slice] = None
              ) -> "StepRands":
        """The blocks of the chains ``chains`` (and the row Gumbels of the
        rows ``rows``) out of blocks drawn for every chain: a rank of a mesh
        draws all chains' numbers and keeps its own, so its chains get what
        an unsharded run gives them."""
        out = {}
        for name, ax in self._CHAIN_AXIS.items():
            a = getattr(self, name)
            if a is not None:
                a = a.narrow(ax, chains.start, chains.stop - chains.start)
                if name == "rg" and rows is not None:
                    a = a[..., rows]
                a = a.contiguous()
            out[name] = a
        return dataclasses.replace(
            self, **out, chains=self.usel.shape[1] if self.chains is None
            else self.chains, chain0=self.chain0 + chains.start,
            row0=self.row0 + (0 if rows is None else rows.start))


def init_state(X, Y_target, cfg: BartConfig, split_prior=None, *,
               chains: int, device, rows=None) -> PgbartState:
    """Initial all-root-leaf state, replicated over ``chains``.

    Each tree starts as a single leaf predicting mean(Y)/m, so the initial
    sum of trees equals Y.mean(); leaf_sd starts at std(Y)/sqrt(m).  With
    ``rows`` (``X`` and ``Y_target`` this rank's rows) the mean, the variance
    and the root count are those of every shard's rows (float64 sums over
    the data group), so every shard starts from the same tree state.
    """
    device = torch.device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    n, p = X.shape
    k = cfg.n_outputs
    C = chains
    Y = torch.as_tensor(Y_target, dtype=torch.float32,
                        device=device).reshape(n, k)
    if rows is None:
        y_mean = Y.mean(dim=0)
        y_sd = Y.std(dim=0, unbiased=False)
    else:
        Y64 = Y.to(torch.float64)
        mean64 = row_sum(Y64.sum(dim=0), rows) / rows.n_total
        var64 = row_sum(((Y64 - mean64) ** 2).sum(dim=0), rows) / rows.n_total
        y_mean, y_sd = mean64.to(torch.float32), var64.sqrt().to(torch.float32)
    f1 = init_forest(cfg.m, cfg.n_nodes, k, y_mean / cfg.m,
                     n if rows is None else rows.n_total, device)
    forest = Forest(*(getattr(f1, f.name).unsqueeze(0).repeat(
        (C,) + (1,) * getattr(f1, f.name).dim())
        for f in dataclasses.fields(f1)))
    if split_prior is None or len(split_prior) == 0:
        alpha_vec = torch.ones((p,), dtype=torch.float32, device=device)
    else:
        alpha_vec = torch.as_tensor(split_prior, dtype=torch.float32,
                                    device=device)
    leaf_sd = y_sd / float(cfg.m) ** 0.5
    leaf_sd = leaf_sd.clamp_min(1e-6)

    def rep(a):
        return a.unsqueeze(0).repeat((C,) + (1,) * a.dim()).contiguous()

    zero_nk = torch.zeros((C, n, k), dtype=torch.float32, device=device)
    return PgbartState(
        forest=forest,
        tree_pred=rep((y_mean / cfg.m).expand(cfg.m, n, k)),
        sum_trees=rep(y_mean.expand(n, k)),
        alpha_vec=rep(alpha_vec),
        leaf_sd=rep(leaf_sd),
        wf_count=torch.zeros((C,), dtype=torch.float32, device=device),
        wf_mean=zero_nk.clone(),
        wf_m2=zero_nk.clone(),
        batch_offset=torch.zeros((C,), dtype=torch.int32, device=device),
        iteration=torch.zeros((C,), dtype=torch.int32, device=device),
    )


@tracing.spanned("draw_rands")
def draw_rands(gen: torch.Generator, *, B: int, C: int, P: int, D: int,
               n: int, k: int, S: int, num_refinements: int,
               device, row_gumbels: bool = True,
               response: str = "constant") -> StepRands:
    """One step's random blocks from ``gen`` (which lives on ``device``).

    ``row_gumbels=False`` leaves out the (B, D, C, P, n) Gumbel block, the
    only one that grows with ``n``, and draws a 64-bit ``seed`` instead, from
    which the ``"bign"`` and ``"fused"`` routes generate the same block inside
    their kernels (the ``"rounds"`` route and the whole-step function's plain
    version write it out first).  ``response`` other than ``"constant"``
    adds ``umix`` and ``gsel``, drawn after the other blocks."""
    Gtot = 2**D - 1
    R = max(num_refinements, 1)
    f32 = torch.float32

    def unif(*shape):
        return torch.rand(shape, generator=gen, device=device, dtype=f32)

    def norm(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=f32)

    rg = seed = None
    if row_gumbels:
        rg = gumbel(gen, (B, D, C, P, n), device)
    else:
        seed = torch.randint(-2**31, 2**31, (2,), generator=gen, device=device,
                             dtype=torch.int64).to(torch.int32)
    bits = torch.randint(0, 2**32, (B, C, P, Gtot), generator=gen,
                         device=device, dtype=torch.int64)
    sb = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    if num_refinements > 0:
        epsr, uacc = norm(B, C, R, k, S), unif(B, C, R)
    else:
        epsr = torch.zeros((B, C, R, k, S), dtype=f32, device=device)
        uacc = torch.ones((B, C, R), dtype=f32, device=device)
    out = StepRands(ug=unif(B, C, P, Gtot), uv=unif(B, C, P, Gtot), rg=rg,
                    eps=norm(B, C, P, k, 2 * Gtot), sb=sb,
                    ures=unif(B, D, C), usel=unif(B, C), epsr=epsr,
                    uacc=uacc, seed=seed)
    if response != "constant":
        out.umix, out.gsel = (unif(B, C, P, 2 * Gtot),
                              gumbel(gen, (B, C, P), device))
    return out


def closed_form_ll(lik: str, lik_const: float, F, y, row):
    """Per-row log-likelihood terms of a non-Gaussian code at the sum-of-trees
    value ``F`` (the closed forms of ``pymc_bart_tpu/sampler/pgbart.py``
    ``eval_ll``); ``y`` and ``row`` broadcast against ``F``."""
    if lik == "bernoulli":
        return y * F - (F.clamp_min(0.0) + torch.log1p(torch.exp(-F.abs())))
    if lik == "het_abs":
        sg = F.abs() + lik_const
        return -0.5 * row / (sg * sg) - torch.log(sg)
    if lik == "het_exp":
        return -0.5 * row * torch.exp(-2.0 * F) - F
    if lik == "cat_logit":
        lse = torch.maximum(F, row) + torch.log1p(torch.exp(-(F - row).abs()))
        return (y > 0).to(F.dtype) * F - lse
    raise ValueError(f"no closed form for likelihood code {lik!r}")


GENERIC = "generic"


def batched_loglik(loglik_fn, lik_params):
    """The model log-likelihood of ``Q`` candidate values a chain:
    ``ll(F (C, Q, n, k)) -> (C, Q)``.

    ``loglik_fn(f (n, k), lik_params) -> scalar`` is one chain's closure
    (``sampler.compound.make_loglik``, the counterpart of JAX's
    ``_make_loglik``); ``lik_params`` holds every chain's values on a leading
    axis ``C`` (``(theta (C, d), {name: (C, n, k)})``).  One ``vmap`` over
    the candidates inside one over the chains: the whole batch is one
    evaluation of the model's expressions, with no host synchronisation."""
    inner = torch.func.vmap(loglik_fn, in_dims=(0, None))
    outer = torch.func.vmap(inner, in_dims=(0, 0))
    return lambda F: outer(F, lik_params)


def make_ll_of(lik: str, lik_const: float, row, Y, loglik_fn=None,
               lik_params=None, rows=None):
    """The model log-likelihood ``ll_of(sum_noi, pred) -> (C,)`` of one
    tree's prediction ``pred`` (C, n, k) beside the other trees' sum
    ``sum_noi``, in the closed form of the SMC weights (JAX's
    ``_make_ll_of``): ``row`` is the code's row data (C, n, k) (the Gaussian
    precision, ``None`` for ``"bernoulli"``), ``Y`` the target (C|1, n, k).
    ``lik="generic"``: the model's own, ``loglik_fn`` at ``lik_params``
    (``batched_loglik``).  With ``rows`` the closed forms' row sums are
    reduced over the data group."""
    if lik == GENERIC:
        ll = batched_loglik(loglik_fn, lik_params)

        def ll_of(sum_noi, pred):
            return ll((sum_noi + pred)[:, None])[:, 0]
    elif lik == "gauss":
        def ll_of(sum_noi, pred):
            diff = (Y - sum_noi) - pred
            return -0.5 * sum64((row * diff * diff).flatten(1), rows=rows)
    else:
        def ll_of(sum_noi, pred):
            return sum64(closed_form_ll(lik, lik_const, sum_noi + pred, Y,
                                        row).flatten(1), rows=rows)
    return ll_of


def _update_one_tree(b: int, rands: StepRands, tree: Forest, resid, alpha_vec,
                     leaf_sd, X, rules, cfg: BartConfig, pg: PgbartConfig,
                     gauss_w, impl: Optional[str], lik: str = "gauss",
                     lik_const: float = 0.0, sum_noi=None, Y=None,
                     loglik=None, rows=None, node_space: bool = False):
    """Conditional SMC for tree ``b`` of the batch, all chains.

    ``tree`` holds (C, S[, k]) tensors; ``resid``/``gauss_w`` (C, n, k).
    For a non-Gaussian code the particle log-likelihood after each round is
    the closed form on ``sum_noi (C, n, k) + pred`` with the labels ``Y``
    (C|1, n, k), for ``lik="generic"`` the model's own ``loglik`` (the
    ``batched_loglik`` of the model closure) on the same sum (the growth
    round's Gaussian value is ignored: it is given zero row weights), and the
    winner is refined under the same likelihood, in plain PyTorch, for every
    output.  For the linear and mix responses the rounds draw slopes; a
    Gaussian winner is selected among the particles by its Gumbels
    ``rands.gsel``, another likelihood's by inverse CDF on ``rands.usel``.
    ``rows``: the rows are this rank's of a row-sharded model (plain growth
    rounds and selection with their sums reduced over the data group).
    ``node_space``: the Gaussian node-space mode (one precision a chain,
    ``gauss_w[:, 0, 0]``; k = 1, constant response): the particles carry
    per-node (count, sum r, sum r^2) in fixed point and are weighted by
    ``ops.grow.node_ll``; the winner and its refinement are
    ``select_refine_nodes``.
    Returns ``(sv, sl, st (C, S), leaf (C, S, k), ct (C, S), slope (C, S, k),
    pred (C, n, k))``.
    """
    P = pg.num_particles
    S = cfg.n_nodes
    n, _p = X.shape
    n_glob = n if rows is None else rows.n_total
    k = cfg.n_outputs
    D = cfg.max_depth
    C = resid.shape[0]
    dev = resid.device
    f32, i32 = torch.float32, torch.int32

    # particle 0 = frozen copy of the current tree; the others = root leaves
    def broadcast0(old, fresh):
        return torch.cat([old[:, None], fresh[:, None].expand(
            (C, P - 1) + fresh.shape[1:])], dim=1).contiguous()

    residT = resid.transpose(1, 2).contiguous()                   # (C, k, n)
    if node_space:
        # the root's statistics in fixed point, over every shard's rows
        e_r = chain_exponent(resid, rows)
        q_r, q_q = fixed_moments(residT, e_r)
        root_r = row_sum(q_r[:, 0].sum(dim=1), rows)              # (C,)
        root_q = row_sum(q_q[:, 0].sum(dim=1), rows)
        root_mu = true_div(true_div(
            from_fixed(root_r, pow2(e_r - FIXED_BITS))[:, None], n_glob),
            cfg.m)                                                # (C, k)
    else:
        root_mu = true_div(true_div(sum64(resid, dim=1, rows=rows), n_glob),
                           cfg.m)                                 # (C, k)
    sv = broadcast0(tree.split_var, torch.full((C, S), -1, dtype=i32,
                                               device=dev))
    sl = broadcast0(tree.split_val, torch.zeros((C, S), dtype=f32,
                                                device=dev))
    st = broadcast0(tree.split_set, torch.zeros((C, S), dtype=i32,
                                                device=dev))
    fresh_lf = torch.zeros((C, k, S), dtype=f32, device=dev)
    fresh_lf[:, :, 0] = root_mu
    lf = broadcast0(tree.leaf.transpose(1, 2), fresh_lf)          # (C,P,k,S)
    fresh_ct = torch.zeros((C, S), dtype=f32, device=dev)
    fresh_ct[:, 0] = float(n_glob)
    ct = broadcast0(tree.count, fresh_ct)
    sp = broadcast0(tree.slope.transpose(1, 2),
                    torch.zeros((C, k, S), dtype=f32, device=dev))
    leaf_idx = torch.zeros((C, P, n), dtype=i32, device=dev)
    frozen = torch.zeros((C, P), dtype=i32, device=dev)
    frozen[:, 0] = 1
    ident = torch.arange(P, dtype=i32, device=dev).expand(C, P).contiguous()

    alpha_cdf = alpha_cdf_of(alpha_vec)
    gauss = lik == "gauss"
    generic = lik == GENERIC
    lin = cfg.response != "constant"
    if lin and (rands.umix is None or rands.gsel is None):
        raise ValueError(f"response={cfg.response!r}: rands lacks umix and "
                         "gsel (draw_rands(response=...))")
    if gauss:
        llwT = gauss_w.transpose(1, 2).contiguous()
    else:
        llwT = torch.zeros((C, k, n), dtype=f32, device=dev)
        noiT = sum_noi.transpose(1, 2)                            # (C, k, n)
        yT = Y.transpose(1, 2)                                    # (C|1,k,n)
        rowT = (gauss_w.transpose(1, 2) if gauss_w is not None else None)

    def eval_ll(pred_all):
        """(C, P, k, n) or (C, k, n) predictions -> log-likelihood."""
        lead = pred_all.dim() == 4
        if generic:
            F = (noiT[:, None] if lead else noiT) + pred_all
            if lead:
                return loglik(F.transpose(-1, -2))
            return loglik(F.transpose(-1, -2)[:, None])[:, 0]
        if gauss:
            r_, w_ = (residT[:, None], llwT[:, None]) if lead else (residT,
                                                                    llwT)
            diff = r_ - pred_all
            return -0.5 * sum64((w_ * diff * diff).flatten(-2), rows=rows)
        noi_, y_ = (noiT[:, None], yT[:, None]) if lead else (noiT, yT)
        row_ = None if rowT is None else (rowT[:, None] if lead else rowT)
        return sum64(closed_form_ll(lik, lik_const, noi_ + pred_all, y_,
                                    row_).flatten(-2), rows=rows)

    if node_space:
        stats = (torch.zeros((C, P, S), dtype=f32, device=dev),
                 torch.zeros((C, P, S), dtype=torch.int64, device=dev),
                 torch.zeros((C, P, S), dtype=torch.int64, device=dev),
                 torch.zeros((C, P, S), dtype=torch.bool, device=dev))
        stats[0][:, :, 0] = float(n_glob)
        stats[1][:, :, 0] = root_r[:, None]
        stats[2][:, :, 0] = root_q[:, None]
        stats[3][:, :, 0] = True
        w_chain = gauss_w[:, 0, 0]
        pred = None
        ll = node_ll(lf, *stats, w_chain, e_r)
    else:
        # all rows sit at the root: prediction = root leaf value
        pred = lf[:, :, :, 0:1].expand(C, P, k, n).contiguous()
        ll = eval_ll(pred)                                        # (C, P)
    log_w = ll
    ll_prev = ll
    take = ident

    for d in range(D):
        off = 2**d - 1
        G = 2**d
        args = (take, frozen, sv, sl, st, lf, ct, sp, leaf_idx, pred,
                X, residT, rules, alpha_cdf, leaf_sd, llwT,
                rands.ug[b, :, :, off:off + G], rands.uv[b, :, :, off:off + G],
                rands.rg[b, d], rands.eps[b, :, :, :, 2 * off:2 * off + 2 * G],
                rands.sb[b, :, :, off:off + G],
                rands.umix[b, :, :, 2 * off:2 * off + 2 * G] if lin else None)
        if node_space:
            (sv, sl, st, lf, ct, sp, leaf_idx, pred, ll,
             stats) = grow_round_plain(*args, d=d, cfg=cfg, rows=rows,
                                       node_stats=stats)
        elif rows is not None:
            # the row-sharded round is the plain one with its sums reduced
            # (the JAX package turns its Pallas kernels off there too)
            sv, sl, st, lf, ct, sp, leaf_idx, pred, ll = grow_round_plain(
                *args, d=d, cfg=cfg, rows=rows)
        else:
            sv, sl, st, lf, ct, sp, leaf_idx, pred, ll = grow_round(
                *args, d=d, cfg=cfg, impl=impl)
        if not gauss:
            ll = eval_ll(pred)
        take = ident
        if d < D - 1:
            # weight update + ESS-gated systematic resampling; the ancestor
            # gather is folded into the next growth round through `take`
            log_w, take, ll_prev = smc_resample(
                ll, ll_prev, log_w, rands.ures[b, d], impl=impl)
        else:
            log_w = log_w + ll - ll_prev

    R = max(pg.num_refinements, 1)
    eps_r = rands.epsr[b]                                         # (C,R,k,S)
    if pg.num_refinements > 0:
        eps_r = eps_r * (0.3 * leaf_sd)[:, None, :, None]
    # one prior scale a chain for one output (the kernel's), one an output
    # for a joint forest
    hiv = (0.5 / (leaf_sd[:, 0] * leaf_sd[:, 0]) if k == 1
           else 0.5 / (leaf_sd * leaf_sd))
    if node_space:
        sv_w, sl_w, st_w, lf_w, ct_w, _li_w, pred_w = select_refine_nodes(
            sv, sl, st, lf, ct, leaf_idx, stats, log_w, w_chain, e_r,
            eps_r.contiguous(), rands.uacc[b], rands.usel[b], hiv,
            num_refinements=R, m=cfg.m)
        return (sv_w, sl_w, st_w, lf_w.transpose(1, 2), ct_w,
                torch.zeros_like(lf_w.transpose(1, 2)), pred_w.transpose(1, 2))
    args = (sv, sl, st, lf, ct, leaf_idx, pred, log_w, residT, llwT,
            eps_r.contiguous(), rands.uacc[b], rands.usel[b], hiv)
    if gauss and lin:
        sv_w, sl_w, st_w, lf_w, ct_w, sp_w, _li_w, pred_w = select_refine(
            *args, num_refinements=R, m=cfg.m, impl=impl,
            response=cfg.response, sp=sp, X=X, g_sel=rands.gsel[b])
        sp_w = sp_w.transpose(1, 2)
    elif gauss:
        if rows is None:
            sv_w, sl_w, st_w, lf_w, ct_w, _li_w, pred_w = select_refine(
                *args, num_refinements=R, m=cfg.m, impl=impl)
        else:
            sv_w, sl_w, st_w, lf_w, ct_w, _li_w, pred_w = select_refine_plain(
                *args, num_refinements=R, m=cfg.m, rows=rows)
        sp_w = torch.zeros_like(lf_w.transpose(1, 2))
    else:
        # the other likelihoods' winner and refinement are plain PyTorch on
        # every device, as the JAX package runs them in XLA (its fused_other
        # branch and its generic one; the winner by inverse CDF on usel, the
        # proposals from epsr / uacc: the distribution of JAX's
        # categorical and key-drawn normals, from the step's blocks); a
        # linear or mix winner's refinement moves intercepts only and its
        # prediction keeps the slope term
        out = select_refine_plain(*args, num_refinements=R, m=cfg.m,
                                  ll_fn=eval_ll, response=cfg.response,
                                  sp=sp, X=X, rows=rows)
        sv_w, sl_w, st_w, lf_w, ct_w = out[:5]
        pred_w = out[-1]
        sp_w = (out[5].transpose(1, 2) if lin
                else torch.zeros_like(lf_w.transpose(1, 2)))
    return (sv_w, sl_w, st_w, lf_w.transpose(1, 2), ct_w, sp_w,
            pred_w.transpose(1, 2))


def split_var_counts(forest: Forest, p: int) -> torch.Tensor:
    """Histogram of splitting variables over all internal nodes: float32[C, p]
    (the per-draw ``variable_inclusion`` statistic)."""
    sv = forest.split_var.reshape(forest.split_var.shape[0], -1)
    ar = torch.arange(p, dtype=sv.dtype, device=sv.device)
    return (sv[:, :, None] == ar).to(torch.float32).sum(dim=1)


ROUTES = ("bign", "fused", "rounds")


def fused_rows_on_chip(cfg: BartConfig, pg: PgbartConfig, X,
                       chains: int) -> bool:
    """Whether the whole-step kernel would keep a chain's rows in its
    cluster's shared memory (``ops.draw.launch_plan``: the ``"shared"`` form).
    There it is the faster of the two whole-step kernels; where the rows stay
    in global memory the large-n kernel is (the crossover table of
    ``chip_smoke.py``, phase ``timing``, holds the rule to the card)."""
    n, p = X.shape
    plan = _draw.launch_plan(chains, pg.num_particles, cfg.max_depth,
                             cfg.n_nodes, n, p, max(pg.num_refinements, 1))
    return not isinstance(plan, str) and plan.form == "shared"


def resolve_route(route: Optional[str], cfg: BartConfig, pg: PgbartConfig, X,
                  gauss_w, lik: str, *, chains: int, w_scalar: bool,
                  all_cont: bool, x_nan: bool, rows=None):
    """``(route taken, {route: why not})`` for one PGBART step.

    ``route=None``: ``"bign"`` when its gate admits the configuration and the
    whole-step kernel would not keep the rows on chip (``fused_rows_on_chip``),
    else ``"fused"`` where its gate admits it, else ``"rounds"``.  A named
    route is taken or raises with its gate's reason.  Rows sharded over a data
    axis (``rows``) take ``"rounds"``: both whole-step kernels see one
    rank's rows only."""
    if route not in (None,) + ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if rows is not None:
        reason = (f"the rows are sharded over the mesh's 'data' axis (this "
                  f"rank holds {rows.n} of {rows.n_total}); the whole-step "
                  "kernels read one rank's rows, so the growth rounds run in "
                  "plain PyTorch with their sums reduced over the data group")
        if route in ("bign", "fused"):
            raise ValueError(f"route={route!r}: {reason}")
        return "rounds", {"bign": reason, "fused": reason}
    why = {}
    if route in (None, "bign"):
        why["bign"] = _bign.bign_unsupported_reason(
            cfg, pg, X, lik, w_scalar, all_cont, x_nan, chains=chains)
        if route is None and why["bign"] is None \
                and fused_rows_on_chip(cfg, pg, X, chains):
            why["bign"] = (f"n={X.shape[0]} rows fit the shared memory of the "
                           "whole-step kernel's cluster, where that kernel "
                           "is the faster one")
        if why["bign"] is None:
            return "bign", why
        if route == "bign":
            raise ValueError(f"route='bign': {why['bign']}")
    if route in (None, "fused"):
        why["fused"] = _draw.fused_draw_unsupported_reason(
            cfg, pg, X, gauss_w, lik, chains=chains)
        if why["fused"] is None:
            return "fused", why
        if route == "fused":
            raise ValueError(f"route='fused': {why['fused']}")
    return "rounds", why


@tracing.spanned("pgbart_step")
def pgbart_step(state: PgbartState, rands: StepRands, X, Y_target, rules,
                cfg: BartConfig, pg: PgbartConfig, tuning: bool, gauss_w,
                impl: Optional[str] = None, *, lik: str = "gauss",
                lik_const: float = 0.0, route: Optional[str] = None,
                w_scalar: bool = False, all_cont: Optional[bool] = None,
                x_nan: Optional[bool] = None,
                rejuv: Optional[RejuvRands] = None, loglik_fn=None,
                lik_params=None, rows=None,
                suff_stats: Optional[bool] = None):
    """One PGBART MCMC step for all chains: update a rotating batch of trees.

    ``X`` (n, p) is shared by the chains, ``Y_target`` (n, k) too or is
    (C, n, k), one target a chain (a heteroscedastic scale forest's);
    ``gauss_w`` (C, n, k) is the row data of the likelihood code ``lik``
    (the per-observation Gaussian precision for ``"gauss"``; ``None`` for
    ``"bernoulli"``; see ``ops/draw.py``).  ``route``: see ``resolve_route``;
    ``"bign"`` needs the caller's structural promises: ``w_scalar`` (every
    row of a chain shares one Gaussian precision, i.e. sigma is a scalar
    random variable), ``all_cont`` (every split rule continuous; read from
    ``rules`` when None) and ``x_nan`` (X holds a NaN; read from ``X`` when
    None).  ``impl`` forces the kernels or the plain versions on any route.
    ``cfg.response`` ``"linear"`` / ``"mix"`` take the per-round route under
    every likelihood (``rands`` from ``draw_rands(response=...)``).
    ``lik="generic"``: the model's own log-likelihood, ``loglik_fn(f (n, k),
    lik_params) -> scalar`` for one chain (``compound.make_loglik``) with
    ``lik_params`` every chain's current ``(theta (C, d), {name: value
    (C, n, k)})``; it takes the per-round route (the gates of the other two
    refuse it and name why), as does a joint forest of ``cfg.n_outputs >= 2``
    (which has no closed form: always generic; a closed-form code with
    ``n_outputs != 1`` raises).  With ``pg.ancestor_sampling`` (constant
    response only: a ValueError otherwise) the rejuvenation sweeps follow the
    route's step, with the moves' numbers ``rejuv``
    (``rejuvenate.draw_rejuv_rands``), and the inclusion counts are taken
    afterwards.
    ``rows`` (``parallel.mesh.RowShard``): ``X``, ``Y_target``, ``gauss_w``,
    the state's per-row fields and ``rands.rg`` hold this rank's rows of a
    row-sharded model (``StepRands.shard``); closed-form codes with the
    constant response only.  ``suff_stats``: the node-space Gaussian mode
    (``"gauss"``, ``w_scalar``, constant response, one output) on or off;
    None takes it under ``rows`` and on the plain per-round route from
    ``NODE_SPACE_ROWS`` rows, as the JAX package does.  The mode's rounds and
    selection are plain PyTorch: ``suff_stats=True`` on the card takes them
    in place of ``grow.cu`` and ``select.cu`` (``smc.cu`` still resamples).
    The state's tensors are UPDATED IN PLACE (forest, tree_pred and the
    Welford buffers are large and the step is the hot loop); clone the state
    first to keep the old one.  Returns ``(state, variable_inclusion (C, p))``.
    """
    if cfg.n_outputs != 1 and lik != GENERIC:
        raise NotImplementedError(
            f"n_outputs={cfg.n_outputs} with likelihood code {lik!r}: the "
            "closed-form codes take one output; a joint forest takes the "
            "model's likelihood (lik='generic')")
    if rows is not None and (lik == GENERIC or cfg.response != "constant"):
        raise NotImplementedError(
            "row sharding takes the closed-form likelihood codes with "
            f"response='constant'; got lik={lik!r}, "
            f"response={cfg.response!r}")
    if pg.ancestor_sampling and cfg.response != "constant":
        raise ValueError(
            "ancestor_sampling (retained-path grow/prune rejuvenation) "
            f"supports response='constant' only, not {cfg.response!r}")
    if pg.ancestor_sampling and rejuv is None:
        raise ValueError("ancestor_sampling: pgbart_step needs the moves' "
                         "numbers rejuv (rejuvenate.draw_rejuv_rands)")
    out = _step_route(state, rands, X, Y_target, rules, cfg, pg, tuning,
                      gauss_w, impl, lik=lik, lik_const=lik_const, route=route,
                      w_scalar=w_scalar, all_cont=all_cont, x_nan=x_nan,
                      loglik_fn=loglik_fn, lik_params=lik_params, rows=rows,
                      suff_stats=suff_stats)
    if not pg.ancestor_sampling:
        return out
    # every route leaves tree_pred and sum_trees equal to the forest's
    # predictions on X, which the moves read
    state = out[0]
    n, p = X.shape
    Y = Y_target.reshape(-1, n, cfg.n_outputs)
    if all_cont is None:
        all_cont = rules_all_continuous(rules)
    with tracing.span("rejuvenate_forest"):
        rejuvenate_forest(state, rejuv, X, Y, rules, cfg, pg,
                          make_ll_of(lik, lik_const, gauss_w, Y, loglik_fn,
                                     lik_params, rows), all_cont, rows=rows)
    return state, split_var_counts(state.forest, p)


def node_space_mode(suff_stats: Optional[bool], cfg: BartConfig, lik: str,
                    w_scalar: bool, n: int, plain: bool, rows) -> bool:
    """Whether the per-round route takes the node-space Gaussian mode: as
    asked, else under row sharding and on the plain route from
    ``NODE_SPACE_ROWS`` rows (JAX's ``suff_gauss`` gate; on the card the
    per-round kernels cover every n and keep the row-space rounds)."""
    able = (lik == "gauss" and w_scalar and cfg.response == "constant"
            and cfg.n_outputs == 1)
    if suff_stats is None:
        return able and (rows is not None or (plain and n >= NODE_SPACE_ROWS))
    if suff_stats and not able:
        raise ValueError(
            "suff_stats=True: the node-space mode takes lik='gauss' with one "
            "precision a chain (w_scalar), response='constant' and one "
            f"output; got lik={lik!r}, w_scalar={w_scalar}, "
            f"response={cfg.response!r}, n_outputs={cfg.n_outputs}")
    return bool(suff_stats)


def _step_route(state, rands, X, Y_target, rules, cfg, pg, tuning, gauss_w,
                impl, *, lik, lik_const, route, w_scalar, all_cont, x_nan,
                loglik_fn=None, lik_params=None, rows=None, suff_stats=None):
    """The step of the route ``resolve_route`` takes (``pgbart_step``
    without the rejuvenation sweeps)."""
    C = state.sum_trees.shape[0]
    bign_possible = rows is None and (route == "bign" or (
        route is None and not fused_rows_on_chip(cfg, pg, X, C)))
    if bign_possible:       # the two reads synchronise: only where needed
        if all_cont is None:
            all_cont = rules_all_continuous(rules)
        if x_nan is None:
            x_nan = bool(torch.isnan(X).any())
    taken, _why = resolve_route(
        route, cfg, pg, X, gauss_w, lik, chains=C, w_scalar=w_scalar,
        all_cont=bool(all_cont) if bign_possible else False,
        x_nan=bool(x_nan) if bign_possible else True, rows=rows)
    if taken == "bign":
        # gauss: one precision per chain; the other codes: their row data
        w_chain = llw = None
        if lik == "gauss":
            w_chain = gauss_w[:, 0, 0].contiguous()
        elif gauss_w is not None:
            llw = gauss_w.reshape(C, X.shape[0])
        return _bign.pgbart_step_bign(
            state, rands, X, Y_target, cfg, pg, w_chain, tuning, lik=lik,
            lik_const=lik_const, llw=llw, impl=impl)
    if taken == "fused":
        return _draw.pgbart_step_fused(
            state, rands, X, Y_target, rules, cfg, pg, gauss_w, tuning,
            lik=lik, lik_const=lik_const, impl=impl)
    if rands.rg is None:
        # the per-round functions take the block: written out from the seed
        # by the generator the whole-step kernels use
        if rands.seed is None:
            raise ValueError(
                "rands holds neither the row Gumbels (rg) nor a seed to "
                "generate them from")
        rands = dataclasses.replace(rands, rg=_bign.gumbel_block(
            rands.seed, B=pg.batch_size(cfg.m, tuning), C=C,
            P=pg.num_particles, D=cfg.max_depth, n=X.shape[0],
            chains=rands.chains, chain0=rands.chain0, row0=rands.row0))
    plain = impl == "plain" or (impl is None and not X.is_cuda)
    return step_rounds(state, rands, X, Y_target, rules, cfg, pg, tuning,
                       gauss_w, impl=impl, lik=lik, lik_const=lik_const,
                       loglik_fn=loglik_fn, lik_params=lik_params, rows=rows,
                       node_space=node_space_mode(
                           suff_stats, cfg, lik, w_scalar, X.shape[0], plain,
                           rows))


def step_rounds(state: PgbartState, rands: StepRands, X, Y_target, rules,
                cfg: BartConfig, pg: PgbartConfig, tuning: bool, gauss_w,
                impl: Optional[str] = None, *, lik: str = "gauss",
                lik_const: float = 0.0, loglik_fn=None, lik_params=None,
                rows=None, node_space: bool = False):
    """The per-round route of ``pgbart_step`` (same arguments and outputs):
    one call per growth round, resampling step and selection, with the
    commit and the adaptation in plain PyTorch between them.  ``rows`` and
    ``node_space``: see ``_update_one_tree``; the leaf-sd adaptation then
    averages over every shard's rows."""
    if lik == GENERIC:
        if loglik_fn is None:
            raise ValueError("lik='generic' needs the model closure "
                             "loglik_fn")
        loglik = batched_loglik(loglik_fn, lik_params)
    elif lik not in _draw.LIK_CODES:
        raise NotImplementedError(
            f"likelihood code {lik!r}: the closed-form codes "
            f"{sorted(_draw.LIK_CODES)} and {GENERIC!r} are ported")
    else:
        loglik = None
    if lik not in ("gauss", "bernoulli", GENERIC) and gauss_w is None:
        raise ValueError(f"likelihood code {lik!r} needs its row data")
    m = cfg.m
    B = pg.batch_size(m, tuning)
    n, p = X.shape
    n_glob = n if rows is None else rows.n_total
    C = state.sum_trees.shape[0]
    dev = state.sum_trees.device
    Y = Y_target.reshape(-1, n, cfg.n_outputs)        # (1|C, n, k)
    forest = state.forest
    ar = torch.arange(C, device=dev)
    offset0 = state.batch_offset.to(torch.int64)
    p_range = torch.arange(p, dtype=torch.int32, device=dev)

    for i in range(B):
        jt = (offset0 + i) % m
        tree = Forest(forest.split_var[ar, jt], forest.split_val[ar, jt],
                      forest.split_set[ar, jt], forest.leaf[ar, jt],
                      forest.count[ar, jt], forest.slope[ar, jt])
        sum_noi = state.sum_trees - state.tree_pred[ar, jt]
        resid = Y - sum_noi
        sv_w, sl_w, st_w, lf_w, ct_w, sp_w, pred = _update_one_tree(
            i, rands, tree, resid, state.alpha_vec, state.leaf_sd, X, rules,
            cfg, pg, gauss_w, impl, lik, lik_const, sum_noi, Y, loglik,
            rows=rows, node_space=node_space)
        forest.split_var[ar, jt] = sv_w
        forest.split_val[ar, jt] = sl_w
        forest.split_set[ar, jt] = st_w
        forest.leaf[ar, jt] = lf_w
        forest.count[ar, jt] = ct_w
        forest.slope[ar, jt] = sp_w
        state.tree_pred[ar, jt] = pred
        state.sum_trees = sum_noi + pred
        state.iteration = state.iteration + 1

        if tuning:
            # Dirichlet-style split-prior adaptation: +1 per split node
            tcounts = (sv_w[:, :, None] == p_range).to(torch.float32).sum(1)
            state.alpha_vec = (state.alpha_vec * pg.split_prior_decay
                               + tcounts)
            # running variance of per-tree predictions -> leaf_sd
            state.wf_count = state.wf_count + 1.0
            wc = state.wf_count[:, None, None]
            delta = pred - state.wf_mean
            state.wf_mean = state.wf_mean + delta / wc
            state.wf_m2 = state.wf_m2 + delta * (pred - state.wf_mean)
            sd = true_div(sum64(torch.sqrt(
                (state.wf_m2 / wc.clamp_min(1.0)).clamp_min(1e-12)), dim=1,
                rows=rows), n_glob)
            state.leaf_sd = torch.where(
                (state.iteration > m)[:, None], sd.clamp_min(1e-6),
                state.leaf_sd)

    state.batch_offset = ((offset0 + B) % m).to(torch.int32)
    return state, split_var_counts(forest, p)


def refresh_tree_pred(state: PgbartState, X, rules,
                      cfg: BartConfig) -> PgbartState:
    """Recompute the per-tree prediction cache from the forest."""
    f = state.forest
    per_tree = tree_predict(f.split_var, f.split_val, f.split_set, f.leaf,
                            f.slope, X, rules, cfg.max_depth)
    return dataclasses.replace(state, tree_pred=per_tree,
                               sum_trees=per_tree.sum(dim=1))
