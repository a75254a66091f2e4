"""Model compilation and the compound PGBART + NUTS sampling loop (PyTorch).

Counterpart of ``pymc_bart_tpu/sampler/compound.py``: automatic step
assignment (BART RVs -> PGBART, continuous free RVs -> NUTS/HMC), the
per-draw compound step, chain management and draw storage.  Chains are a
leading tensor axis ``C`` of one eager program (the JAX package vmaps them);
per-chain model expressions are batched with ``torch.func.vmap``.

Ported: the fused likelihood patterns ``y ~ Normal(BART, sigma)`` (code
``gauss``) and ``y ~ Bernoulli(sigmoid(BART))`` (code ``bernoulli``), with
one output, and the ``separate_trees`` models with one forest per
output: the heteroscedastic ``y ~ Normal(w[0], |w[1]| + c)`` or
``Normal(w[0], exp(w[1]))`` (codes ``gauss`` with per-row precision for the
mean forest, ``het_abs`` / ``het_exp`` for the scale forest) and the
softmax classifier ``y ~ Categorical(softmax(w.T))`` (code ``cat_logit`` for
every class forest); any other likelihood through the generic model
log-likelihood (``make_loglik``: the model's own ``observed_logp`` with the
candidate sum of trees in place of the BART value, e.g. ``Poisson(exp(BART))``
or ``Normal(w[0], |w[1]| + c)`` of ONE joint forest with two leaf values a
node), on the per-round route; ``ancestor_sampling`` (retained-path
rejuvenation after every PGBART step, ``sampler/rejuvenate.py``).  Each
forest runs on the large-n route of
``pgbart.pgbart_step`` where a chain's rows do not fit the whole-step
kernel's shared memory (``pgbart.resolve_route``), on the whole-step route
where its gate admits the configuration and on the per-round route
otherwise (``sample(pgbart_route=...)`` forces one; the linear and mix
responses take the per-round route, under every likelihood); chunked
tune/draw loops, adaptation harmonisation, timings, stored posterior forests,
checkpoint / resume (``utils/checkpoint.py``), the debug aids and
convergence checks; ``sample(mesh=...)`` over the ranks of a
``torch.distributed`` world (``parallel/mesh.py``): chains over the
``"chains"`` axis, rows over ``"data"``, the full posterior on every rank.

Device policy: ``sample(device=None)`` runs on ``cuda`` and raises if no
CUDA device is present; the CPU is used only for ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
import operator
import os
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..config import PgbartConfig
from ..models import expr as expr_mod
from ..models.distributions import BernoulliDist, CategoricalDist, NormalDist
from ..models.expr import Expr, Op, evaluate
from ..models.inference_data import DataArray, Dataset, InferenceData
from ..models.model import BARTRV, Deterministic, Model
from ..ops.trees import Forest, rules_all_continuous
from ..parallel import mesh as pmesh
from ..utils import checkpoint as ckpt_mod
from ..utils.posterior import PosteriorForests
from . import hmc, nuts, pgbart, rejuvenate


def resolve_device(device) -> torch.device:
    """``None`` means the GPU and nothing else; the CPU only on request."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "present")
    return device


def _expr_leaf_names(x, acc=None):
    """Names of named leaves referenced by an expression, through
    ``Deterministic`` nodes (the JAX package stops at them, so a
    Deterministic-wrapped softmax misses the Categorical growth target)."""
    if acc is None:
        acc = set()
    if isinstance(x, Op):
        for a in x.args:
            _expr_leaf_names(a, acc)
    elif isinstance(x, Deterministic):
        acc.add(x.name)
        _expr_leaf_names(x.expr, acc)
    elif isinstance(x, Expr):
        name = getattr(x, "name", None)
        if name is not None:
            acc.add(name)
    return acc


def _match_getitem(expr, brv):
    """If ``expr`` is ``brv[i]`` (tagged getitem), return the int index."""
    if isinstance(expr, Op) and getattr(expr, "tag", None) is not None:
        tag = expr.tag
        if (len(tag) == 2 and tag[0] == "getitem" and len(expr.args) == 1
                and expr.args[0] is brv and isinstance(tag[1], int)):
            return tag[1]
    return None


def _depends_on_output(expr, brv, out):
    """Does ``expr`` reference ``brv`` other than via ``brv[i]`` with
    ``i != out``?  (Conservative: any non-getitem reference counts.)"""
    if expr is brv:
        return True
    if isinstance(expr, Op):
        gi = _match_getitem(expr, brv)
        if gi is not None:
            return gi == out
        return any(_depends_on_output(a, brv, out)
                   for a in expr.args if isinstance(a, Expr))
    if isinstance(expr, Expr):
        return getattr(expr, "name", None) == brv.name
    return False


def _unwrap_det(e):
    """Strip ``Deterministic`` wrappers so the fusion pattern matches
    through named intermediate quantities."""
    while isinstance(e, Deterministic):
        e = e.expr
    return e


def _match_scale_pattern(expr, brv, out):
    """Match the scale-forest link: ``exp(brv[out])`` -> ("het_exp", 0) or
    ``abs(brv[out]) (+ c)`` -> ("het_abs", c)."""
    if (isinstance(expr, Op) and expr.fn is torch.exp and len(expr.args) == 1
            and _match_getitem(expr.args[0], brv) == out):
        return ("het_exp", 0.0)

    def match_abs(e):
        return (isinstance(e, Op) and e.fn is torch.abs and len(e.args) == 1
                and _match_getitem(e.args[0], brv) == out)

    if match_abs(expr):
        return ("het_abs", 0.0)
    if (isinstance(expr, Op) and expr.fn is operator.add
            and len(expr.args) == 2):
        a, b = expr.args
        for x, y in ((a, b), (b, a)):
            if match_abs(x) and isinstance(y, (int, float)) and y >= 0:
                return ("het_abs", float(y))
    return None


def _softmax_axis(e):
    """The axis of ``e`` if it is a softmax (the port's ``math.softmax`` or
    ``torch.softmax``) of one argument, else None."""
    if not (isinstance(e, Op) and len(e.args) == 1
            and e.fn in (expr_mod._softmax, torch.softmax)):
        return None
    return e.kwargs.get("axis", e.kwargs.get("dim", -1))


def _is_softmax_of_transpose(e, brv):
    """``softmax(brv.T)`` over the last axis, or ``softmax(brv, axis=0).T``:
    class probabilities with the classes of ``brv`` (k, n) on the last axis."""
    if _softmax_axis(e) in (-1, 1):
        inner = _unwrap_det(e.args[0])
        return (isinstance(inner, Op)
                and getattr(inner, "tag", None) == ("transpose",)
                and inner.args[0] is brv)
    if (isinstance(e, Op) and getattr(e, "tag", None) == ("transpose",)
            and len(e.args) == 1):
        inner = _unwrap_det(e.args[0])
        return (_softmax_axis(inner) == 0
                and _unwrap_det(inner.args[0]) is brv)
    return False


def _fused_likelihood(model: Model, brv: BARTRV, out=None):
    """Detect a closed-form SMC likelihood code for one sampler entry: the
    whole BART variable (``out=None``) or its output ``out`` under
    ``separate_trees``.

    Returns ``None`` (no closed form) or a dict:

    * ``{"kind": "gauss", "sigma_expr": e}``: ``y ~ Normal(F, sigma(env))``,
      per-step row data 1/sigma^2; also the mean forest of a separate-trees
      heteroscedastic model, whose sigma reads the other outputs;
    * ``{"kind": "bernoulli"}``: ``y ~ Bernoulli(sigmoid(F))``;
    * ``{"kind": "het_abs" | "het_exp", "mu_expr": e, "const": c}``: the
      scale forest of ``y ~ Normal(mu0(env), |F| + c)`` or
      ``Normal(mu0, exp(F))``;
    * ``{"kind": "cat_logit"}``: a class forest of
      ``y ~ Categorical(softmax(w.T))``.
    """
    if len(model.bart_rvs) != 1 or len(model.observed_rvs) != 1:
        return None
    orv = model.observed_rvs[0]
    obs = np.asarray(orv.observed, np.float64).reshape(-1)
    n = brv.X.shape[0]
    if obs.shape[0] != n or not np.allclose(
            obs, np.asarray(brv.Y, np.float64).reshape(-1)):
        return None
    k = brv.config.n_outputs
    if orv.dist is BernoulliDist and k == 1 and out is None:
        p_expr = _unwrap_det(orv.params[0]) if orv.params else None
        if (isinstance(p_expr, Op) and p_expr.fn is torch.sigmoid
                and len(p_expr.args) == 1
                and _unwrap_det(p_expr.args[0]) is brv):
            return {"kind": "bernoulli"}
        return None
    if orv.dist is CategoricalDist and out is not None and k > 1:
        p_expr = _unwrap_det(orv.params[0]) if orv.params else None
        if _is_softmax_of_transpose(p_expr, brv):
            return {"kind": "cat_logit"}
        return None
    if orv.dist is not NormalDist or len(orv.params) < 2:
        return None
    mu_expr, sigma_expr = _unwrap_det(orv.params[0]), orv.params[1]
    if out is None:
        if k != 1 or mu_expr is not brv:
            return None
        if brv.name in _expr_leaf_names(sigma_expr):
            return None
        return {"kind": "gauss", "sigma_expr": sigma_expr}
    mu_idx = _match_getitem(mu_expr, brv)
    if mu_idx is None:
        return None
    if out == mu_idx:
        if _depends_on_output(sigma_expr, brv, out):
            return None
        return {"kind": "gauss", "sigma_expr": sigma_expr}
    pat = _match_scale_pattern(sigma_expr, brv, out)
    if pat is None:
        return None
    kind, c = pat
    return {"kind": kind, "mu_expr": mu_expr, "const": c}


def _jitter_duplicate_values(X: np.ndarray, rules: np.ndarray,
                             seed: int) -> np.ndarray:
    """Pre-jitter duplicated values of continuous-rule columns, once at
    setup.  Tied entries get a deterministic uniform jitter well below the
    column's distinct-value gap; the jittered matrix is used for growth and
    routing only — stored forests predict on the raw covariates."""
    X = np.array(X, np.float32, copy=True)
    rng = np.random.default_rng(seed)
    for j in range(X.shape[1]):
        if rules[j] != 0:  # RULE_CONTINUOUS only
            continue
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


def _bart_growth_target(model: Model, brv: BARTRV) -> np.ndarray:
    """Per-output regression target (n, k) for leaf-value proposals.

    The observed Y broadcast over outputs, except for a multi-output BART
    feeding a Categorical likelihood: there each output's target is +-2
    around its class indicator (softmax is shift-invariant per row, so the
    broadcast labels would pull every class forest to the same values).
    The SMC weights are the exact likelihood either way; the target only
    centres the proposals."""
    n = brv.X.shape[0]
    k = brv.config.n_outputs
    Y = np.asarray(brv.Y, np.float64).reshape(n, -1)[:, :1]
    if k > 1:
        for orv in model.observed_rvs:
            refs = set()
            for p_ in orv.params:
                _expr_leaf_names(p_, refs)
            if brv.name not in refs:
                continue
            labels = np.asarray(orv.observed).astype(int)
            if (orv.dist is CategoricalDist and labels.size == n
                    and labels.max() < k):
                return 4.0 * np.eye(k)[labels.reshape(-1)] - 2.0
    return np.broadcast_to(Y, (n, k)).copy()


def _scale_target(kind: str, const: float, s_hat):
    """Growth target of a scale forest from per-row scale evidence ``s_hat``
    (|y - mu0| / E|N(0, 1)|): ``s_hat - c`` for ``|F| + c``, ``log s_hat``
    for ``exp(F)``.  NumPy or torch."""
    if kind == "het_abs":
        return s_hat - const
    if isinstance(s_hat, np.ndarray):
        return np.log(np.maximum(s_hat, 1e-3))
    return torch.log(s_hat.clamp_min(1e-3))


_E_ABS_NORMAL = 0.7978845608     # E|N(0, 1)| = sqrt(2 / pi)


def scale_forest_data(kind: str, const: float, y, mu0):
    """Per-step row data and growth target of a scale forest (``het_abs`` /
    ``het_exp``) at the mean forest's current values ``mu0`` (C, n): the
    squared deviations ``(y - mu0)^2`` and the target from the per-row scale
    evidence ``|y - mu0| / E|N(0, 1)|``, both (C, n, 1)."""
    dev = y - mu0
    target = _scale_target(kind, const, dev.abs() / _E_ABS_NORMAL)
    return (dev * dev)[..., None], target[..., None].contiguous()


def class_forest_data(W, j: int):
    """Per-step row data of class forest ``j``: the logsumexp of the OTHER
    classes' current values ``W`` (C, n, k), as (C, n, 1)."""
    others = torch.cat([W[..., :j], W[..., j + 1:]], dim=-1)
    return torch.logsumexp(others, dim=-1, keepdim=True).contiguous()


class CompiledModel:
    """Flattens a Model into per-chain log-density pieces on one device."""

    def __init__(self, model: Model, device="cpu"):
        self.model = model
        self.device = torch.device(device)
        self.bart_rvs: List[BARTRV] = list(model.bart_rvs)
        self.free_params = list(model.free_rvs)
        sizes = [int(np.prod(rv.shape)) if rv.shape else 1
                 for rv in self.free_params]
        self.param_sizes = sizes
        self.theta_size = int(sum(sizes))
        self.data_env = {
            name: torch.as_tensor(np.asarray(d.get_value(), np.float32),
                                  device=self.device)
            for name, d in model.data_vars.items()
        }
        self.observed = tuple(
            torch.as_tensor(np.asarray(orv.observed, np.float32),
                            device=self.device)
            for orv in model.observed_rvs)
        # the distributions' constant parameters as float32 tensors on the
        # device, made once: a log-density evaluation copies nothing from
        # the host (which would wait for the card and cannot be captured)
        self.prior_params = [tuple(map(self._on_device, rv.params))
                             for rv in self.free_params]
        self.observed_params = [tuple(map(self._on_device, orv.params))
                                for orv in model.observed_rvs]

    def _on_device(self, p):
        """A Python number or a NumPy / list constant as the float32 tensor
        ``distributions._t`` / ``expr.evaluate`` would copy it to; an
        expression as it is."""
        if isinstance(p, bool) or not isinstance(
                p, (int, float) + expr_mod._ARRAYS):
            return p
        return torch.as_tensor(np.asarray(p, np.float32), device=self.device)

    # -- environment construction (one chain) ------------------------------
    def bart_external(self, name: str, f):
        """internal (..., n, k) -> user-facing orientation (..., n) or
        (..., k, n)."""
        brv = next(b for b in self.bart_rvs if b.name == name)
        if len(brv.shape) == 1:
            return f[..., 0]
        return f.transpose(-1, -2)

    def unpack_theta(self, theta):
        """unconstrained vector (d,) -> (env of constrained values, log|J|)."""
        env = {}
        log_jac = torch.zeros((), device=theta.device)
        off = 0
        for rv, size in zip(self.free_params, self.param_sizes):
            u = theta[off: off + size]
            u = u.reshape(rv.shape) if rv.shape else u[0]
            env[rv.name] = rv.dist.transform.forward(u)
            log_jac = log_jac + rv.dist.transform.log_jac(u).sum()
            off += size
        return env, log_jac

    def build_env(self, theta, bart_internal: Dict[str, Any]):
        env = dict(self.data_env)
        for name, f in bart_internal.items():
            env[name] = self.bart_external(name, f)
        param_env, log_jac = self.unpack_theta(theta)
        env.update(param_env)
        for det in self.model.deterministics:
            env[det.name] = evaluate(det.expr, env)
        return env, log_jac

    def observed_logp(self, env):
        lp = torch.zeros((), device=self.device)
        for orv, value, ps in zip(self.model.observed_rvs, self.observed,
                                  self.observed_params):
            params = tuple(evaluate(p, env) for p in ps)
            lp = lp + orv.dist.logp(value, *params).sum()
        return lp

    def prior_logp(self, env):
        lp = torch.zeros((), device=self.device)
        for rv, ps in zip(self.free_params, self.prior_params):
            params = tuple(evaluate(p, env) for p in ps)
            lp = lp + rv.dist.logp(env[rv.name], *params).sum()
        return lp

    def logdensity(self, theta, bart_internal):
        env, log_jac = self.build_env(theta, bart_internal)
        return self.prior_logp(env) + self.observed_logp(env) + log_jac

    # -- initial values ----------------------------------------------------
    def initial_theta(self) -> np.ndarray:
        """Support-point initialization in unconstrained space."""
        if self.theta_size == 0:
            return np.zeros((0,), np.float32)
        env: Dict[str, Any] = {k: v.cpu() for k, v in self.data_env.items()}
        for brv in self.bart_rvs:
            env[brv.name] = torch.full(brv.shape, float(np.mean(brv.Y)),
                                       dtype=torch.float32)
        pieces = []
        for rv in self.free_params:
            params = tuple(evaluate(p, env) for p in rv.params)
            sp = rv.dist.support_point(rv.shape or (), *params).to(
                torch.float32)
            env[rv.name] = sp
            u = rv.dist.transform.inverse(sp).numpy()
            pieces.append(np.ravel(u) if u.ndim else u[None])
        return np.concatenate(pieces).astype(np.float32)


def make_loglik(compiled: CompiledModel, vname: str,
                out: Optional[int] = None):
    """Particle-weight log-likelihood of one BART variable (JAX's
    ``_make_loglik``): ``loglik(f (n, k), lik_params) -> scalar`` for one
    chain, with ``lik_params = (theta, {name: current internal value})``;
    the candidate ``f`` replaces this variable's value.  With ``out`` the
    candidate ``f`` (n, 1) replaces only that output column
    (``separate_trees``: each output's forest has its own conditional SMC
    while the other outputs stay fixed; JAX's ``_make_loglik_output``).  Terms shared by all
    particles cancel in the weight normalisation.  ``pgbart.batched_loglik``
    evaluates it over chains and particles at once."""

    def loglik(f, lik_params):
        theta, internal = lik_params
        bart_internal = dict(internal)
        if out is not None:
            W = internal[vname]
            f = torch.cat([W[:, :out], f, W[:, out + 1:]], dim=1)
        bart_internal[vname] = f
        env, _ = compiled.build_env(theta, bart_internal)
        return compiled.observed_logp(env)

    loglik.__name__ = f"loglik_{vname}" + ("" if out is None else f"_out{out}")
    return loglik


class PGBART:
    """Manual step-method handle: ``PGBART([mu], num_particles=5)`` passed
    via ``sample(step=[...])`` overrides the sampler settings for those
    BART variables."""

    def __init__(self, vars, num_particles: int = 10,
                 batch: Tuple[float, float] = (0.1, 0.1),
                 num_refinements: int = 5, ancestor_sampling: bool = False,
                 rejuvenation_sweeps: int = 1, model=None):
        self.var_names = [v.name for v in vars]
        self.config = PgbartConfig(
            num_particles=num_particles, batch=batch,
            num_refinements=num_refinements,
            ancestor_sampling=ancestor_sampling,
            rejuvenation_sweeps=rejuvenation_sweeps)


def _count_dtype(n: int):
    return torch.int16 if n < 32768 else torch.int32


def _pack_forest_slice(bs, f, jt=None):
    """Pack forest tensors (C, m, S[, k]) for host off-load: optional
    tree-batch slice (``jt`` (C, B) indices) plus exact dtype narrowing;
    split_set / slope are dropped when statically unused (rebuilt as zeros
    on the host)."""
    if jt is None:
        def take(a):
            return a
    else:
        ci = torch.arange(jt.shape[0], device=jt.device)[:, None]

        def take(a):
            return a[ci, jt]
    n, p = bs["X"].shape
    d = {
        "sv": take(f.split_var).to(torch.int8 if p < 127 else torch.int32),
        "sl": take(f.split_val),
        "lf": take(f.leaf),
        "ct": take(f.count).to(_count_dtype(n)),
    }
    if jt is not None:
        d["jt"] = jt
    if not bs["all_cont"]:
        d["ss"] = take(f.split_set)
    if bs["cfg"].response != "constant":
        d["sp"] = take(f.slope)
    return d


def _unpack_forest_deltas(bs, delta_chunks, snap0_chunks):
    """Rebuild full per-draw forests from chunk-start snapshots + per-draw
    updated-tree deltas (the inverse of ``_pack_forest_slice``), all NumPy.

    Returns (sv, sl, ss, lf, ct, sp) each shaped (chains, draws, m, S[, k])
    in the full-width dtypes (``ss`` as uint32)."""
    cfg = bs["cfg"]
    m, S, k = cfg.m, cfg.n_nodes, cfg.n_outputs
    widen = {"sv": np.int32, "sl": np.float32, "lf": np.float32,
             "ct": np.float32, "ss": np.uint32, "sp": np.float32}
    pieces: Dict[str, List[np.ndarray]] = {key: [] for key in widen}

    def cast(a, key):
        a = np.asarray(a)
        if key == "ss":
            return np.ascontiguousarray(a.astype(np.int32)).view(np.uint32)
        return a.astype(widen[key])

    for snap0, dl in zip(snap0_chunks, delta_chunks):
        jt = np.asarray(dl["jt"], np.int64)           # (chains, c, B)
        chains_n, c = jt.shape[0], jt.shape[1]
        ci = np.arange(chains_n)[:, None]
        cur: Dict[str, np.ndarray] = {}
        for key, dt in widen.items():
            if key in snap0:
                cur[key] = cast(snap0[key], key).copy()
            elif key == "ss":
                cur[key] = np.zeros((chains_n, m, S), dt)
            else:  # "sp"
                cur[key] = np.zeros((chains_n, m, S, k), dt)
        out = {key: np.empty((chains_n, c) + cur[key].shape[1:],
                             cur[key].dtype) for key in cur}
        for d_ in range(c):
            for key in cur:
                if key in dl:
                    cur[key][ci, jt[:, d_]] = cast(dl[key][:, d_], key)
                out[key][:, d_] = cur[key]
        for key in pieces:
            pieces[key].append(out[key])
    full = {key: np.concatenate(v, axis=1) for key, v in pieces.items()}
    return (full["sv"], full["sl"], full["ss"], full["lf"], full["ct"],
            full["sp"])


class _StaticLogp:
    """``logp_fn(theta)`` of one fit: ``fn(theta, *values)`` over copies of
    the BART values that keep their addresses for the fit (what a captured
    NUTS graph reads); ``update`` copies a step's values in."""

    def __init__(self, fn, values):
        self.fn = fn
        self.values = tuple(v.clone() for v in values)

    def update(self, values):
        for buf, v in zip(self.values, values):
            buf.copy_(v)

    def __call__(self, theta):
        return self.fn(theta, *self.values)


class _HostDrain:
    """Device -> host off-load of one chunk's outputs, overlapped with the
    next chunk's compute: copies go to pinned host memory on a side stream
    and an event marks their end.  On the CPU it is a plain conversion."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device=device)
                       if device.type == "cuda" else None)

    def start(self, outs):
        """Begin copying ``outs`` (a dict of named tensors); returns a
        handle."""
        if self.stream is None:
            return outs, None
        self.stream.wait_stream(torch.cuda.current_stream(self.device))

        def copy(t):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            t.record_stream(self.stream)
            return host

        with torch.cuda.stream(self.stream):
            host_outs = {k: copy(t) for k, t in outs.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        return host_outs, done

    @staticmethod
    @tracing.spanned("drain_wait")
    def finish(handle):
        host_outs, done = handle
        tracing.count("host_syncs")
        if done is not None:
            done.synchronize()
        return {k: t.cpu().numpy().copy() for k, t in host_outs.items()}


_POSTERIOR_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def _carry(bart_static, bart_states, h, gen) -> Dict[str, torch.Tensor]:
    """The whole state a step reads, as named tensors (the unit of
    ``utils/checkpoint``): every field of each forest entry's
    ``PgbartState`` (keyed by the entry's tag), every field of the
    ``HmcState`` and the generator's state, from which every random number
    of a step is drawn."""
    out = {}
    for bs, st in zip(bart_static, bart_states):
        pre = f"pgbart/{bs['tag']}/"
        for f in dataclasses.fields(st):
            v = getattr(st, f.name)
            if f.name == "forest":
                for g in dataclasses.fields(v):
                    out[f"{pre}forest.{g.name}"] = getattr(v, g.name)
            else:
                out[pre + f.name] = v
    for f in dataclasses.fields(h):
        out["hmc/" + f.name] = getattr(h, f.name)
    out["generator"] = gen.get_state()
    return out


def _restore_carry(arrays, bart_static, gen):
    """The inverse of ``_carry``: ``(bart_states, h)``, and ``gen`` set to
    the saved state."""
    states = []
    for bs in bart_static:
        pre = f"pgbart/{bs['tag']}/"
        forest = Forest(**{g.name: arrays[f"{pre}forest.{g.name}"]
                           for g in dataclasses.fields(Forest)})
        states.append(pgbart.PgbartState(forest=forest, **{
            f.name: arrays[pre + f.name]
            for f in dataclasses.fields(pgbart.PgbartState)
            if f.name != "forest"}))
    h = hmc.HmcState(**{f.name: arrays["hmc/" + f.name]
                        for f in dataclasses.fields(hmc.HmcState)})
    gen.set_state(arrays["generator"])
    return states, h


def _carry_layout(bart_static, carry):
    """``(row axes, names whole on every rank)`` of a ``_carry`` dict under
    a mesh: the forest entries' fields are each rank's chains (and rows);
    the ``HmcState`` (every chain on every rank) and the generator are the
    same on every rank."""
    rows = {f"pgbart/{bs['tag']}/{name}": ax for bs in bart_static
            if bs["rows"] is not None
            for name, ax in pgbart.PgbartState.ROW_AXES.items()}
    whole = [k_ for k_ in carry if not k_.startswith("pgbart/")]
    return rows, whole


def _gather_carry(bart_static, carry, mesh) -> Dict[str, np.ndarray]:
    """Every rank's ``_carry`` joined into the whole run's (host arrays)."""
    host = {k_: v.detach().cpu().numpy() for k_, v in carry.items()}
    rows, whole = _carry_layout(bart_static, carry)
    return pmesh.gather_outputs(host, mesh, rows, whole)


def _shard_carry(bart_static, arrays, chain_part) -> Dict[str, torch.Tensor]:
    """This rank's part of a whole run's carry (the inverse of
    ``_gather_carry``)."""
    rows, whole = _carry_layout(bart_static, arrays)
    tag_rows = {f"pgbart/{bs['tag']}/": bs["rows"] for bs in bart_static}
    out = {}
    for k_, v in arrays.items():
        if k_ not in whole:
            v = v[chain_part]
            if k_ in rows:
                r = tag_rows[k_[:k_.rindex("/") + 1]]
                v = v.narrow(rows[k_], r.row0, r.n)
            v = v.contiguous()
        out[k_] = v
    return out


def _check_finite(draw: int, bart_static, bart_states, h, stats) -> None:
    """``debug_nans``: raise ``FloatingPointError`` naming the draw and the
    first quantity holding a value that is not finite: a forest's sum of
    trees or leaf values, ``theta`` or the NUTS energy (split values may be
    NaN by design).  One host synchronisation for all of them."""
    named = {}
    for bs, st in zip(bart_static, bart_states):
        named[f"sum_trees of {bs['tag']!r}"] = st.sum_trees
        named[f"leaf values of {bs['tag']!r}"] = st.forest.leaf
    named["theta"] = h.theta
    named["NUTS energy"] = stats["energy"]
    tracing.count("host_syncs")
    ok = torch.stack([torch.isfinite(t).all() for t in named.values()]).cpu()
    bad = (~ok).nonzero()
    if len(bad):
        raise FloatingPointError(f"debug_nans: draw {draw}: "
                                 f"{list(named)[int(bad[0, 0])]} is not "
                                 "finite")


# sample()'s caller, as ``warnings.warn`` counts frames from sample()'s body:
# sample(), the wrapper of tracing.records_into, the caller
_CALLER = 3


@tracing.records_into("timings", also="profile_dir")
def sample(
    draws: int = 1000,
    tune: int = 1000,
    chains: int = 4,
    random_seed: Optional[int] = None,
    model: Optional[Model] = None,
    num_particles: int = 10,
    batch: Tuple[float, float] = (0.1, 0.1),
    num_refinements: int = 5,
    ancestor_sampling: bool = False,
    rejuvenation_sweeps: int = 1,
    harmonize_adaptation: bool = True,
    split_prior_decay: float = 1.0,
    store_trees: bool = True,
    algorithm: str = "nuts",
    max_leapfrog: int = 32,
    mesh=None,
    progressbar: bool = False,
    step=None,
    chunk_size: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    profile_dir: Optional[str] = None,
    debug_nans: bool = False,
    jitter_duplicates: bool = True,
    posterior_dtype: Optional[str] = None,
    convergence_checks: bool = True,
    timings: Optional[Dict[str, Any]] = None,
    device=None,
    pgbart_route: Optional[str] = None,
) -> InferenceData:
    """Run the compound PGBART(+NUTS) sampler and return InferenceData.

    Keeps the signature of the JAX package's ``sample`` for the arguments it
    supports.  ``device=None`` runs on the GPU and raises if there is none;
    pass ``device="cpu"`` to run on the CPU.  ``harmonize_adaptation``
    averages the adapted ``leaf_sd`` / ``alpha_vec`` across chains at the
    tune/draw boundary.
    ``pgbart_route``: ``None`` lets every PGBART step take the large-n route
    where a chain's rows do not fit the whole-step kernel's shared memory and
    the whole-step function where they do (``pgbart.resolve_route``), where
    their gates admit the configuration (a warning says why a forest takes
    the per-round route); ``"bign"`` / ``"fused"`` / ``"rounds"``
    force one route.  On a CUDA device the large-n route generates its row
    Gumbels inside the kernel and the step draws no block that grows with n.

    ``ancestor_sampling``: after each PGBART step, ``rejuvenation_sweeps``
    grow / prune / change Metropolis sweeps over the committed trees
    (``sampler/rejuvenate.py``); constant response only (``ValueError``
    otherwise).  The stored forests then ship all m trees a draw.
    ``separate_trees`` (``BART(..., shape=(k, n), separate_trees=True)``):
    one forest per output, each updated with the others' current values, for
    ``Normal(w[0], |w[1]| + c)``, ``Normal(w[0], exp(w[1]))`` and
    ``Categorical(softmax(w.T))``; ``all_trees`` is then a list of k
    ``PosteriorForests``.

    A forest without a closed-form code (any other likelihood, another
    separate-trees form, or one joint forest of ``shape=(k, n)`` with k leaf
    values a node) is weighted by the model's own log-likelihood
    (``make_loglik``, evaluated batched over chains
    and particles) and takes the per-round route; a joint forest's
    ``all_trees`` is one ``PosteriorForests`` with ``n_outputs == k``.

    ``checkpoint_dir``: save the carry (``_carry``) after every tuning and
    draw chunk, and each draw chunk's outputs, there
    (``utils/checkpoint.py``); the draws then drain serially, in lock-step
    with the carry.  ``resume=True`` continues from the latest checkpoint
    there (``check_format`` first) and reloads the draws saved up to it, so
    the result is the full posterior, bit for bit that of an uninterrupted
    run; ``draws`` may grow on resume.  ``posterior_dtype``: ``"float16"`` /
    ``"bfloat16"`` storage of the collected values, cast on the device
    before the drain and returned as float32 (stats and forests are not
    cast).  ``debug_nans``: after every draw step, raise
    ``FloatingPointError`` naming the draw and the quantity when a forest's
    sum of trees or leaf values, ``theta`` or the NUTS energy is not finite
    (split values may be NaN by design and are not checked); off, it adds no
    host synchronisation.  ``profile_dir``: trace the draw loop with
    ``torch.profiler`` (CPU activity, and CUDA activity on the card) and
    write a Chrome trace ``draws.pt.trace.json`` there
    (``draws.rank<r>.pt.trace.json`` for rank r > 0 of a mesh).

    ``mesh``: a ``DeviceMesh`` of the ranks of a ``torch.distributed`` world
    (``parallel.mesh.make_mesh``) with a ``"chains"`` axis and optionally a
    ``"data"`` axis; every rank calls ``sample`` with the same arguments on
    its own device.  Chains are split over ``"chains"`` (``chains`` must be
    a multiple of its size): each rank runs the PGBART steps of its chains
    on its device, with the random numbers an unsharded run gives them (it
    draws every chain's and keeps its own), and no collective inside a
    PGBART step; NUTS runs every chain on every rank, on the gathered
    values of all chains (host-bound, it costs a rank no more than its own
    chains would, and it keeps the run independent of the placement), so a
    meshed run returns the unsharded run's posterior bit for bit.  Rows are
    split over ``"data"``: X, the targets and the observed values hold each
    rank's rows, the PGBART steps take the per-round route with their child
    statistics, likelihood sums and split winners reduced over the data
    group, NUTS sums the observed part's value and gradient over it.  Row
    sharding refuses what the JAX package refuses: a generic likelihood, a
    response other than ``"constant"`` and Deterministics.  Every rank
    returns the full ``InferenceData`` (the draw chunks and, with
    ``checkpoint_dir``, the carry are gathered; rank 0 alone writes and reads
    the files and hands every rank its part on resume, so ``checkpoint_dir``
    need not be on a filesystem the ranks share).  ``random_seed=None``:
    rank 0's seed.

    ``timings``: optional dict that the call fills (``tracing.py``) with
    ``tune_seconds`` and ``draw_seconds_total`` (host clock, each phase
    ended by a device synchronisation that only ``timings`` adds),
    ``draw_chunk_sizes``, ``drained_bytes`` (this rank's copy to the host),
    and the program's own spans and counters: ``timings["spans"][path] =
    [host seconds, calls]`` and ``timings["counters"][path] = total``,
    where ``path`` joins the names of the spans open at the start with
    ``/``.  Spans: ``prepare`` (the call's entry to its first tuning step),
    ``tune`` and ``draw`` (the phases), inside them ``draw_rands``,
    ``pgbart_step`` (its ``rejuvenate_forest``), ``nuts_step`` (each
    batched leapfrog ``nuts_leapfrog``), ``collect`` (a draw's values,
    statistics and updated trees into the chunk's buffers), ``drain_wait``
    (the wait for a chunk's copy to the host and its conversion),
    ``checkpoint`` (``checkpoint_dir``), ``collective`` (a mesh's
    all-reduce, all-gather or output gathering), then ``assemble`` (the
    draws joined into the ``InferenceData``, forests rebuilt, convergence
    checks).  On a CUDA device NUTS replays its doublings as CUDA graphs
    (``nuts.Graphs``), a graph a tree depth captured the second time the
    fit reaches it (span ``nuts_capture``); a replay is one entry of
    ``nuts_leapfrog`` counted as its ``2^j`` leapfrogs.  Counters:
    ``nuts_leapfrogs`` (leapfrogs run for all chains at once: ``2^D - 1`` a
    transition of D doublings), ``nuts_graph_replays``,
    ``nuts_eager_doublings`` (doublings replayed or run eagerly: the first
    at each depth, on the CPU, with a data axis), ``nuts_graph_captures``,
    ``host_syncs`` (each
    point that blocks the host on the card, counted on any device),
    ``checkpoint_bytes`` (it replaces the list of that name;
    ``draw_chunk_seconds`` and ``checkpoint_seconds`` are gone too: the
    spans ``draw`` and ``checkpoint`` hold that time).  With no profiler the
    spans and counters cost the host about 13 us a step (the host of an
    H100 machine, Friedman at n=1000; 3 us with ``timings=None``, which
    records nothing and reads no clock: the decorated functions' own
    calls).  While a ``torch.profiler``
    records, each span is also a range ``bart/<name>`` on its clock, at
    about 12 us a span: ``profile_dir``'s trace shows them (the call then
    records into a dict of its own if ``timings`` is None).
    """
    prepare = tracing.span("prepare").start()
    if posterior_dtype is not None and posterior_dtype not in \
            _POSTERIOR_DTYPES:
        raise ValueError(f"posterior_dtype must be None or one of "
                         f"{sorted(_POSTERIOR_DTYPES)}, got "
                         f"{posterior_dtype!r}")
    if algorithm not in ("nuts", "hmc"):
        raise ValueError(f"algorithm must be 'nuts' or 'hmc', got {algorithm!r}")
    device = resolve_device(device)
    model = Model.get_context(model)
    compiled = CompiledModel(model, device)
    pmesh.check_mesh(mesh)
    n_chain_shards, n_data_shards = pmesh.mesh_shape(mesh)
    if random_seed is None:
        random_seed = int(pmesh.broadcast_object(
            int(np.random.default_rng().integers(0, 2**31 - 1)), mesh))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(random_seed))
    C = chains
    f32 = torch.float32

    # per-BART-variable PGBART configs (manual `step` overrides)
    pg_cfgs: Dict[str, PgbartConfig] = {}
    for brv in compiled.bart_rvs:
        if ancestor_sampling and brv.config.response != "constant":
            raise ValueError(
                "ancestor_sampling (retained-path grow/prune rejuvenation) "
                "supports response='constant' only; "
                f"{brv.name!r} has response={brv.config.response!r}")
        pg_cfgs[brv.name] = PgbartConfig(
            num_particles=num_particles, batch=batch,
            num_refinements=num_refinements,
            ancestor_sampling=ancestor_sampling,
            rejuvenation_sweeps=rejuvenation_sweeps,
            split_prior_decay=split_prior_decay)
    if step is not None:
        steps = step if isinstance(step, (list, tuple)) else [step]
        for st in steps:
            for vname in st.var_names:
                pg_cfgs[vname] = st.config

    # one sampler entry per forest: a BART RV gives one entry, or one per
    # output under separate_trees (each output its own forest, the other
    # outputs' current values fixed while it is updated)
    obs_y = (torch.as_tensor(np.asarray(model.observed_rvs[0].observed,
                                        np.float32).reshape(-1),
                             device=device)
             if len(model.observed_rvs) == 1 else None)
    if obs_y is not None:
        obs_y = obs_y[pmesh.row_sharding(mesh, obs_y.shape[0])]
    bart_static = []
    for rv_index, brv in enumerate(compiled.bart_rvs):
        cfg = brv.config
        k = cfg.n_outputs
        separate = cfg.separate_trees and k > 1
        X_raw = np.asarray(brv.X, np.float32)
        rules_np = brv.rules_array()
        X_np = X_raw
        if jitter_duplicates:
            X_np = _jitter_duplicate_values(
                X_np, rules_np, seed=int(random_seed) ^ 0x5EED)
        Yt = _bart_growth_target(model, brv)
        n_all = X_np.shape[0]
        part = pmesh.row_sharding(mesh, n_all)     # this rank's rows
        common = dict(
            name=brv.name, rv_index=rv_index, n_total=n_all,
            rows=pmesh.row_shard(mesh, n_all), row_part=part,
            X=torch.as_tensor(X_np[part], device=device), X_raw=X_raw,
            rules=torch.as_tensor(rules_np, dtype=torch.int32, device=device),
            rules_np=rules_np, pg=pg_cfgs[brv.name],
            split_prior=brv.split_prior,
            all_cont=rules_all_continuous(rules_np),
            x_nan=bool(np.isnan(X_np).any()))
        for out in (range(k) if separate else (None,)):
            fused = _fused_likelihood(model, brv, out=out)
            tag = brv.name + (f"[{out}]" if out is not None else "")
            if fused is None:
                # no closed form: the model's own log-likelihood
                fused = {"kind": pgbart.GENERIC,
                         "loglik": make_loglik(compiled, brv.name, out)}
            Yt_j = Yt if out is None else Yt[:, out:out + 1]
            if fused["kind"] in ("het_abs", "het_exp"):
                # the scale forest's INITIAL target: per-row scale evidence
                # around the global mean (the per-step target in one_step)
                y_np = np.asarray(model.observed_rvs[0].observed,
                                  np.float64).reshape(-1)
                Yt_j = _scale_target(
                    fused["kind"], fused["const"],
                    np.abs(y_np - y_np.mean()) / _E_ABS_NORMAL)[:, None]
            bart_static.append(dict(
                common, out=out, tag=tag, fused=fused,
                cfg=(dataclasses.replace(cfg, n_outputs=1,
                                         separate_trees=False)
                     if separate else cfg),
                Yt=torch.as_tensor(np.ascontiguousarray(Yt_j[part]),
                                   dtype=f32, device=device)))
    if n_data_shards > 1:
        # the JAX package's refusals, with its messages
        for bs in bart_static:
            if bs["fused"]["kind"] == pgbart.GENERIC:
                raise ValueError(
                    "row ('data') sharding requires a fused likelihood "
                    "(Normal / Bernoulli / heteroscedastic patterns); this "
                    "model's likelihood is generic")
            if bs["cfg"].response != "constant":
                raise ValueError(
                    "row sharding supports response='constant' only")
        if model.deterministics:
            raise ValueError(
                "row sharding does not support Deterministic tracking")
        # the observed values hold this rank's rows
        compiled.observed = tuple(
            o[pmesh.row_sharding(mesh, o.shape[0])]
            for o in compiled.observed)
    chain_part = pmesh.chain_sharding(mesh, chains)
    Cl = chain_part.stop - chain_part.start      # the chains of this rank
    obs_rows = (pmesh.row_shard(mesh, len(model.observed_rvs[0].observed))
                if n_data_shards > 1 and model.observed_rvs else None)
    n_bart = len(compiled.bart_rvs)
    p_max = max((bs["X"].shape[1] for bs in bart_static), default=1)
    if pgbart_route not in (None,) + pgbart.ROUTES:
        raise ValueError(f"pgbart_route must be None or one of "
                         f"{pgbart.ROUTES}, got {pgbart_route!r}")

    # -- init ----------------------------------------------------------------
    theta0 = torch.as_tensor(compiled.initial_theta(), device=device)
    jitter = torch.rand((C, compiled.theta_size), generator=gen,
                        device=device) - 0.5
    # NUTS state: every chain, on every rank
    h = hmc.init_state(theta0[None, :] + jitter)
    bart_states = [
        pgbart.init_state(bs["X"], bs["Yt"], bs["cfg"],
                          bs["split_prior"] if bs["split_prior"].size
                          else None, chains=Cl, device=device,
                          rows=bs["rows"])
        for bs in bart_static]
    names = [brv.name for brv in compiled.bart_rvs]

    def theta_l():
        """The NUTS values of this rank's chains."""
        return h.theta[chain_part]

    def bart_values():
        """Each BART RV's current value (C, n, k), in ``names`` order: an
        entry's sum of trees, or its outputs' sums side by side."""
        cols: Dict[str, Any] = {}
        for bs, st in zip(bart_static, bart_states):
            if bs["out"] is None:
                cols[bs["name"]] = st.sum_trees
            else:
                cols.setdefault(bs["name"], []).append(st.sum_trees)
        return tuple(v if isinstance(v, torch.Tensor) else torch.cat(v, -1)
                     for v in (cols[nm] for nm in names))

    def per_chain(fn):
        """vmap ``fn(theta (d,), *bart (n, k))`` over the chain axis."""
        return torch.func.vmap(fn)

    def make_env_fn(expr):
        def _value(theta, *bart):
            env, _ = compiled.build_env(theta, dict(zip(names, bart)))
            return torch.as_tensor(evaluate(expr, env), dtype=f32,
                                   device=device)
        return per_chain(_value)

    # sigma of a Gaussian entry; the mean of a scale forest's observations
    env_fns = [make_env_fn(bs["fused"]["sigma_expr"])
               if bs["fused"]["kind"] == "gauss" else
               make_env_fn(bs["fused"]["mu_expr"])
               if bs["fused"]["kind"] in ("het_abs", "het_exp") else None
               for bs in bart_static]

    # The route of every forest is a STATIC fact of the model and the card:
    # resolve it once, say why a forest takes the per-round route instead of
    # running it silently, and draw each step's random blocks for that route.
    for i, bs in enumerate(bart_static):
        kind = bs["fused"]["kind"]
        n_i = bs["X"].shape[0]
        probe = (None if kind == "bernoulli"
                 else torch.ones((Cl, n_i, 1), device=device))
        # a 0-d sigma (one value per chain) means every row of a chain
        # shares one precision: the large-n route's Gaussian regime applies
        bs["w_scalar"] = (kind == "gauss" and env_fns[i](
            theta_l(), *bart_values()).dim() == 1)
        bs["route"], why = pgbart.resolve_route(
            pgbart_route, bs["cfg"], bs["pg"], bs["X"], probe, kind,
            chains=Cl, w_scalar=bs["w_scalar"], all_cont=bs["all_cont"],
            x_nan=bs["x_nan"], rows=bs["rows"])
        # on the card the row Gumbels come from a seed on every route (the
        # whole-step kernels generate them, the per-round route has them
        # written out by the same generator); on the CPU the block is drawn
        bs["row_gumbels"] = device.type != "cuda"
        if pgbart_route is None and bs["route"] == "rounds":
            warnings.warn(
                f"BART variable {bs['tag']!r} takes the per-round sampler "
                "route (slower than the whole-step kernels): "
                f"whole-step route: {why['fused']}; large-n route: "
                f"{why['bign']}", stacklevel=_CALLER)

    def _logp(theta, *bart):
        return compiled.logdensity(theta, dict(zip(names, bart)))

    def _prior(theta, *bart):
        env, log_jac = compiled.build_env(theta, dict(zip(names, bart)))
        return compiled.prior_logp(env) + log_jac

    def _observed(theta, *bart):
        env, _ = compiled.build_env(theta, dict(zip(names, bart)))
        return compiled.observed_logp(env)

    def _collect(theta, *bart):
        internal = dict(zip(names, bart))
        out = {nm: compiled.bart_external(nm, v)
               for nm, v in internal.items()}
        param_env, _ = compiled.unpack_theta(theta)
        out.update(param_env)
        if model.deterministics:
            env, _ = compiled.build_env(theta, internal)
            for det in model.deterministics:
                out[det.name] = env[det.name]
        return out

    def row_data(i, bs):
        """``(row data (C, n, 1) | None, growth target)`` of entry ``i`` at
        the other forests' CURRENT values."""
        lik = bs["fused"]["kind"]
        n_i = bs["X"].shape[0]
        if lik == "gauss":
            sigma = env_fns[i](theta_l(), *bart_values())    # (C,) | (C, n)
            w = 1.0 / sigma.clamp_min(1e-12) ** 2
            return torch.broadcast_to(w.reshape(Cl, -1, 1),
                                      (Cl, n_i, 1)).contiguous(), bs["Yt"]
        if lik in ("het_abs", "het_exp"):
            mu0 = env_fns[i](theta_l(), *bart_values()).reshape(Cl, n_i)
            return scale_forest_data(lik, bs["fused"]["const"], obs_y, mu0)
        if lik == "cat_logit":
            W = bart_values()[names.index(bs["name"])]       # (C, n, k)
            return class_forest_data(W, bs["out"]), bs["Yt"]
        # bernoulli: the labels ride Yt; generic: the model closure reads
        # the current values itself (lik_params); no row data
        return None, bs["Yt"]

    # the log-density NUTS reads, over BART values at fixed addresses, and
    # the fit's NUTS graphs, which read them (dropped when the draws end)
    static_logp = None
    nuts_graphs = nuts.Graphs()

    def one_step(tuning: bool):
        nonlocal h, static_logp
        vis = []
        for i, bs in enumerate(bart_static):
            cfg, pg = bs["cfg"], bs["pg"]
            n_i, k_i = bs["X"].shape[0], cfg.n_outputs
            lik_row, Yt_i = row_data(i, bs)
            # every chain's and every row's numbers, of which this rank
            # keeps its own
            rands = pgbart.draw_rands(
                gen, B=pg.batch_size(cfg.m, tuning), C=C,
                P=pg.num_particles, D=cfg.max_depth, n=bs["n_total"], k=k_i,
                S=cfg.n_nodes, num_refinements=pg.num_refinements,
                device=device, row_gumbels=bs["row_gumbels"],
                response=cfg.response)
            rejuv = (rejuvenate.draw_rejuv_rands(
                gen, moves=cfg.m * max(pg.rejuvenation_sweeps, 1), C=C,
                S=cfg.n_nodes, n=bs["n_total"], k=k_i, device=device)
                if bs["pg"].ancestor_sampling else None)
            if mesh is not None:
                part = bs["row_part"] if bs["rows"] is not None else None
                rands = rands.shard(chain_part, part)
                if rejuv is not None:
                    rejuv = rejuv.shard(chain_part, part)
            generic = bs["fused"]["kind"] == pgbart.GENERIC
            bart_states[i], vi = pgbart.pgbart_step(
                bart_states[i], rands, bs["X"], Yt_i, bs["rules"], cfg,
                pg, tuning, lik_row, lik=bs["fused"]["kind"],
                lik_const=bs["fused"].get("const", 0.0), route=bs["route"],
                w_scalar=bs["w_scalar"], all_cont=bs["all_cont"],
                x_nan=bs["x_nan"], rejuv=rejuv,
                loglik_fn=bs["fused"].get("loglik"),
                lik_params=((theta_l(), dict(zip(names, bart_values())))
                            if generic else None), rows=bs["rows"])
            vis.append(vi)

        if compiled.theta_size > 0:
            # every chain's values: NUTS runs all chains on every rank
            bart_now = tuple(pmesh.chains_gather(v, mesh)
                             for v in bart_values())
            if obs_rows is None:
                if static_logp is None:
                    static_logp = _StaticLogp(per_chain(_logp), bart_now)
                else:
                    static_logp.update(bart_now)
                logp_fn = static_logp
            else:
                prior_b, obs_b = per_chain(_prior), per_chain(_observed)
                logp_fn = hmc.ShardedLogp(
                    lambda theta: prior_b(theta, *bart_now),
                    lambda theta: obs_b(theta, *bart_now), obs_rows)

            if algorithm == "nuts":
                h, stats = nuts.nuts_step(gen, h, logp_fn, tuning=tuning,
                                          full_stats=True,
                                          graphs=nuts_graphs)
            else:
                h, accept = hmc.hmc_step(gen, h, logp_fn, tuning=tuning,
                                         max_leapfrog=max_leapfrog)
                stats = {"accept": accept,
                         "diverging": torch.zeros((C,), dtype=torch.bool,
                                                  device=device),
                         "tree_depth": torch.zeros((C,), dtype=torch.int32,
                                                   device=device),
                         "n_steps": torch.full((C,), max_leapfrog,
                                               dtype=torch.int32,
                                               device=device),
                         "step_size": torch.exp(h.log_step),
                         "energy": torch.zeros((C,), device=device)}
        else:
            zc = torch.zeros((C,), device=device)
            stats = {"accept": torch.ones((C,), device=device),
                     "diverging": zc.to(torch.bool),
                     "tree_depth": zc.to(torch.int32),
                     "n_steps": zc.to(torch.int32),
                     "step_size": zc, "energy": zc}
        return vis, stats

    def sync():
        tracing.count("host_syncs")
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if chunk_size is None:
        chunk_size = max(1, min(200, draws))

    def _even_chunks(total: int, max_chunk: int):
        total = max(total, 0)
        n = max(1, math.ceil(total / max(max_chunk, 1)))
        base, extra = divmod(total, n)
        return [c for c in [base + 1] * extra + [base] * (n - extra) if c]

    # -- resume ------------------------------------------------------------
    start_tune, start_draw = 0, 0
    acc: List[Dict[str, np.ndarray]] = []
    rank0 = mesh is None or torch.distributed.get_rank() == 0

    def read_checkpoint(like):
        """``(step, carry, draws up to it)`` of the latest checkpoint in
        ``checkpoint_dir`` (the carry shaped as ``like``), or None."""
        found = ckpt_mod.latest_checkpoint(checkpoint_dir)
        if found is None:
            return None
        ckpt_mod.check_format(checkpoint_dir)
        path, step = found
        # the draws collected before the interruption: the resumed run
        # returns the FULL posterior
        return (step, ckpt_mod.load_checkpoint(path, like),
                ckpt_mod.load_draw_chunks(checkpoint_dir, upto_step=step)
                if step >= tune else [])

    if checkpoint_dir is not None and resume:
        here = _carry(bart_static, bart_states, h, gen)
        if mesh is None:
            found = read_checkpoint(here)
        else:
            # rank 0 alone reads the directory and hands every rank the
            # whole run's carry (or its error), of which each takes its
            # part: the other ranks need not see checkpoint_dir
            like = {k_: torch.from_numpy(v) for k_, v in
                    _gather_carry(bart_static, here, mesh).items()}
            found = None
            if rank0:
                try:
                    found = read_checkpoint(like)
                except Exception as err:    # every rank raises it below
                    found = err
                if isinstance(found, tuple):
                    found = (found[0], {k_: v.numpy()
                                        for k_, v in found[1].items()},
                             found[2])
            found = pmesh.broadcast_object(found, mesh)
            if isinstance(found, Exception):
                raise found
            if found is not None:
                part = _shard_carry(bart_static, {
                    k_: torch.from_numpy(v) for k_, v in found[1].items()},
                    chain_part)
                found = (found[0], {k_: v.to(here[k_].device)
                                    for k_, v in part.items()}, found[2])
        if found is not None:
            step, arrays, acc = found
            restored, h = _restore_carry(arrays, bart_static, gen)
            bart_states[:] = restored
            if step < tune:
                start_tune = step
            else:
                start_tune = tune
                start_draw = step - tune

    @tracing.spanned("checkpoint")
    def maybe_checkpoint(step: int):
        carry = _carry(bart_static, bart_states, h, gen)
        # each tensor's copy to the host waits for the card; the
        # generator's state is on the host already
        tracing.count("host_syncs", len(carry) - 1)
        if mesh is not None:
            carry = _gather_carry(bart_static, carry, mesh)
        nbytes = None
        if rank0:
            nbytes = os.path.getsize(ckpt_mod.save_checkpoint(
                checkpoint_dir, carry, meta={"tune": tune, "draws": draws},
                step=step))
        # every rank learns the file's size once it is on disk: no rank runs
        # ahead of a checkpoint that is not written yet
        tracing.count("checkpoint_bytes",
                      pmesh.broadcast_object(nbytes, mesh))

    # -- tuning --------------------------------------------------------------
    prepare.stop()
    t = start_tune
    with torch.no_grad(), tracing.span("tune") as tune_span:
        for c in _even_chunks(tune - start_tune, chunk_size):
            for _ in range(c):
                one_step(True)
            t += c
            if checkpoint_dir is not None:
                maybe_checkpoint(t)
            if progressbar:
                print(f"tune {t}/{tune}", flush=True)
        if timings is not None:
            sync()
    if timings is not None:
        timings["tune_seconds"] = tune_span.seconds
        timings["draw_chunk_sizes"] = []
        timings["drained_bytes"] = 0
    h = hmc.finalize_adaptation(h)
    if harmonize_adaptation and C > 1 and start_draw == 0:
        # leaf_sd and alpha_vec enter the sampler's implied prior, not just
        # the proposal: chains frozen with different values would sample
        # slightly different posteriors.  Average them at the boundary (a
        # run resumed among its draws restores them averaged), over the
        # chains of every rank.
        def _avg_rep(a):
            return pmesh.chains_mean(a, mesh).expand_as(a).contiguous()

        bart_states = [
            dataclasses.replace(st, leaf_sd=_avg_rep(st.leaf_sd),
                                alpha_vec=_avg_rep(st.alpha_vec))
            for st in bart_states]

    # -- draws (chunked; each chunk's outputs are one flat dict of named
    # tensors that drains to the host while the next chunk computes, or
    # serially in lock-step with the carry when checkpointing) -------------
    store_dtype = _POSTERIOR_DTYPES.get(posterior_dtype)
    drainer = _HostDrain(device)
    pending = None
    prof = None
    if profile_dir is not None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    # the rows of each BART value are the data shards' (the last axis)
    value_rows = ({pre + b.name: -1 for b in compiled.bart_rvs
                   for pre in ("values/", "bf16values/")}
                  if n_data_shards > 1 else {})

    def gathered(host_outs):
        return pmesh.gather_outputs(host_outs, mesh, value_rows)

    @tracing.spanned("collect")
    def collect(outs, vi_buf, c, j, vis, stats):
        """Draw ``j``'s values, inclusion rows, statistics and updated trees
        into the chunk's buffers (``c`` draws)."""
        vals = per_chain(_collect)(theta_l(), *bart_values())
        for nm, v in vals.items():
            if store_dtype is not None and v.is_floating_point():
                v = v.to(store_dtype)
            key = f"values/{nm}"
            if key not in outs:
                outs[key] = torch.empty(
                    (Cl, c) + v.shape[1:], dtype=v.dtype, device=device)
            outs[key][:, j] = v
        # one inclusion row per BART RV: a separate-trees group reports the
        # sum of its forests' split counts
        vi_buf[:, j].zero_()
        for bs, v in zip(bart_static, vis):
            vi_buf[:, j, bs["rv_index"], : v.shape[1]] += v
        for nm, v in stats.items():
            key = f"stats/{nm}"
            if key not in outs:
                outs[key] = torch.empty((Cl, c), dtype=v.dtype,
                                        device=device)
            outs[key][:, j] = v[chain_part]
        if store_trees:
            # only the draw's updated trees ship per draw: the tree batch,
            # or every tree where rejuvenation moved them all
            for bi, (bs, st) in enumerate(zip(bart_static, bart_states)):
                cfg_i, pg_i = bs["cfg"], bs["pg"]
                B_i = (cfg_i.m if pg_i.ancestor_sampling else
                       pg_i.batch_size(cfg_i.m, False))
                jt = (st.batch_offset.to(torch.int64)[:, None]
                      - B_i + torch.arange(B_i, device=device)) % cfg_i.m
                packed = _pack_forest_slice(bs, st.forest, jt)
                for key, v in packed.items():
                    key = f"deltas/{bi}/{key}"
                    if key not in outs:
                        outs[key] = torch.empty(
                            (Cl, c) + v.shape[1:], dtype=v.dtype,
                            device=device)
                    outs[key][:, j] = v

    draw_t0 = time.perf_counter()
    t = start_draw
    try:
        with torch.no_grad(), tracing.span("draw") as draw_span:
            for c in _even_chunks(draws - start_draw, chunk_size):
                outs: Dict[str, torch.Tensor] = {}
                if store_trees:
                    for i, (bs, st) in enumerate(zip(bart_static,
                                                     bart_states)):
                        snap0 = _pack_forest_slice(bs, st.forest)
                        for key, v in snap0.items():
                            outs[f"snap0/{i}/{key}"] = v.clone()
                vi_buf = torch.empty((Cl, c, n_bart, p_max),
                                     dtype=f32, device=device)
                for j in range(c):
                    vis, stats = one_step(False)
                    if debug_nans:
                        _check_finite(t + j, bart_static, bart_states, h,
                                      stats)
                    collect(outs, vi_buf, c, j, vis, stats)
                outs["vi"] = vi_buf
                # NumPy has no bfloat16: such values cross as raw 16-bit
                # words under their own prefix
                for key in [k_ for k_, v in outs.items()
                            if v.dtype == torch.bfloat16]:
                    outs["bf16" + key] = outs.pop(key).view(torch.int16)
                if timings is not None:
                    timings["drained_bytes"] += sum(
                        v.numel() * v.element_size() for v in outs.values())
                handle = drainer.start(outs)
                if checkpoint_dir is None:
                    if pending is not None:
                        acc.append(gathered(drainer.finish(pending)))
                    pending = handle
                else:
                    # the chunk's draws first, then the carry that commits
                    # them: a run stopped between the two resumes from the
                    # previous carry and ignores the later chunk file
                    host_outs = gathered(drainer.finish(handle))
                    acc.append(host_outs)
                    if rank0:
                        ckpt_mod.save_draw_chunk(checkpoint_dir,
                                                 tune + t + c, host_outs)
                    maybe_checkpoint(tune + t + c)
                t += c
                if timings is not None:
                    timings["draw_chunk_sizes"].append(c)
                if progressbar:
                    rate = (t - start_draw) * C / max(
                        time.perf_counter() - draw_t0, 1e-9)
                    print(f"draw {t}/{draws} ({rate:.1f} chain-draws/s)",
                          flush=True)
            if pending is not None:
                acc.append(gathered(drainer.finish(pending)))
                pending = None
            if timings is not None:
                sync()
        if timings is not None:
            timings["draw_seconds_total"] = draw_span.seconds
    finally:
        nuts_graphs.close()
        if prof is not None:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            rank = 0 if mesh is None else torch.distributed.get_rank()
            prof.export_chrome_trace(os.path.join(
                profile_dir, "draws.pt.trace.json" if rank == 0
                else f"draws.rank{rank}.pt.trace.json"))

    assemble = tracing.span("assemble").start()

    def joined(prefix):
        """Every chunk's arrays named ``prefix + name``, by name, joined
        along the draw axis; half-precision values come back as float32."""
        first = acc[0] if acc else {}
        names = dict.fromkeys(
            k_[len(prefix) + 4 * k_.startswith("bf16"):] for k_ in first
            if k_.startswith(prefix) or k_.startswith("bf16" + prefix))
        out = {}
        for nm in names:
            parts = []
            for ch in acc:
                a = ch.get(prefix + nm)
                if a is None:
                    a = torch.from_numpy(np.ascontiguousarray(
                        ch["bf16" + prefix + nm])).view(torch.bfloat16).to(
                            torch.float32).numpy()
                elif a.dtype == np.float16:
                    a = a.astype(np.float32)
                parts.append(a)
            out[nm] = np.concatenate(parts, axis=1)
        return out

    values = joined("values/")
    vi = (np.concatenate([ch["vi"] for ch in acc], axis=1) if acc
          else np.zeros((C, 0, n_bart, p_max), np.float32))
    stats_acc = joined("stats/")
    draws = vi.shape[1]

    # -- build InferenceData -------------------------------------------------
    posterior_vars: Dict[str, DataArray] = {}
    for group in (compiled.bart_rvs, compiled.free_params,
                  model.deterministics):
        for rv in group:
            if rv.name not in values:
                continue
            v = values[rv.name]
            dims = ["chain", "draw"] + [f"{rv.name}_dim_{i}"
                                        for i in range(v.ndim - 2)]
            posterior_vars[rv.name] = DataArray(v, dims, name=rv.name)

    sample_stats_vars = {
        "variable_inclusion": DataArray(
            np.asarray(vi, np.int64),
            ["chain", "draw", "variable_inclusion_dim_0",
             "variable_inclusion_dim_1"], name="variable_inclusion"),
    }
    if stats_acc:
        sample_stats_vars["mean_accept"] = DataArray(
            np.asarray(stats_acc["accept"]), ["chain", "draw"],
            name="mean_accept")
        for stat_name, np_dtype in (("diverging", bool),
                                    ("tree_depth", np.int64),
                                    ("n_steps", np.int64),
                                    ("step_size", np.float64),
                                    ("energy", np.float64)):
            sample_stats_vars[stat_name] = DataArray(
                np.asarray(stats_acc[stat_name], np_dtype), ["chain", "draw"],
                name=stat_name)
    idata = InferenceData(
        posterior=Dataset(posterior_vars),
        sample_stats=Dataset(sample_stats_vars),
        observed_data=Dataset({
            orv.name: DataArray(
                orv.observed,
                [f"{orv.name}_dim_{i}" for i in range(orv.observed.ndim)],
                name=orv.name)
            for orv in model.observed_rvs
        }),
    )

    # attach posterior forests to each BART RV (the all_trees equivalent); a
    # separate-trees RV gets a LIST of per-output stores, as in JAX
    if store_trees and acc:
        by_name: Dict[str, List[PosteriorForests]] = {}
        for i, bs in enumerate(bart_static):
            def part(ch, prefix):
                return {k_[len(prefix):]: v for k_, v in ch.items()
                        if k_.startswith(prefix)}

            sv, sl, ss, lf, ct, sp = _unpack_forest_deltas(
                bs, [part(ch, f"deltas/{i}/") for ch in acc],
                [part(ch, f"snap0/{i}/") for ch in acc])
            by_name.setdefault(bs["name"], []).append(PosteriorForests(
                split_var=sv, split_val=sl, split_set=ss, leaf=lf, count=ct,
                slope=sp, config=bs["cfg"], rules=bs["rules_np"],
                X_train=bs["X_raw"]))
        for brv in compiled.bart_rvs:
            stores = by_name[brv.name]
            brv.all_trees = stores[0] if len(stores) == 1 else stores
    idata._model = model  # convenience backref
    if convergence_checks and C >= 2 and draws >= 4:
        from ..utils.diagnostics import maybe_warn_convergence

        maybe_warn_convergence(idata, stacklevel=_CALLER)
    assemble.stop()
    return idata
