"""Model compilation and the compound PGBART + NUTS sampling loop (PyTorch).

Counterpart of ``pymc_bart_tpu/sampler/compound.py``: automatic step
assignment (BART RVs -> PGBART, continuous free RVs -> NUTS/HMC), the
per-draw compound step, chain management and draw storage.  Chains are a
leading tensor axis ``C`` of one eager program (the JAX package vmaps them);
per-chain model expressions are batched with ``torch.func.vmap``.

Ported: the fused likelihood patterns ``y ~ Normal(BART, sigma)`` (code
``gauss``) and ``y ~ Bernoulli(sigmoid(BART))`` (code ``bernoulli``) with
constant response and one output, on the large-n route of
``pgbart.pgbart_step`` where a chain's rows do not fit the whole-step
kernel's shared memory (``pgbart.resolve_route``), on the whole-step route
where its gate admits the configuration and on the per-round route
otherwise (``sample(pgbart_route=...)`` forces one); chunked
tune/draw loops, adaptation harmonisation, timings, stored posterior forests
and convergence checks.  Arguments and models that wait for later work raise
``NotImplementedError`` by name.

Device policy: ``sample(device=None)`` runs on ``cuda`` and raises if no
CUDA device is present; the CPU is used only for ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import PgbartConfig
from ..models.distributions import BernoulliDist, NormalDist
from ..models.expr import Expr, Op, evaluate
from ..models.inference_data import DataArray, Dataset, InferenceData
from ..models.model import BARTRV, Deterministic, Model
from ..utils.posterior import PosteriorForests
from . import hmc, nuts, pgbart


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
    """Names of named leaves referenced by an expression."""
    if acc is None:
        acc = set()
    if isinstance(x, Op):
        for a in x.args:
            _expr_leaf_names(a, acc)
    elif isinstance(x, Expr):
        name = getattr(x, "name", None)
        if name is not None:
            acc.add(name)
    return acc


def _unwrap_det(e):
    """Strip ``Deterministic`` wrappers so the fusion pattern matches
    through named intermediate quantities."""
    while isinstance(e, Deterministic):
        e = e.expr
    return e


def _fused_likelihood(model: Model, brv: BARTRV):
    """Detect a closed-form SMC likelihood code.

    Returns ``{"kind": "gauss", "sigma_expr": e}`` for
    ``y ~ Normal(BART, sigma(env))`` with ``sigma`` not depending on the
    BART variable (per-step row data = 1/sigma^2),
    ``{"kind": "bernoulli"}`` for ``y ~ Bernoulli(sigmoid(BART))`` (the
    labels ride the growth target; no row data), else ``None``.
    """
    if len(model.bart_rvs) != 1 or len(model.observed_rvs) != 1:
        return None
    orv = model.observed_rvs[0]
    obs = np.asarray(orv.observed, np.float64).reshape(-1)
    n = brv.X.shape[0]
    if obs.shape[0] != n or not np.allclose(
            obs, np.asarray(brv.Y, np.float64).reshape(-1)):
        return None
    if orv.dist is BernoulliDist and brv.config.n_outputs == 1:
        p_expr = _unwrap_det(orv.params[0]) if orv.params else None
        if (isinstance(p_expr, Op) and p_expr.fn is torch.sigmoid
                and len(p_expr.args) == 1
                and _unwrap_det(p_expr.args[0]) is brv):
            return {"kind": "bernoulli"}
        return None
    if orv.dist is not NormalDist or len(orv.params) < 2:
        return None
    mu_expr, sigma_expr = _unwrap_det(orv.params[0]), orv.params[1]
    if brv.config.n_outputs != 1 or mu_expr is not brv:
        return None
    if brv.name in _expr_leaf_names(sigma_expr):
        return None
    return {"kind": "gauss", "sigma_expr": sigma_expr}


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
    """Per-output regression target (n, k) for leaf-value proposals: the
    observed Y broadcast over outputs."""
    n = brv.X.shape[0]
    k = brv.config.n_outputs
    Y = np.asarray(brv.Y, np.float64).reshape(n, -1)[:, :1]
    return np.broadcast_to(Y, (n, k)).copy()


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
        for orv, value in zip(self.model.observed_rvs, self.observed):
            params = tuple(evaluate(p, env) for p in orv.params)
            lp = lp + orv.dist.logp(value, *params).sum()
        return lp

    def prior_logp(self, env):
        lp = torch.zeros((), device=self.device)
        for rv in self.free_params:
            params = tuple(evaluate(p, env) for p in rv.params)
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


def _tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict / tuple / list."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


class _HostDrain:
    """Device -> host off-load of one chunk's outputs, overlapped with the
    next chunk's compute: copies go to pinned host memory on a side stream
    and an event marks their end.  On the CPU it is a plain conversion."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device=device)
                       if device.type == "cuda" else None)

    def start(self, outs):
        """Begin copying ``outs`` (nested tensors); returns a handle."""
        if self.stream is None:
            return outs, None
        self.stream.wait_stream(torch.cuda.current_stream(self.device))

        def copy(t):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            t.record_stream(self.stream)
            return host

        with torch.cuda.stream(self.stream):
            host_outs = _tree_map(copy, outs)
            done = torch.cuda.Event()
            done.record(self.stream)
        return host_outs, done

    @staticmethod
    def finish(handle):
        host_outs, done = handle
        if done is not None:
            done.synchronize()
        return _tree_map(lambda t: t.cpu().numpy().copy(), host_outs)


_NOT_PORTED = ("mesh", "checkpoint_dir", "resume", "profile_dir",
               "debug_nans", "posterior_dtype")


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
    pass ``device="cpu"`` to run on the CPU.  ``timings``: optional dict
    filled with ``tune_seconds``, ``draw_chunk_seconds``,
    ``draw_chunk_sizes`` and ``draw_seconds_total`` (host clock after a
    device synchronisation).  ``harmonize_adaptation`` averages the adapted
    ``leaf_sd`` / ``alpha_vec`` across chains at the tune/draw boundary.
    ``pgbart_route``: ``None`` lets every PGBART step take the large-n route
    where a chain's rows do not fit the whole-step kernel's shared memory and
    the whole-step function where they do (``pgbart.resolve_route``), where
    their gates admit the configuration (a warning says why a forest takes
    the per-round route); ``"bign"`` / ``"fused"`` / ``"rounds"``
    force one route.  On a CUDA device the large-n route generates its row
    Gumbels inside the kernel and the step draws no block that grows with n.

    Not ported yet (``NotImplementedError``): ``mesh``, ``checkpoint_dir``,
    ``resume``, ``profile_dir``, ``debug_nans``, ``posterior_dtype``,
    ``ancestor_sampling``, ``separate_trees`` (and with it the
    heteroscedastic and Categorical models), a likelihood that is neither
    ``Normal(BART, sigma)`` nor ``Bernoulli(sigmoid(BART))``,
    ``response != "constant"``, ``n_outputs != 1``.
    """
    passed = dict(mesh=mesh, checkpoint_dir=checkpoint_dir, resume=resume,
                  profile_dir=profile_dir, debug_nans=debug_nans,
                  posterior_dtype=posterior_dtype)
    for name in _NOT_PORTED:
        if passed[name] not in (None, False):
            raise NotImplementedError(
                f"sample({name}=...) is not ported to the PyTorch package "
                "yet")
    if ancestor_sampling:
        raise NotImplementedError(
            "sample(ancestor_sampling=True) is not ported to the PyTorch "
            "package yet")
    if algorithm not in ("nuts", "hmc"):
        raise ValueError(f"algorithm must be 'nuts' or 'hmc', got {algorithm!r}")
    device = resolve_device(device)
    model = Model.get_context(model)
    compiled = CompiledModel(model, device)
    if random_seed is None:
        random_seed = int(np.random.default_rng().integers(0, 2**31 - 1))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(random_seed))
    C = chains
    f32 = torch.float32

    # per-BART-variable PGBART configs (manual `step` overrides)
    pg_cfgs: Dict[str, PgbartConfig] = {}
    for brv in compiled.bart_rvs:
        pg_cfgs[brv.name] = PgbartConfig(
            num_particles=num_particles, batch=batch,
            num_refinements=num_refinements,
            rejuvenation_sweeps=rejuvenation_sweeps,
            split_prior_decay=split_prior_decay)
    if step is not None:
        steps = step if isinstance(step, (list, tuple)) else [step]
        for st in steps:
            for vname in st.var_names:
                pg_cfgs[vname] = st.config

    bart_static = []
    for brv in compiled.bart_rvs:
        cfg = brv.config
        if cfg.response != "constant":
            raise NotImplementedError(
                f"BART variable {brv.name!r}: response={cfg.response!r} is "
                "not ported yet (response != 'constant')")
        if cfg.n_outputs != 1:
            raise NotImplementedError(
                f"BART variable {brv.name!r}: n_outputs={cfg.n_outputs} is "
                "not ported yet (n_outputs != 1; nor is separate_trees, "
                "which the heteroscedastic and Categorical models need)")
        if pg_cfgs[brv.name].ancestor_sampling:
            raise NotImplementedError(
                "PGBART(ancestor_sampling=True) is not ported yet")
        fused = _fused_likelihood(model, brv)
        if fused is None:
            raise NotImplementedError(
                f"BART variable {brv.name!r}: only the fused likelihoods "
                "y ~ Normal(BART, sigma) and y ~ Bernoulli(sigmoid(BART)) "
                "are ported yet")
        X_raw = np.asarray(brv.X, np.float32)
        rules_np = brv.rules_array()
        X_np = X_raw
        if jitter_duplicates:
            X_np = _jitter_duplicate_values(
                X_np, rules_np, seed=int(random_seed) ^ 0x5EED)
        bart_static.append(dict(
            name=brv.name, X=torch.as_tensor(X_np, device=device),
            X_raw=X_raw,
            Yt=torch.as_tensor(_bart_growth_target(model, brv), dtype=f32,
                               device=device),
            rules=torch.as_tensor(rules_np, dtype=torch.int32, device=device),
            rules_np=rules_np, cfg=cfg, pg=pg_cfgs[brv.name],
            split_prior=brv.split_prior,
            all_cont=bool((rules_np == 0).all()),
            x_nan=bool(np.isnan(X_np).any()), fused=fused))
    n_bart = len(bart_static)
    p_max = max((bs["X"].shape[1] for bs in bart_static), default=1)
    if pgbart_route not in (None,) + pgbart.ROUTES:
        raise ValueError(f"pgbart_route must be None or one of "
                         f"{pgbart.ROUTES}, got {pgbart_route!r}")

    # -- init ----------------------------------------------------------------
    theta0 = torch.as_tensor(compiled.initial_theta(), device=device)
    jitter = torch.rand((C, compiled.theta_size), generator=gen,
                        device=device) - 0.5
    h = hmc.init_state(theta0[None, :] + jitter)
    bart_states = [
        pgbart.init_state(bs["X"], bs["Yt"], bs["cfg"],
                          bs["split_prior"] if bs["split_prior"].size
                          else None, chains=C, device=device)
        for bs in bart_static]

    def bart_internal_values():
        return {bs["name"]: st.sum_trees
                for bs, st in zip(bart_static, bart_states)}

    names = [bs["name"] for bs in bart_static]

    def per_chain(fn):
        """vmap ``fn(theta (d,), *bart (n, k))`` over the chain axis."""
        return torch.func.vmap(fn)

    def make_sigma(sigma_expr):
        def _sigma(theta, *bart):
            env, _ = compiled.build_env(theta, dict(zip(names, bart)))
            return torch.as_tensor(evaluate(sigma_expr, env), dtype=f32,
                                   device=device)
        return per_chain(_sigma)

    sigma_fns = [make_sigma(bs["fused"]["sigma_expr"])
                 if bs["fused"]["kind"] == "gauss" else None
                 for bs in bart_static]

    # The route of every forest is a STATIC fact of the model and the card:
    # resolve it once, say why a forest takes the per-round route instead of
    # running it silently, and draw each step's random blocks for that route.
    for i, bs in enumerate(bart_static):
        kind = bs["fused"]["kind"]
        n_i = bs["X"].shape[0]
        probe = (None if kind == "bernoulli"
                 else torch.ones((C, n_i, 1), device=device))
        # a 0-d sigma (one value per chain) means every row of a chain
        # shares one precision: the large-n route's Gaussian regime applies
        bs["w_scalar"] = (kind == "gauss" and sigma_fns[i](
            h.theta, *(st.sum_trees for st in bart_states)).dim() == 1)
        bs["route"], why = pgbart.resolve_route(
            pgbart_route, bs["cfg"], bs["pg"], bs["X"], probe, kind, chains=C,
            w_scalar=bs["w_scalar"], all_cont=bs["all_cont"],
            x_nan=bs["x_nan"])
        # on the card the row Gumbels come from a seed on every route (the
        # whole-step kernels generate them, the per-round route has them
        # written out by the same generator); on the CPU the block is drawn
        bs["row_gumbels"] = device.type != "cuda"
        if pgbart_route is None and bs["route"] == "rounds":
            warnings.warn(
                f"BART variable {bs['name']!r} takes the per-round sampler "
                "route (slower than the whole-step kernels): "
                f"whole-step route: {why['fused']}; large-n route: "
                f"{why['bign']}", stacklevel=2)

    def _logp(theta, *bart):
        return compiled.logdensity(theta, dict(zip(names, bart)))

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

    def one_step(tuning: bool):
        nonlocal h
        vis = []
        for i, bs in enumerate(bart_static):
            cfg, pg = bs["cfg"], bs["pg"]
            n_i, k_i = bs["X"].shape[0], cfg.n_outputs
            lik = bs["fused"]["kind"]
            lik_row = None      # bernoulli: the labels ride Yt, no row data
            if lik == "gauss":
                bart_now = tuple(st.sum_trees for st in bart_states)
                sigma = sigma_fns[i](h.theta, *bart_now)        # (C,) | (C, n)
                w = 1.0 / sigma.clamp_min(1e-12) ** 2
                lik_row = torch.broadcast_to(
                    w.reshape(C, -1, 1), (C, n_i, k_i)).contiguous()
            rands = pgbart.draw_rands(
                gen, B=pg.batch_size(cfg.m, tuning), C=C,
                P=pg.num_particles, D=cfg.max_depth, n=n_i, k=k_i,
                S=cfg.n_nodes, num_refinements=pg.num_refinements,
                device=device, row_gumbels=bs["row_gumbels"])
            bart_states[i], vi = pgbart.pgbart_step(
                bart_states[i], rands, bs["X"], bs["Yt"], bs["rules"], cfg,
                pg, tuning, lik_row, lik=lik,
                lik_const=bs["fused"].get("const", 0.0), route=bs["route"],
                w_scalar=bs["w_scalar"], all_cont=bs["all_cont"],
                x_nan=bs["x_nan"])
            vis.append(vi)

        if compiled.theta_size > 0:
            bart_now = tuple(st.sum_trees for st in bart_states)
            batched = per_chain(_logp)

            def logp_fn(theta):
                return batched(theta, *bart_now)

            if algorithm == "nuts":
                h, stats = nuts.nuts_step(gen, h, logp_fn, tuning=tuning,
                                          full_stats=True)
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
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if chunk_size is None:
        chunk_size = max(1, min(200, draws))

    def _even_chunks(total: int, max_chunk: int):
        n = max(1, math.ceil(total / max(max_chunk, 1)))
        base, extra = divmod(total, n)
        return [c for c in [base + 1] * extra + [base] * (n - extra) if c]

    # -- tuning --------------------------------------------------------------
    tune_t0 = time.perf_counter()
    t = 0
    with torch.no_grad():
        for c in _even_chunks(tune, chunk_size):
            for _ in range(c):
                one_step(True)
            t += c
            if progressbar:
                print(f"tune {t}/{tune}", flush=True)
    if timings is not None:
        sync()
        timings["tune_seconds"] = time.perf_counter() - tune_t0
        timings["draw_chunk_seconds"] = []
        timings["draw_chunk_sizes"] = []
    h = hmc.finalize_adaptation(h)
    if harmonize_adaptation and C > 1:
        # leaf_sd and alpha_vec enter the sampler's implied prior, not just
        # the proposal: chains frozen with different values would sample
        # slightly different posteriors.  Average them at the boundary.
        def _avg_rep(a):
            return a.mean(dim=0, keepdim=True).expand_as(a).contiguous()

        bart_states = [
            dataclasses.replace(st, leaf_sd=_avg_rep(st.leaf_sd),
                                alpha_vec=_avg_rep(st.alpha_vec))
            for st in bart_states]

    # -- draws (chunked; each chunk's outputs drain to the host while the
    # next chunk computes; exact chunk sizes, nothing is compiled) ----------
    drainer = _HostDrain(device)
    acc: List = []
    pending = None
    draw_t0 = time.perf_counter()
    t = 0
    with torch.no_grad():
        for c in _even_chunks(draws, chunk_size):
            chunk_t0 = time.perf_counter()
            snap0 = (tuple(_tree_map(torch.clone,
                                     _pack_forest_slice(bs, st.forest))
                           for bs, st in zip(bart_static, bart_states))
                     if store_trees else None)
            values: Dict[str, torch.Tensor] = {}
            vi_buf = torch.empty((C, c, len(compiled.bart_rvs), p_max),
                                 dtype=f32, device=device)
            stats_buf: Dict[str, torch.Tensor] = {}
            deltas: Optional[List[Dict[str, torch.Tensor]]] = (
                [dict() for _ in bart_static] if store_trees else None)
            for j in range(c):
                vis, stats = one_step(False)
                bart_now = tuple(st.sum_trees for st in bart_states)
                vals = per_chain(_collect)(h.theta, *bart_now)
                for nm, v in vals.items():
                    if nm not in values:
                        values[nm] = torch.empty(
                            (C, c) + v.shape[1:], dtype=v.dtype, device=device)
                    values[nm][:, j] = v
                vi_buf[:, j].zero_()
                for bi, (bs, v) in enumerate(zip(bart_static, vis)):
                    vi_buf[:, j, bi, : v.shape[1]] += v
                for nm, v in stats.items():
                    if nm not in stats_buf:
                        stats_buf[nm] = torch.empty((C, c), dtype=v.dtype,
                                                    device=device)
                    stats_buf[nm][:, j] = v
                if store_trees:
                    # only the draw's updated tree batch ships per draw
                    for bi, (bs, st) in enumerate(zip(bart_static,
                                                      bart_states)):
                        B_i = bs["pg"].batch_size(bs["cfg"].m, False)
                        jt = (st.batch_offset.to(torch.int64)[:, None] - B_i
                              + torch.arange(B_i, device=device)) % bs["cfg"].m
                        packed = _pack_forest_slice(bs, st.forest, jt)
                        for key, v in packed.items():
                            if key not in deltas[bi]:
                                deltas[bi][key] = torch.empty(
                                    (C, c) + v.shape[1:], dtype=v.dtype,
                                    device=device)
                            deltas[bi][key][:, j] = v
            outs = ((values, vi_buf, stats_buf,
                     tuple(deltas) if store_trees else None), snap0)
            handle = drainer.start(outs)
            if pending is not None:
                acc.append(drainer.finish(pending))
            pending = handle
            t += c
            if timings is not None:
                timings["draw_chunk_seconds"].append(
                    time.perf_counter() - chunk_t0)
                timings["draw_chunk_sizes"].append(c)
            if progressbar:
                rate = t * C / max(time.perf_counter() - draw_t0, 1e-9)
                print(f"draw {t}/{draws} ({rate:.1f} chain-draws/s)",
                      flush=True)
        if pending is not None:
            final_t0 = time.perf_counter()
            acc.append(drainer.finish(pending))
            pending = None
            if timings is not None and timings["draw_chunk_seconds"]:
                timings["draw_chunk_seconds"][-1] += (
                    time.perf_counter() - final_t0)
    if timings is not None:
        sync()
        timings["draw_seconds_total"] = time.perf_counter() - draw_t0

    def cat(parts):
        return np.concatenate(parts, axis=1)

    scan_accs = [a[0] for a in acc]
    snap0_accs = [a[1] for a in acc]
    values = {nm: cat([o[0][nm] for o in scan_accs])
              for nm in (scan_accs[0][0] if scan_accs else {})}
    vi = (cat([o[1] for o in scan_accs]) if scan_accs
          else np.zeros((C, 0, n_bart, p_max), np.float32))
    stats_acc = {nm: cat([o[2][nm] for o in scan_accs])
                 for nm in (scan_accs[0][2] if scan_accs else {})}
    deltas_accs = [o[3] for o in scan_accs]
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

    # attach posterior forests to each BART RV (the all_trees equivalent)
    if store_trees and deltas_accs and deltas_accs[0] is not None:
        for i, (bs, brv) in enumerate(zip(bart_static, compiled.bart_rvs)):
            sv, sl, ss, lf, ct, sp = _unpack_forest_deltas(
                bs, [d[i] for d in deltas_accs],
                [s0[i] for s0 in snap0_accs])
            brv.all_trees = PosteriorForests(
                split_var=sv, split_val=sl, split_set=ss, leaf=lf, count=ct,
                slope=sp, config=bs["cfg"], rules=bs["rules_np"],
                X_train=bs["X_raw"])
    idata._model = model  # convenience backref
    if convergence_checks and C >= 2 and draws >= 4:
        from ..utils.diagnostics import maybe_warn_convergence

        maybe_warn_convergence(idata)
    return idata
