"""One whole PGBART step in one launch: CUDA kernel wrapper, plain version
and the gate that admits a configuration.

Counterpart of ``pymc_bart_tpu/ops/draw_pallas.py`` (``pgbart_step_fused``,
``fused_draw_unsupported_reason``); the kernel is ``csrc/draw.cu``.  One call
updates the rotating batch of ``B`` trees of every chain: per tree the full
conditional SMC (``D`` growth rounds, ``D-1`` ESS-gated resamplings, winner,
``R`` Metropolis leaf refinements), the forest / ``tree_pred`` / ``sum_trees``
commit, the split-prior and Welford ``leaf_sd`` adaptation while tuning, and
the variable-inclusion histogram.  The SMC weights follow a likelihood code:

* ``"gauss"``      ``y ~ Normal(F, sigma)``; row data = precision ``1/sigma^2``
* ``"bernoulli"``  ``y ~ Bernoulli(sigmoid(F))``; no row data, labels in ``Y``
* ``"het_abs"``    ``y ~ Normal(mu0, |F| + c)``; row data = ``(y - mu0)^2``
* ``"het_exp"``    ``y ~ Normal(mu0, exp(F))``; row data = ``(y - mu0)^2``
* ``"cat_logit"``  one class forest of a softmax classifier; ``Y > 0`` flags
  the class's rows, row data = logsumexp of the other classes

The state (``sampler.pgbart.PgbartState``) is UPDATED IN PLACE and the random
numbers (``StepRands``) are an argument.  The plain version is the per-round
route in plain PyTorch (``sampler.pgbart.step_rounds(impl="plain")``).

Dispatch: the kernel runs when the state lies on a CUDA device, the plain
version when it lies on the CPU; ``impl="kernel"|"plain"`` forces one.
Nothing falls back: a kernel that fails to build or launch raises.

The row Gumbels are either the pre-drawn block ``rands.rg`` (B, D, C, P, n)
or, with ``rands.rg is None``, generated inside the kernel from ``rands.seed``
(the counterpart of the TPU kernel's ``rng_mode="kernel"``; the generator and
its counter layout are the large-n kernel's, ``csrc/common.cuh``).  The plain
version then reads the block ``ops.bign.gumbel_block`` writes out for that
seed.

The kernel's form and limits (``launch_plan``) come from the shapes and the
card's architecture alone: a thread-block cluster per chain (at most 16
blocks: above 8 the size is "non-portable", which an H100 offers), the chain's
particles spread over its blocks, a team of warps per particle (at most 512
threads a block), and the per-particle state either in shared memory (form
``"shared"``: node arrays and a 16-bit row -> node array in two buffers, rows
staged, X too where it is small) or, where that does not fit the 227 KB a
block can use (many rows, or a deep tree's node arrays), in global memory
(form ``"global"``: the tree's random blocks are then read where they are and
the sums keyed by node are taken in global scratch, so depth 11 at 20
particles still fits).  The step's random
blocks and scratch must fit half of the card's memory.  A large covariate
matrix stays in global memory, so neither ``n * p`` nor ``p`` is limited.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Union

import torch

from ..config import BartConfig, PgbartConfig
from . import _build

LIK_CODES = {"gauss": 0, "bernoulli": 1, "het_abs": 2, "het_exp": 3,
             "cat_logit": 4}
_MAX_SMEM = 232448        # bytes of shared memory a block can use on Hopper
_MAX_WARPS = 16           # warps of a block (mirrors kMaxThreads of draw.cu)
_MAX_CLUSTER = 16         # blocks of a cluster (above 8: non-portable size)
_MAX_DEPTH = 16           # length of the kernel's grow-probability table


_X_STAGE_BYTES = 65536    # X is staged in shared memory up to this size
_CDF_STAGE_COLS = 4096    # the split-weight CDF is staged up to this many


def _round(v: int, k: int) -> int:
    return -(-v // k) * k


@dataclasses.dataclass(frozen=True)
class DrawPlan:
    """How ``csrc/draw.cu`` runs one configuration."""

    form: str          # "shared" | "global": where the per-particle state is
    cluster: int       # blocks of a chain's cluster
    per_block: int     # particle slots of a block
    warps: int         # warps of a particle's team
    x_staged: bool     # X and the split rules copied to shared memory
    cdf_staged: bool   # the split-weight CDF copied to shared memory
    smem: int = 0      # dynamic shared memory of a block, bytes

    @property
    def threads(self) -> int:
        return 32 * self.per_block * self.warps


def smem_bytes(plan: DrawPlan, D: int, P: int, S: int, n: int, p: int,
               R: int) -> int:
    """Dynamic shared memory of one block (mirrors ``layout`` of
    csrc/draw.cu, which the wrapper checks at the first launch of a plan)."""
    PB, CS = plan.per_block, plan.cluster
    Gm, Gtot, W = 2 ** (D - 1), 2**D - 1, PB * plan.warps
    shared = plan.form == "shared"
    items = [(8, PB * Gm)] + [(4, PB * Gm)] * 5
    if shared:      # the global form reads these where they are
        items += [(4, PB * Gtot), (4, PB * Gtot), (4, PB * 2 * Gtot),
                  (4, PB * Gtot), (8, PB * 2 * Gm), (4, PB * 2 * Gm)]
    items += [(8, S), (8, 4 * W), (4, PB)]
    items += [(4, P), (4, P), (4, 2 * P), (4, P), (4, P), (4, P), (4, P),
              (4, 4)]
    items += [(8, 3 * CS), (8, 2 * CS)] + ([(8, S)] if shared else [])
    items += [(4, S)] * 6 + ([(4, R * S)] if shared else [])
    items += [(4, D + 1 + R)]
    if plan.cdf_staged:
        items += [(4, p)]
    if plan.x_staged:
        items += [(4, n * p), (4, p)]
    if shared:
        record = 5 * _round(S, 4) + _round(n, 8) // 2
        items += [(4, n)] * 4 + [(4, 2 * PB * record), (2, _round(n, 8))]
    off = 0
    for size, count in items:
        off = _round(off, 16) + size * count
    return _round(off, 16)


@functools.lru_cache(maxsize=256)
def launch_plan(C: int, P: int, D: int, S: int, n: int, p: int,
                R: int = 5) -> Union[DrawPlan, str]:
    """The form and launch geometry of the whole-step kernel for these shapes
    (a pure function of them; ``R`` refinement sweeps size one staged block),
    or the reason the kernel cannot take them.

    The cluster is the smallest that holds the chain's particles at
    ``ceil(P / 16)`` to a block; a particle's team gets as many warps as 512
    threads a block allow.  The shared form is taken where its state fits a
    block's shared memory (X is left in global memory before the form gives
    way), else the global form; a form is never chosen because
    the other failed to run.  ``C`` does not bound the kernel: chains are
    independent clusters."""
    if D < 1 or D > _MAX_DEPTH:
        return f"max_depth={D} exceeds the kernel's table of {_MAX_DEPTH} levels"
    if P < 2:
        return f"{P} particles (the kernel needs the frozen one and another)"
    per_block = -(-P // _MAX_CLUSTER)
    if per_block > _MAX_WARPS:
        return (f"{P} particles need {per_block} to a block of "
                f"{_MAX_WARPS} warps")
    cluster = -(-P // per_block)
    cdf_staged = p <= _CDF_STAGE_COLS
    smallest = 0
    for shared in (True, False):
        if shared and S > 65535:
            continue
        for x_staged in ((True, False) if shared
                         and 4 * n * p <= _X_STAGE_BYTES else (False,)):
            plan = DrawPlan("shared" if shared else "global", cluster,
                            per_block, _MAX_WARPS // per_block, x_staged,
                            cdf_staged)
            smem = smem_bytes(plan, D, P, S, n, p, R)
            if smem <= _MAX_SMEM:
                return dataclasses.replace(plan, smem=smem)
            smallest = smem
    return (f"a block needs {smallest} bytes of shared memory (depth {D}, "
            f"{P} particles); the card offers {_MAX_SMEM}")


def step_bytes(C: int, B: int, P: int, D: int, S: int, n: int, p: int,
               R: int, pre_drawn: bool = True, shared: bool = False) -> int:
    """Bytes of one step's random blocks plus the kernel's scratch."""
    Gtot = 2**D - 1
    rands = 4 * (B * C * P * 5 * Gtot + B * D * C + B * C + B * C * R * S
                 + B * C * R + (B * D * C * P * n if pre_drawn else 0))
    scratch = 4 * (2 * C * p + (0 if shared else
                                2 * C * P * (5 * S + n) + C * n
                                + 3 * C * P * 2**D + 2 * C * _MAX_CLUSTER * S))
    return rands + scratch


def fused_draw_unsupported_reason(cfg: BartConfig, pg: PgbartConfig, X,
                                  lik_row, lik: str = "gauss",
                                  chains: Optional[int] = None):
    """None when the whole-step function covers this configuration, else the
    reason it does not (``sample()`` reports it).

    The semantic conditions are the reference's (a closed-form code, its row
    data, constant response, one output).  The size limits apply to a CUDA
    ``X`` only: the kernel's own (``launch_plan``) and half of that card's
    memory for the step's random blocks and scratch.
    """
    if lik not in LIK_CODES:
        return (f"likelihood is not fused ({lik!r}); no closed-form per-row "
                "log-likelihood is available to the whole-step function")
    if lik != "bernoulli" and lik_row is None:
        return ("likelihood is not fused-Gaussian (no per-observation row "
                "data available)")
    if cfg.response != "constant":
        return (f"response={cfg.response!r} (the whole-step function covers "
                "'constant')")
    if cfg.n_outputs != 1:
        return (f"n_outputs={cfg.n_outputs} (the whole-step function covers "
                "1; separate_trees gives each output its own forest)")
    if not (isinstance(X, torch.Tensor) and X.is_cuda):
        return None
    n, p = X.shape
    D, P, S = cfg.max_depth, pg.num_particles, cfg.n_nodes
    plan = launch_plan(chains or 1, P, D, S, n, p,
                       max(pg.num_refinements, 1))
    if isinstance(plan, str):
        return plan
    if chains is not None:
        B = max(pg.batch_size(cfg.m, True), pg.batch_size(cfg.m, False))
        need = step_bytes(chains, B, P, D, S, n, p,
                          max(pg.num_refinements, 1), pre_drawn=False,
                          shared=plan.form == "shared")
        total = torch.cuda.get_device_properties(X.device).total_memory
        if need > total // 2:
            return (f"one step's random blocks and scratch take {need} bytes, "
                    f"more than half of the card's {total}")
    return None


def fused_draw_supported(cfg: BartConfig, pg: PgbartConfig, X, lik_row,
                         lik: str = "gauss",
                         chains: Optional[int] = None) -> bool:
    """Whether the whole-step function covers this configuration."""
    return fused_draw_unsupported_reason(cfg, pg, X, lik_row, lik,
                                         chains) is None


def pgbart_step_fused_plain(state, rands, X, Y_target, rules,
                            cfg: BartConfig, pg: PgbartConfig, lik_row,
                            tuning: bool, *, lik: str = "gauss",
                            lik_const: float = 0.0):
    """Plain PyTorch version: the per-round route with every round's plain
    version, plus commit and adaptation (same signature and outputs as the
    kernel, state updated in place).  Without ``rands.rg`` it reads the block
    the generator writes out for ``rands.seed``."""
    from ..sampler.pgbart import step_rounds
    from .bign import gumbel_block

    if rands.rg is None:
        if rands.seed is None:
            raise ValueError("pgbart_step_fused: rands holds neither the row "
                             "Gumbels (rg) nor a seed to generate them from")
        C, m, _S = state.forest.split_var.shape
        rands = dataclasses.replace(rands, rg=gumbel_block(
            rands.seed, B=pg.batch_size(m, tuning), C=C, P=pg.num_particles,
            D=cfg.max_depth, n=X.shape[0], chains=rands.chains,
            chain0=rands.chain0))
    return step_rounds(state, rands, X, Y_target, rules, cfg, pg, tuning,
                       lik_row, impl="plain", lik=lik, lik_const=lik_const)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_POINTERS = (
    "f_sv", "f_sl", "f_st", "f_lf", "f_ct", "f_sp", "tree_pred", "sum_trees",
    "alpha_vec", "leaf_sd", "wf_count", "wf_mean", "wf_m2", "batch_offset",
    "iteration", "X", "y", "rules", "lik_row", "ug", "uv", "rg", "eps", "sb",
    "ures", "usel", "epsr", "uacc", "seed", "ps_sv", "ps_sl", "ps_st",
    "ps_lf", "ps_ct", "ps_li", "noi", "g_acc", "g_cnt", "g_leaf", "cdf",
    "vi_cnt", "vi")
_INTS = ("C", "P", "S", "n", "p", "m", "B", "D", "R", "lik", "tuning", "CS",
         "PB", "WP", "shared_form", "x_staged", "cdf_staged", "y_stride",
         "Cg", "c0")


class _DrawArgs(ctypes.Structure):
    """Field by field the ``DrawArgs`` of csrc/draw.cu."""

    _fields_ = ([(name, _P) for name in _POINTERS]
                + [(name, _I) for name in _INTS]
                + [("lik_const", _F), ("decay", _F),
                   ("p_grow", _F * _MAX_DEPTH)])


def target_rows(Y_target, C: int, n: int):
    """``(y, stride)`` of a growth target for the kernels: ``(n,)`` and 0
    for one target shared by the chains (``Y_target`` (n, 1)), ``(C, n)`` and
    ``n`` for one a chain (``Y_target`` (C, n, 1): a heteroscedastic model's
    scale forest, whose target follows each chain's mean forest)."""
    if isinstance(Y_target, torch.Tensor) and Y_target.dim() == 3:
        return Y_target.reshape(C, n), n
    return (Y_target.reshape(n) if isinstance(Y_target, torch.Tensor)
            else Y_target), 0


def _lib():
    lib = _build.load("draw")
    fn = lib.pgbart_step_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_DrawArgs), _P]
        fn.restype = _I
        lib.pgbart_step_max_clusters.argtypes = [ctypes.POINTER(_DrawArgs)]
        lib.pgbart_step_max_clusters.restype = _I
        lib.pgbart_step_smem_bytes.argtypes = [ctypes.POINTER(_DrawArgs)]
        lib.pgbart_step_smem_bytes.restype = ctypes.c_longlong
        lib.pgbart_step_args_size.restype = _I
        if lib.pgbart_step_args_size() != ctypes.sizeof(_DrawArgs):
            raise RuntimeError(
                "pgbart_step_fused: the argument block of csrc/draw.cu has "
                f"{lib.pgbart_step_args_size()} bytes, the wrapper's "
                f"{ctypes.sizeof(_DrawArgs)}")
    return lib


def _check(t, name, dtype, shape, dev):
    if (not isinstance(t, torch.Tensor) or t.device != dev
            or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"pgbart_step_fused: {name} must be a contiguous "
                         f"{dtype} tensor of shape {tuple(shape)} on {dev}")


# plans whose shared-memory size the library has confirmed, and the scratch
# of the latest (shapes, device): the kernel writes every word before it
# reads it, and launches on one stream run in order
_checked_plans = set()
_scratch = {}


def _scratch_for(dev, n_i: int, n_f: int):
    key = (dev, n_i, n_f)
    ws = _scratch.get(key)
    if ws is None:
        _scratch.clear()
        ws = (torch.empty((n_i,), dtype=torch.int32, device=dev),
              torch.empty((n_f,), dtype=torch.float32, device=dev))
        _scratch[key] = ws
    return ws


def pgbart_step_fused_kernel(state, rands, X, Y_target, rules,
                             cfg: BartConfig, pg: PgbartConfig, lik_row,
                             tuning: bool, *, lik: str = "gauss",
                             lik_const: float = 0.0):
    """Launch ``csrc/draw.cu`` on the current stream (no synchronisation).
    Raises on what the kernel does not take."""
    f = state.forest
    if not f.split_var.is_cuda:
        raise ValueError("pgbart_step_fused kernel needs CUDA tensors")
    dev = f.split_var.device
    C, m, S = f.split_var.shape
    n, p = X.shape
    P, D = pg.num_particles, cfg.max_depth
    B = pg.batch_size(m, tuning)
    R = max(pg.num_refinements, 1)
    Gtot = 2**D - 1
    reason = fused_draw_unsupported_reason(cfg, pg, X, lik_row, lik, chains=C)
    if reason is not None:
        raise ValueError(f"pgbart_step_fused: {reason}")
    if m != cfg.m or S != cfg.n_nodes:
        raise ValueError(f"pgbart_step_fused: the forest is ({m}, {S}), the "
                         f"configuration wants ({cfg.m}, {cfg.n_nodes})")
    if rands.rg is None and rands.seed is None:
        raise ValueError("pgbart_step_fused: rands holds neither the row "
                         "Gumbels (rg) nor a seed to generate them from")
    plan = launch_plan(C, P, D, S, n, p, R)
    f32, i32 = torch.float32, torch.int32
    Y, y_stride = target_rows(Y_target, C, n)
    checks = [
        (f.split_var, "forest.split_var", i32, (C, m, S)),
        (f.split_val, "forest.split_val", f32, (C, m, S)),
        (f.split_set, "forest.split_set", i32, (C, m, S)),
        (f.leaf, "forest.leaf", f32, (C, m, S, 1)),
        (f.count, "forest.count", f32, (C, m, S)),
        (f.slope, "forest.slope", f32, (C, m, S, 1)),
        (state.tree_pred, "tree_pred", f32, (C, m, n, 1)),
        (state.sum_trees, "sum_trees", f32, (C, n, 1)),
        (state.alpha_vec, "alpha_vec", f32, (C, p)),
        (state.leaf_sd, "leaf_sd", f32, (C, 1)),
        (state.wf_count, "wf_count", f32, (C,)),
        (state.wf_mean, "wf_mean", f32, (C, n, 1)),
        (state.wf_m2, "wf_m2", f32, (C, n, 1)),
        (state.batch_offset, "batch_offset", i32, (C,)),
        (state.iteration, "iteration", i32, (C,)),
        (X, "X", f32, (n, p)),
        (Y, "Y_target", f32, (C, n) if y_stride else (n,)),
        (rules, "rules", i32, (p,)),
        (rands.ug, "rands.ug", f32, (B, C, P, Gtot)),
        (rands.uv, "rands.uv", f32, (B, C, P, Gtot)),
        (rands.eps, "rands.eps", f32, (B, C, P, 1, 2 * Gtot)),
        (rands.sb, "rands.sb", i32, (B, C, P, Gtot)),
        (rands.ures, "rands.ures", f32, (B, D, C)),
        (rands.usel, "rands.usel", f32, (B, C)),
        (rands.epsr, "rands.epsr", f32, (B, C, R, 1, S)),
        (rands.uacc, "rands.uacc", f32, (B, C, R))]
    if rands.rg is not None:
        checks.append((rands.rg, "rands.rg", f32, (B, D, C, P, n)))
    else:
        checks.append((rands.seed, "rands.seed", i32, (2,)))
    if lik_row is not None:
        checks.append((lik_row, "lik_row", f32, (C, n, 1)))
    for t, name, dt, shape in checks:
        _check(t, name, dt, shape, dev)

    lib = _lib()
    shared = plan.form == "shared"
    # scratch: one int32 and one float32 workspace, carved by offset
    CP = C * P
    per_particle = 0 if shared else 2 * CP * S
    # (the global form's fixed-point sums: 64-bit words first, so aligned)
    child_sums = 0 if shared else CP * 2**D
    leaf_sums = 0 if shared else C * plan.cluster * S
    n_i = (2 * child_sums + 2 * leaf_sums + child_sums + 2 * per_particle
           + (0 if shared else 2 * CP * n) + C * p)
    n_f = 3 * per_particle + (0 if shared else C * n) + C * p
    ws_i, ws_f = _scratch_for(dev, n_i, n_f)
    vi = torch.empty((C, p), dtype=f32, device=dev)

    a = _DrawArgs()
    ptr = torch.Tensor.data_ptr
    for name, t in (
            ("f_sv", f.split_var), ("f_sl", f.split_val),
            ("f_st", f.split_set), ("f_lf", f.leaf), ("f_ct", f.count),
            ("f_sp", f.slope), ("tree_pred", state.tree_pred),
            ("sum_trees", state.sum_trees), ("alpha_vec", state.alpha_vec),
            ("leaf_sd", state.leaf_sd), ("wf_count", state.wf_count),
            ("wf_mean", state.wf_mean), ("wf_m2", state.wf_m2),
            ("batch_offset", state.batch_offset),
            ("iteration", state.iteration), ("X", X), ("y", Y),
            ("rules", rules), ("ug", rands.ug), ("uv", rands.uv),
            ("eps", rands.eps), ("sb", rands.sb),
            ("ures", rands.ures), ("usel", rands.usel),
            ("epsr", rands.epsr), ("uacc", rands.uacc), ("vi", vi)):
        setattr(a, name, ptr(t))
    a.rg = ptr(rands.rg) if rands.rg is not None else None
    a.seed = ptr(rands.seed) if rands.rg is None else None
    a.lik_row = ptr(lik_row) if lik_row is not None else None
    base, off = ptr(ws_i), 0
    for name, size in (("g_acc", 2 * child_sums), ("g_leaf", 2 * leaf_sums),
                       ("g_cnt", child_sums),
                       ("ps_sv", per_particle), ("ps_st", per_particle),
                       ("ps_li", 0 if shared else 2 * CP * n),
                       ("vi_cnt", C * p)):
        setattr(a, name, base + 4 * off if size else None)
        off += size
    base, off = ptr(ws_f), 0
    for name, size in (("ps_sl", per_particle), ("ps_lf", per_particle),
                       ("ps_ct", per_particle),
                       ("noi", 0 if shared else C * n), ("cdf", C * p)):
        setattr(a, name, base + 4 * off if size else None)
        off += size
    a.C, a.P, a.S, a.n, a.p, a.m, a.B, a.D, a.R = C, P, S, n, p, m, B, D, R
    a.lik, a.tuning = LIK_CODES[lik], int(bool(tuning))
    a.y_stride = y_stride
    a.Cg, a.c0 = rands.chains or C, rands.chain0
    a.CS, a.PB, a.WP = plan.cluster, plan.per_block, plan.warps
    a.shared_form = int(shared)
    a.x_staged, a.cdf_staged = int(plan.x_staged), int(plan.cdf_staged)
    a.lik_const, a.decay = float(lik_const), float(pg.split_prior_decay)
    for d in range(D):
        a.p_grow[d] = float(cfg.alpha * (1.0 + d) ** (-cfg.beta))

    with torch.cuda.device(dev):
        if (dev, plan, D, P, S, n, p, R) not in _checked_plans:
            got = int(lib.pgbart_step_smem_bytes(ctypes.byref(a)))
            if got != plan.smem:
                raise RuntimeError(
                    f"pgbart_step_fused: csrc/draw.cu lays out {got} bytes of "
                    f"shared memory for {plan}, the wrapper {plan.smem}")
            clusters = int(lib.pgbart_step_max_clusters(ctypes.byref(a)))
            if clusters < 1:
                raise RuntimeError(
                    f"pgbart_step_fused: the card cannot run a cluster of "
                    f"{plan} (cudaOccupancyMaxActiveClusters: {clusters})")
            _checked_plans.add((dev, plan, D, P, S, n, p, R))
        err = lib.pgbart_step_launch(ctypes.byref(a), _build.current_stream())
    _build.check_launch(err, "pgbart_step_fused")
    pgbart_step_fused.launches += 1
    return state, vi


def pgbart_step_fused(state, rands, X, Y_target, rules, cfg: BartConfig,
                      pg: PgbartConfig, lik_row, tuning: bool, *,
                      lik: str = "gauss", lik_const: float = 0.0,
                      impl: Optional[str] = None):
    """One whole PGBART step for all chains.

    ``state``: ``PgbartState`` with a leading chain axis, updated in place;
    ``rands``: ``StepRands`` (``rg`` may be None: the row Gumbels are then
    generated from ``rands.seed``); ``X`` (n, p) and ``rules`` (p,) are
    shared by the chains, ``Y_target`` (n, 1) too or is (C, n, 1), one
    target a chain (``target_rows``); ``lik_row`` is the (C, n, 1) row
    data of the likelihood code or ``None`` for ``"bernoulli"``.  Returns
    ``(state, variable_inclusion (C, p))``.  Runs the CUDA kernel for a state
    on a CUDA device and the plain version for one on the CPU; ``impl``
    forces ``"kernel"`` or ``"plain"``.  ``pgbart_step_fused.launches``
    counts kernel launches.
    """
    if impl is None:
        impl = "kernel" if state.forest.split_var.is_cuda else "plain"
    if impl == "kernel":
        return pgbart_step_fused_kernel(state, rands, X, Y_target, rules, cfg,
                                        pg, lik_row, tuning, lik=lik,
                                        lik_const=lik_const)
    if impl == "plain":
        reason = fused_draw_unsupported_reason(cfg, pg, None, lik_row, lik)
        if reason is not None:
            raise ValueError(f"pgbart_step_fused: {reason}")
        return pgbart_step_fused_plain(state, rands, X, Y_target, rules, cfg,
                                       pg, lik_row, tuning, lik=lik,
                                       lik_const=lik_const)
    raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")


pgbart_step_fused.launches = 0
