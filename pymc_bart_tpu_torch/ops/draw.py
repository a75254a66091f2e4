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

The kernel's limits (``fused_draw_unsupported_reason``) come from the card:
one block per (chain, particle) must be resident at once (cooperative
launch: 2 blocks of 256 threads per SM are guaranteed by the kernel's
register bound, 1 if a block needs more than half of an SM's shared memory);
a block's shared memory (node arrays of the deepest level, the chain's
weights, the winner's leaves) must fit 227 KB; the step's random blocks and
the per-particle scratch must fit half of the card's memory.  The covariate
matrix stays in global memory, so neither ``n * p`` nor ``p`` is limited.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..config import BartConfig, PgbartConfig
from . import _build

LIK_CODES = {"gauss": 0, "bernoulli": 1, "het_abs": 2, "het_exp": 3,
             "cat_logit": 4}
_MAX_SMEM = 232448        # bytes of shared memory a block can use on Hopper
_THREADS = 256
_MAX_DEPTH = 16           # length of the kernel's grow-probability table


def smem_bytes(D: int, P: int, S: int) -> int:
    """Dynamic shared memory of one block (mirrors csrc/draw.cu)."""
    Gm = 2 ** (D - 1)
    words = (5 * Gm + 2 * Gm + 2 * Gm + 2 * (2 * Gm)
             + max(_THREADS, 2 * Gm) + 32 + 5 * P + 4
             + 4 * S + max(_THREADS, S))
    return 8 * Gm + 4 * words


def step_bytes(C: int, B: int, P: int, D: int, S: int, n: int, p: int,
               R: int) -> int:
    """Bytes of one step's random blocks plus the kernel's scratch."""
    Gtot = 2**D - 1
    rands = 4 * (B * C * P * 5 * Gtot + B * D * C * P * n + B * D * C + B * C
                 + B * C * R * S + B * C * R)
    scratch = 4 * (2 * C * P * (5 * S + 2 * n) + (D + 1) * C * P + 2 * C * p
                   + 2 * C * n + 2 * C + 1)
    return rands + scratch


def fused_draw_unsupported_reason(cfg: BartConfig, pg: PgbartConfig, X,
                                  lik_row, lik: str = "gauss",
                                  chains: Optional[int] = None):
    """None when the whole-step function covers this configuration, else the
    reason it does not (``sample()`` reports it).

    The semantic conditions are the reference's (a closed-form code, its row
    data, constant response, one output).  The size limits apply to a CUDA
    ``X`` only and are derived from that card (module docstring).
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
    if D > _MAX_DEPTH:
        return f"max_depth={D} exceeds the kernel's table of {_MAX_DEPTH} levels"
    smem = smem_bytes(D, P, S)
    if smem > _MAX_SMEM:
        return (f"a block needs {smem} bytes of shared memory (depth {D}, "
                f"{P} particles); the card offers {_MAX_SMEM}")
    props = torch.cuda.get_device_properties(X.device)
    if chains is not None:
        resident = props.multi_processor_count * (2 if 2 * smem <= _MAX_SMEM
                                                  else 1)
        if chains * P > resident:
            return (f"{chains} chains x {P} particles need {chains * P} "
                    f"resident blocks; this card guarantees {resident}")
        B = max(pg.batch_size(cfg.m, True), pg.batch_size(cfg.m, False))
        need = step_bytes(chains, B, P, D, S, n, p,
                          max(pg.num_refinements, 1))
        if need > props.total_memory // 2:
            return (f"one step's random blocks and scratch take {need} bytes, "
                    f"more than half of the card's {props.total_memory}")
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
    kernel, state updated in place)."""
    from ..sampler.pgbart import step_rounds

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
    "ures", "usel", "epsr", "uacc", "ps_sv", "ps_sl", "ps_st", "ps_lf",
    "ps_ct", "ps_li", "ps_pred", "ll_buf", "cdf", "resid", "noi", "root_mu",
    "vi_cnt", "bar", "status", "vi")
_INTS = ("C", "P", "S", "n", "p", "m", "B", "D", "R", "lik", "tuning")


class _DrawArgs(ctypes.Structure):
    """Field by field the ``DrawArgs`` of csrc/draw.cu."""

    _fields_ = ([(name, _P) for name in _POINTERS]
                + [(name, _I) for name in _INTS]
                + [("lik_const", _F), ("decay", _F),
                   ("p_grow", _F * _MAX_DEPTH)])


_capacity = {}


def _lib():
    lib = _build.load("draw")
    fn = lib.pgbart_step_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_DrawArgs), _I, _P]
        fn.restype = _I
        lib.pgbart_step_capacity.argtypes = [_I, _I, _I]
        lib.pgbart_step_capacity.restype = _I
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


def pgbart_step_fused_kernel(state, rands, X, Y_target, rules,
                             cfg: BartConfig, pg: PgbartConfig, lik_row,
                             tuning: bool, *, lik: str = "gauss",
                             lik_const: float = 0.0):
    """Launch ``csrc/draw.cu`` on the current stream (no synchronisation).

    Raises on what the kernel does not take.  A barrier that times out inside
    the kernel is reported by ``check_status`` after a synchronisation.
    """
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
    f32, i32 = torch.float32, torch.int32
    Y = Y_target.reshape(n) if isinstance(Y_target, torch.Tensor) else Y_target
    for t, name, dt, shape in (
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
            (X, "X", f32, (n, p)), (Y, "Y_target", f32, (n,)),
            (rules, "rules", i32, (p,)),
            (rands.ug, "rands.ug", f32, (B, C, P, Gtot)),
            (rands.uv, "rands.uv", f32, (B, C, P, Gtot)),
            (rands.rg, "rands.rg", f32, (B, D, C, P, n)),
            (rands.eps, "rands.eps", f32, (B, C, P, 1, 2 * Gtot)),
            (rands.sb, "rands.sb", i32, (B, C, P, Gtot)),
            (rands.ures, "rands.ures", f32, (B, D, C)),
            (rands.usel, "rands.usel", f32, (B, C)),
            (rands.epsr, "rands.epsr", f32, (B, C, R, 1, S)),
            (rands.uacc, "rands.uacc", f32, (B, C, R))):
        _check(t, name, dt, shape, dev)
    if lik_row is not None:
        _check(lik_row, "lik_row", f32, (C, n, 1), dev)

    lib = _lib()
    key = (dev.index, D, P, S)
    if key not in _capacity:
        _capacity[key] = int(lib.pgbart_step_capacity(D, P, S))
    capacity = _capacity[key]

    # scratch: one int32 and one float32 workspace, carved by offset; the
    # arrival counters and the status word start at zero
    CP = C * P
    n_i = 2 * CP * S * 2 + 2 * CP * n + C * p
    n_f = 2 * CP * S * 3 + 2 * CP * n + (D + 1) * CP + C * p + 2 * C * n + C
    ws_i = torch.empty((n_i,), dtype=i32, device=dev)
    ws_f = torch.empty((n_f,), dtype=f32, device=dev)
    sync = torch.zeros((C + 1,), dtype=i32, device=dev)
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
            ("rg", rands.rg), ("eps", rands.eps), ("sb", rands.sb),
            ("ures", rands.ures), ("usel", rands.usel),
            ("epsr", rands.epsr), ("uacc", rands.uacc), ("vi", vi)):
        setattr(a, name, ptr(t))
    a.lik_row = ptr(lik_row) if lik_row is not None else None
    base, off = ptr(ws_i), 0
    for name, size in (("ps_sv", 2 * CP * S), ("ps_st", 2 * CP * S),
                       ("ps_li", 2 * CP * n), ("vi_cnt", C * p)):
        setattr(a, name, base + 4 * off)
        off += size
    base, off = ptr(ws_f), 0
    for name, size in (("ps_sl", 2 * CP * S), ("ps_lf", 2 * CP * S),
                       ("ps_ct", 2 * CP * S), ("ps_pred", 2 * CP * n),
                       ("ll_buf", (D + 1) * CP), ("cdf", C * p),
                       ("resid", C * n), ("noi", C * n), ("root_mu", C)):
        setattr(a, name, base + 4 * off)
        off += size
    a.bar = ptr(sync)
    a.status = ptr(sync) + 4 * C
    a.C, a.P, a.S, a.n, a.p, a.m, a.B, a.D, a.R = C, P, S, n, p, m, B, D, R
    a.lik, a.tuning = LIK_CODES[lik], int(bool(tuning))
    a.lik_const, a.decay = float(lik_const), float(pg.split_prior_decay)
    for d in range(D):
        a.p_grow[d] = float(cfg.alpha * (1.0 + d) ** (-cfg.beta))

    err = lib.pgbart_step_launch(ctypes.byref(a), capacity,
                                 _build.current_stream())
    if err == -1:
        raise RuntimeError(
            f"pgbart_step_fused: {C} chains x {P} particles need {CP} "
            f"resident blocks, the card holds {capacity} of this kernel")
    _build.check_launch(err, "pgbart_step_fused")
    pgbart_step_fused.launches += 1
    _status.append(sync)
    del _status[:-64]
    return state, vi


# status words of the latest launches (the last entry of each tensor)
_status = []


def check_status():
    """Synchronise and raise if a launch since the last check gave up at a
    barrier (the kernel bounds every wait instead of hanging the card)."""
    if not _status:
        return
    pending, _status[:] = list(_status), []
    flags = torch.stack([s[-1] for s in pending])
    if bool(flags.ne(0).any()):
        raise RuntimeError("pgbart_step_fused: a chain barrier timed out "
                           "inside the kernel; the step's state is invalid")


def pgbart_step_fused(state, rands, X, Y_target, rules, cfg: BartConfig,
                      pg: PgbartConfig, lik_row, tuning: bool, *,
                      lik: str = "gauss", lik_const: float = 0.0,
                      impl: Optional[str] = None):
    """One whole PGBART step for all chains.

    ``state``: ``PgbartState`` with a leading chain axis, updated in place;
    ``rands``: ``StepRands``; ``X`` (n, p), ``Y_target`` (n, 1) and ``rules``
    (p,) are shared by the chains; ``lik_row`` is the (C, n, 1) row data of
    the likelihood code or ``None`` for ``"bernoulli"``.  Returns
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
