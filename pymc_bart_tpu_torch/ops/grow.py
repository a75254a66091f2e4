"""One PGBART growth round: CUDA kernel wrapper and plain PyTorch version.

Counterpart of ``pymc_bart_tpu/ops/grow_pallas.py`` (``grow_round_pallas``,
body ``_grow_math``) and of the growth-round helpers of
``pymc_bart_tpu/sampler/pgbart.py`` (``_grow_round``, ``_grow_round_const``,
``_child_stats``).  The kernel is ``csrc/grow.cu``.

One call advances every particle of every chain by one tree level ``d``:
ancestor read through ``take``; grow decision ``u_grow < alpha (1+d)^-beta``
on live leaves; split variable by inverse CDF; split row by Gumbel arg-max
within the node; routing under continuous / one-hot / subset rules with
NaN -> right; child ``(count, sum r)`` and for ``linear``/``mix``
``(sum x, sum x^2, sum x r)``; empty-child revert; child leaf values
``N(sum r / count / m, leaf_sd)`` and slopes; incremental prediction;
Gaussian log-likelihood ``-1/2 sum w (r - pred)^2``.

Kernel and plain version take every sum by the rule of ``ops/sums.py``: the
child sums keyed by child in fixed point (the residual on the chain's scale,
x, x^2 and x r on their column's), the log-likelihood in float64 rounded
once, quotients as true divisions; so they agree bit for bit.

Layout (a leading chain axis ``C`` everywhere the JAX route is vmapped;
K-major like the Pallas functions): ``take``/``frozen`` (C, P); ``sv``,
``sl``, ``st``, ``ct`` (C, P, S); ``lf``/``sp`` (C, P, k, S); ``leaf_idx``
(C, P, n) int32; ``pred`` (C, P, k, n); ``X`` (n, p) shared by the chains;
``resid``/``ll_weight`` (C, k, n); ``rules`` (p,); ``alpha_cdf`` (C, p);
``leaf_sd`` (C, k); ``u_grow``/``u_var``/``set_bits`` (C, P, G);
``row_gum`` (C, P, n); ``eps`` (C, P, k, 2G); ``u_mix`` (C, P, 2G).
``st`` and ``set_bits`` are ``int32`` bit patterns of the JAX ``uint32``.

Dispatch: the kernel runs when the tensors are on a CUDA device, the plain
version when they are on the CPU; ``impl="kernel"|"plain"`` forces one.
Nothing falls back: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Optional

import torch

from ..config import BartConfig
from . import _build
from .sums import (FIXED_BITS, chain_exponent, column_exponents, keyed_isum,
                   keyed_linear_sums, keyed_sum_fixed, pow2, sum64, true_div)
from .trees import float_to_int32, hash_bit

_RESPONSE_CODE = {"constant": 0, "linear": 1, "mix": 2}
# per-block shared memory the card offers (Hopper: 227 KB)
_MAX_SMEM = 232448


def p_grow_of(cfg: BartConfig, d: int) -> float:
    return float(cfg.alpha * (1.0 + d) ** (-cfg.beta))


def _gather_p(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[c, idx[c, q], ...] along the particle axis."""
    view = idx.reshape(idx.shape + (1,) * (a.dim() - 2))
    return torch.gather(a, 1, view.expand(idx.shape + a.shape[2:]))


def grow_round_plain(take, frozen, sv, sl, st, lf, ct, sp, leaf_idx,
                     pred_prev, X, resid, rules, alpha_cdf, leaf_sd,
                     ll_weight, u_grow, u_var, row_gum, eps, set_bits,
                     u_mix=None, *, d: int, cfg: BartConfig):
    """Plain PyTorch growth round (same signature and outputs as the kernel).

    Returns ``(sv, sl, st, lf, ct, sp, leaf_idx, pred, ll)`` with ``ll`` (C, P).
    NaN-able values (``sl`` holds NaN split values) are blended with
    ``torch.where`` only, never with mask arithmetic.
    """
    C, P, S = sv.shape
    n, p = X.shape
    k = lf.shape[2]
    dev = sv.device
    lo, hi = 2**d - 1, 2 ** (d + 1) - 1
    G = hi - lo
    p_grow = p_grow_of(cfg, d)
    lin = cfg.response != "constant"
    m = float(cfg.m)

    tk = take.to(torch.int64)
    fz = torch.gather(frozen.to(torch.bool), 1, tk)[:, :, None]   # (C, P, 1)
    sv, sl, st, lf, ct, sp, li, pred_prev = (
        _gather_p(a, tk) for a in (sv, sl, st, lf, ct, sp, leaf_idx,
                                   pred_prev))
    li = li.to(torch.int64)

    node_sv = sv[:, :, lo:hi]
    node_ct = ct[:, :, lo:hi]
    want = (u_grow < p_grow) & (node_sv < 0) & (node_ct >= 2.0) & ~fz

    # split variable by inverse CDF over the alpha weights
    u_v = u_var * alpha_cdf[:, None, p - 1:p]
    var_s = (alpha_cdf[:, None, None, :] < u_v[..., None]).sum(-1)
    var_s = var_s.clamp(0, p - 1)                                # (C, P, G)

    in_level = (li >= lo) & (li < hi)                            # (C, P, n)
    g_row = (li - lo).clamp(0, G - 1)
    slots = torch.arange(G, device=dev)
    onehot = slots[None, None, :, None] == (li - lo)[:, :, None, :]

    # uniform member row per node: Gumbel arg-max, first index on ties
    neg_inf = torch.full((), float("-inf"), device=dev)
    scores = torch.where(onehot, row_gum[:, :, None, :], neg_inf)
    row_sel = scores.argmax(dim=-1)                              # (C, P, G)

    node_sl = sl[:, :, lo:hi]
    node_st = st[:, :, lo:hi]
    varx = torch.where(fz, node_sv.to(torch.int64), var_s)
    varx_c = varx.clamp(0, p - 1)
    active = torch.where(fz, node_sv >= 0, want)

    # per row: its node's split variable, covariate value and rule
    varx_row = torch.where(in_level, torch.gather(varx_c, 2, g_row),
                           torch.zeros_like(g_row))
    rows = torch.arange(n, device=dev)
    xraw = X[rows.expand(varx_row.shape), varx_row]              # (C, P, n)
    xv_nan = torch.isnan(xraw)
    xv = torch.where(xv_nan, torch.zeros_like(xraw), xraw)
    rule_row = rules[varx_row]

    val_raw = torch.gather(xraw, 2, row_sel)                     # NaN kept
    valx = torch.where(fz, node_sl, val_raw)
    setx = torch.where(fz, node_st, set_bits)
    valx_row = torch.gather(valx, 2, g_row)
    setx_row = torch.gather(setx, 2, g_row)
    active_row = torch.gather(active, 2, g_row)

    anynan = xv_nan | torch.isnan(valx_row)
    cont = (xv <= valx_row) & ~anynan
    eq_rule = (xv == valx_row) & ~anynan
    subset = (eq_rule | hash_bit(float_to_int32(xv), setx_row)) & ~xv_nan
    left = torch.where(rule_row == 0, cont,
                       torch.where(rule_row == 1, eq_rule, subset))
    row_active = in_level & active_row
    child = 2 * li + 1 + (~left).to(torch.int64)
    tentative = torch.where(row_active, child, li)

    # child sufficient statistics keyed by the child slot: counts, and sums
    # in fixed point (``ops/sums.py``; no order of addition: the same bits as
    # the kernel's integer atomics)
    G2 = 2 * G
    key = tentative - hi
    e_r = chain_exponent(resid)                                  # (C,)
    ccounts = keyed_isum(torch.ones((C, P, 1, n), dtype=torch.int64,
                                    device=dev), key, G2)[:, :, 0].to(
        torch.float32)                                           # (C, P, 2G)
    csums = keyed_sum_fixed(resid, key, G2, pow2(FIXED_BITS - e_r),
                            pow2(e_r - FIXED_BITS))              # (C,P,k,2G)
    cl = ccounts[..., 0::2]
    cr = ccounts[..., 1::2]
    grow_ok = want & (cl > 0) & (cr > 0)
    active_final = torch.where(fz, node_sv >= 0, grow_ok)
    moved = in_level & torch.gather(active_final, 2, g_row)
    li_new = torch.where(moved, child, li)

    sv_new = sv.clone()
    sl_new = sl.clone()
    st_new = st.clone()
    sv_new[:, :, lo:hi] = torch.where(grow_ok, var_s.to(sv.dtype), node_sv)
    sl_new[:, :, lo:hi] = torch.where(grow_ok, val_raw, node_sl)
    st_new[:, :, lo:hi] = torch.where(grow_ok, set_bits, node_st)

    parent_ok = grow_ok.repeat_interleave(2, dim=-1)             # (C, P, 2G)
    ct_new = ct.clone()
    ct_new[:, :, hi:hi + G2] = torch.where(
        parent_ok, ccounts, ct[:, :, hi:hi + G2])

    c_safe = ccounts.clamp_min(1.0)[:, :, None, :]
    mu_base = true_div(csums / c_safe, m)
    pk = parent_ok[:, :, None, :]
    if lin:
        # least-squares slope of the child residual on the parent's split
        # covariate: sum x, x^2, x r in fixed point on the column's scale
        e_x = column_exponents(X)                                # (p,)
        s_x, s_x2, s_xr = keyed_linear_sums(
            xv, resid, e_x[varx_row], e_x[varx_c].repeat_interleave(2, dim=-1),
            e_r, key, G2)
        var_x = s_x2 - s_x * s_x / c_safe
        usable = (ccounts[:, :, None, :] >= 3.0) & (var_x > 1e-6)
        if cfg.response == "mix":
            um = (u_mix if u_mix is not None
                  else torch.ones((C, P, G2), device=dev))
            usable = usable & (um[:, :, None, :] < 0.5)
        slope_hat = (s_xr - (s_x / c_safe) * csums) / var_x.clamp_min(1e-6)
        slope_hat = torch.where(usable, slope_hat,
                                torch.zeros_like(slope_hat))
        intercept = (csums - slope_hat * s_x) / c_safe
        mu_base = torch.where(usable, true_div(intercept, m), mu_base)
        new_csp = torch.where(pk, true_div(slope_hat, m), sp[..., hi:hi + G2])
        sp_new = sp.clone()
        sp_new[..., hi:hi + G2] = new_csp
    else:
        sp_new = sp
    mu = mu_base + eps * leaf_sd[:, None, :, None]
    new_clf = torch.where(pk, mu, lf[..., hi:hi + G2])
    lf_new = lf.clone()
    lf_new[..., hi:hi + G2] = new_clf

    # incremental prediction: only rows that moved change value
    ch_row = key.clamp(0, G2 - 1)[:, :, None, :].expand(C, P, k, n)
    mu_row = torch.gather(new_clf, 3, ch_row)
    if lin:
        mu_row = mu_row + torch.gather(new_csp, 3, ch_row) * xv[:, :, None, :]
    pred = torch.where(moved[:, :, None, :], mu_row, pred_prev)

    diff = resid[:, None] - pred
    ll = -0.5 * sum64((ll_weight[:, None] * diff * diff).flatten(2))
    return (sv_new, sl_new, st_new, lf_new, ct_new, sp_new,
            li_new.to(torch.int32), pred, ll)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_POINTERS = ("take", "frozen", "sv", "sl", "st", "lf", "ct", "sp", "li",
             "pred", "X", "resid", "llw", "rules", "cdf", "lsd", "u_grow",
             "u_var", "set_bits", "row_gum", "eps", "u_mix", "x_exp", "sv_o",
             "sl_o", "st_o", "lf_o", "ct_o", "sp_o", "li_o", "pred_o", "ll_o")
_INTS = ("ld_g", "ld_e", "ld_m", "C", "P", "S", "n", "p", "k", "d", "m",
         "response", "shared_rows")


class _GrowArgs(ctypes.Structure):
    """Field by field the ``GrowArgs`` of csrc/grow.cu."""

    _fields_ = ([(name, _P) for name in _POINTERS]
                + [(name, _I) for name in _INTS] + [("p_grow", ctypes.c_float)])


def _lib():
    lib = _build.load("grow")
    fn = lib.grow_round_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_GrowArgs), _P]
        fn.restype = _I
        lib.grow_round_smem_bytes.argtypes = [ctypes.POINTER(_GrowArgs)]
        lib.grow_round_smem_bytes.restype = ctypes.c_longlong
        lib.grow_round_args_size.restype = _I
        if lib.grow_round_args_size() != ctypes.sizeof(_GrowArgs):
            raise RuntimeError(
                "grow_round: the argument block of csrc/grow.cu has "
                f"{lib.grow_round_args_size()} bytes, the wrapper's "
                f"{ctypes.sizeof(_GrowArgs)}")
    return lib


def _check(t, name, dtype, shape, dev):
    if (not isinstance(t, torch.Tensor) or t.dtype != dtype
            or t.shape != shape or t.device != dev or not t.is_contiguous()):
        raise ValueError(f"grow_round: {name} must be a contiguous {dtype} "
                         f"tensor of shape {tuple(shape)} on {dev}")


def _check_rows(t, name, dtype, shape, dev):
    """A (C, P, [k,] W) block that may be a column slice of a wider one:
    unit stride in the last axis, outer axes densely nested."""
    if (not isinstance(t, torch.Tensor) or t.dtype != dtype
            or t.shape != shape or t.device != dev):
        raise ValueError(f"grow_round: {name} must be a {dtype} tensor of "
                         f"shape {tuple(shape)} on {dev}")
    ld = t.stride(-2)
    ok = t.stride(-1) == 1 and ld >= shape[-1]
    for ax in range(t.dim() - 3, -1, -1):
        ok = ok and t.stride(ax) == t.stride(ax + 1) * shape[ax + 1]
    if not ok:
        raise ValueError(f"grow_round: {name} has unsupported strides "
                         f"{t.stride()}")
    return ld


def smem_bytes(G: int, k: int, response: str, n: int,
               shared_rows: bool) -> int:
    """Dynamic shared memory of one block (mirrors csrc/grow.cu::layout)."""
    ns = 2 * k + 2 if response != "constant" else k
    off = (8 * G + 8 * ns * 2 * G + 8 * 3 * G + 8 * 32 + 4 * 2 * G
           + 4 * 4 * G + 4 + 4 * 2 * G + 2 * 4 * k * 2 * G)
    off = (off + 15) & ~15
    if shared_rows:
        off += 2 * n
    return (off + 15) & ~15


# the column exponents of the latest X (a weak reference, its version, the
# exponents): sample() hands every growth round the same X
_x_exp = [None, -1, None]


def _column_exponents_cached(X: torch.Tensor) -> torch.Tensor:
    ref, version, e = _x_exp
    if ref is None or ref() is not X or version != X._version:
        e = column_exponents(X).contiguous()
        _x_exp[:] = [weakref.ref(X), X._version, e]
    return e


def grow_round_kernel(take, frozen, sv, sl, st, lf, ct, sp, leaf_idx,
                      pred_prev, X, resid, rules, alpha_cdf, leaf_sd,
                      ll_weight, u_grow, u_var, row_gum, eps, set_bits,
                      u_mix=None, *, d: int, cfg: BartConfig):
    """Launch ``csrc/grow.cu`` on the current stream (no synchronisation)."""
    if not sv.is_cuda:
        raise ValueError("grow_round kernel needs CUDA tensors")
    dev = sv.device
    C, P, S = sv.shape
    n, p = X.shape
    k = lf.shape[2]
    G = 2**d
    if S != cfg.n_nodes or not 0 <= d < cfg.max_depth:
        raise ValueError(f"grow_round: level {d} outside a depth-"
                         f"{cfg.max_depth} tree with {S} slots")
    if not 1 <= k <= 8 or n >= 2**24:
        raise ValueError(f"grow_round kernel: k={k} outputs and n={n} rows "
                         "(it takes 1 <= k <= 8 and n < 2^24)")
    shared_rows = smem_bytes(G, k, cfg.response, n, True) <= _MAX_SMEM
    if smem_bytes(G, k, cfg.response, n, shared_rows) > _MAX_SMEM:
        raise ValueError(
            f"grow_round kernel: level {d} with k={k} needs "
            f"{smem_bytes(G, k, cfg.response, n, False)} bytes of shared "
            "memory")
    f32, i32 = torch.float32, torch.int32
    if frozen.dtype != i32:
        frozen = frozen.to(i32)
    CP, CPS, CPkS = (C, P), (C, P, S), (C, P, k, S)
    for t, name, dt, shape in (
            (take, "take", i32, CP), (frozen, "frozen", i32, CP),
            (sv, "sv", i32, CPS), (sl, "sl", f32, CPS), (st, "st", i32, CPS),
            (lf, "lf", f32, CPkS), (ct, "ct", f32, CPS), (sp, "sp", f32, CPkS),
            (leaf_idx, "leaf_idx", i32, (C, P, n)),
            (pred_prev, "pred_prev", f32, (C, P, k, n)),
            (X, "X", f32, (n, p)), (resid, "resid", f32, (C, k, n)),
            (ll_weight, "ll_weight", f32, (C, k, n)),
            (rules, "rules", i32, (p,)), (alpha_cdf, "alpha_cdf", f32, (C, p)),
            (leaf_sd, "leaf_sd", f32, (C, k)),
            (row_gum, "row_gum", f32, (C, P, n))):
        _check(t, name, dt, shape, dev)
    ld_g = _check_rows(u_grow, "u_grow", f32, (C, P, G), dev)
    if (_check_rows(u_var, "u_var", f32, (C, P, G), dev) != ld_g
            or _check_rows(set_bits, "set_bits", i32, (C, P, G), dev) != ld_g):
        raise ValueError("grow_round: u_grow, u_var and set_bits must share "
                         "one row stride")
    ld_e = _check_rows(eps, "eps", f32, (C, P, k, 2 * G), dev)
    ld_m = 0
    if u_mix is not None:
        ld_m = _check_rows(u_mix, "u_mix", f32, (C, P, 2 * G), dev)

    outs = (torch.empty_like(sv), torch.empty_like(sl), torch.empty_like(st),
            torch.empty_like(lf), torch.empty_like(ct), torch.empty_like(sp),
            torch.empty_like(leaf_idx), torch.empty_like(pred_prev),
            torch.empty((C, P), dtype=f32, device=dev))
    a = _GrowArgs(
        *(t.data_ptr() for t in (
            take, frozen, sv, sl, st, lf, ct, sp, leaf_idx, pred_prev, X,
            resid, ll_weight, rules, alpha_cdf, leaf_sd, u_grow, u_var,
            set_bits, row_gum, eps)),
        u_mix.data_ptr() if u_mix is not None else None,
        _column_exponents_cached(X).data_ptr(),
        *(t.data_ptr() for t in outs),
        ld_g, ld_e, ld_m, C, P, S, n, p, k, d, cfg.m,
        _RESPONSE_CODE[cfg.response], int(shared_rows), p_grow_of(cfg, d))
    lib = _lib()
    key = (G, k, cfg.response, n, shared_rows)
    if key not in _checked_layouts:
        got = int(lib.grow_round_smem_bytes(ctypes.byref(a)))
        if got != smem_bytes(*key):
            raise RuntimeError(
                f"grow_round: csrc/grow.cu lays out {got} bytes of shared "
                f"memory for {key}, the wrapper {smem_bytes(*key)}")
        _checked_layouts.add(key)
    err = lib.grow_round_launch(ctypes.byref(a), _build.current_stream())
    _build.check_launch(err, "grow_round")
    grow_round.launches += 1
    return outs


# shapes whose shared-memory layout the library has confirmed
_checked_layouts = set()


def grow_round(*args, impl: Optional[str] = None, **kwargs):
    """One fused growth round for all particles of all chains.

    Runs the CUDA kernel for CUDA tensors and the plain version for CPU
    tensors; ``impl`` forces ``"kernel"`` or ``"plain"``.
    ``grow_round.launches`` counts kernel launches.
    """
    if impl is None:
        impl = "kernel" if args[2].is_cuda else "plain"
    if impl == "kernel":
        return grow_round_kernel(*args, **kwargs)
    if impl == "plain":
        return grow_round_plain(*args, **kwargs)
    raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")


grow_round.launches = 0
