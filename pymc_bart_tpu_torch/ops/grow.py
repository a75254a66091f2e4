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
from typing import Optional

import torch

from ..config import BartConfig
from . import _build
from .trees import float_to_int32, hash_bit

_RESPONSE_CODE = {"constant": 0, "linear": 1, "mix": 2}
# per-block shared memory the card offers (Hopper: 227 KB)
_MAX_SMEM = 232448
_THREADS = 256


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

    # child sufficient statistics through a (2G, n) one-hot (deterministic
    # on every device, unlike a scatter-add with float atomics)
    cslots = hi + torch.arange(2 * G, device=dev)
    oh = (cslots[None, None, :, None] == tentative[:, :, None, :]).to(
        torch.float32)                                           # (C,P,2G,n)
    ccounts = oh.sum(-1)                                         # (C, P, 2G)
    csums = torch.einsum("ckn,cpgn->cpkg", resid, oh)            # (C,P,k,2G)
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
    ct_new[:, :, hi:hi + 2 * G] = torch.where(
        parent_ok, ccounts, ct[:, :, hi:hi + 2 * G])

    c_safe = ccounts.clamp_min(1.0)[:, :, None, :]
    mu_base = csums / c_safe / m
    pk = parent_ok[:, :, None, :]
    if lin:
        s_x = torch.einsum("cpn,cpgn->cpg", xv, oh)[:, :, None, :]
        s_x2 = torch.einsum("cpn,cpgn->cpg", xv * xv, oh)[:, :, None, :]
        s_xr = torch.einsum("ckn,cpn,cpgn->cpkg", resid, xv, oh)
        var_x = s_x2 - s_x * s_x / c_safe
        usable = (ccounts[:, :, None, :] >= 3.0) & (var_x > 1e-6)
        if cfg.response == "mix":
            um = (u_mix if u_mix is not None
                  else torch.ones((C, P, 2 * G), device=dev))
            usable = usable & (um[:, :, None, :] < 0.5)
        slope_hat = (s_xr - (s_x / c_safe) * csums) / var_x.clamp_min(1e-6)
        slope_hat = torch.where(usable, slope_hat,
                                torch.zeros_like(slope_hat))
        intercept = (csums - slope_hat * s_x) / c_safe
        mu_base = torch.where(usable, intercept / m, mu_base)
        new_csp = torch.where(pk, slope_hat / m, sp[..., hi:hi + 2 * G])
        sp_new = sp.clone()
        sp_new[..., hi:hi + 2 * G] = new_csp
    else:
        sp_new = sp
    mu = mu_base + eps * leaf_sd[:, None, :, None]
    new_clf = torch.where(pk, mu, lf[..., hi:hi + 2 * G])
    lf_new = lf.clone()
    lf_new[..., hi:hi + 2 * G] = new_clf

    # incremental prediction: only rows that moved change value
    ch_row = (tentative - hi).clamp(0, 2 * G - 1)[:, :, None, :].expand(
        C, P, k, n)
    mu_row = torch.gather(new_clf, 3, ch_row)
    if lin:
        mu_row = mu_row + torch.gather(new_csp, 3, ch_row) * xv[:, :, None, :]
    pred = torch.where(moved[:, :, None, :], mu_row, pred_prev)

    diff = resid[:, None] - pred
    ll = -0.5 * (ll_weight[:, None] * diff * diff).sum(dim=(2, 3))
    return (sv_new, sl_new, st_new, lf_new, ct_new, sp_new,
            li_new.to(torch.int32), pred, ll)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = ([_P] * 19 + [_I] + [_P] + [_P, _I] + [_P, _I] + [_P] * 9
             + [_I] * 8 + [ctypes.c_float, _I, _P])


def _lib():
    lib = _build.load("grow")
    fn = lib.grow_round_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"grow_round: {name} must be a tensor on {device}")
    if t.dtype != dtype:
        raise TypeError(f"grow_round: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"grow_round: {name} has shape {tuple(t.shape)}, wants {shape}")


def _check_rows(t, name, dtype, shape, device):
    """A (C, P, [k,] W) block that may be a column slice of a wider one:
    unit stride in the last axis, outer axes densely nested."""
    _check(t, name, dtype, shape, device)
    ld = t.stride(-2)
    ok = t.stride(-1) == 1 and ld >= shape[-1]
    for ax in range(t.dim() - 3, -1, -1):
        ok = ok and t.stride(ax) == t.stride(ax + 1) * shape[ax + 1]
    if not ok:
        raise ValueError(f"grow_round: {name} has unsupported strides "
                         f"{t.stride()}")
    return ld


def smem_bytes(G: int, k: int, response: str) -> int:
    """Dynamic shared memory of one block (mirrors csrc/grow.cu)."""
    nstat = 2 * k + 2 if response != "constant" else k
    nchunks = max(1, _THREADS // (nstat * 2 * G))
    words = 4 * G + 2 * G + 2 * G + 2 * k * 2 * G + nstat * 2 * G \
        + nstat * 2 * G * nchunks + 32
    return 8 * G + 4 * words


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
    if smem_bytes(G, k, cfg.response) > _MAX_SMEM:
        raise ValueError(
            f"grow_round kernel: level {d} with k={k} needs "
            f"{smem_bytes(G, k, cfg.response)} bytes of shared memory")
    f32, i32 = torch.float32, torch.int32
    if frozen.dtype != i32:
        frozen = frozen.to(i32)
    for t, name, dt, shape in (
            (take, "take", i32, (C, P)), (frozen, "frozen", i32, (C, P)),
            (sv, "sv", i32, (C, P, S)), (sl, "sl", f32, (C, P, S)),
            (st, "st", i32, (C, P, S)), (lf, "lf", f32, (C, P, k, S)),
            (ct, "ct", f32, (C, P, S)), (sp, "sp", f32, (C, P, k, S)),
            (leaf_idx, "leaf_idx", i32, (C, P, n)),
            (pred_prev, "pred_prev", f32, (C, P, k, n)),
            (X, "X", f32, (n, p)), (resid, "resid", f32, (C, k, n)),
            (ll_weight, "ll_weight", f32, (C, k, n)),
            (rules, "rules", i32, (p,)), (alpha_cdf, "alpha_cdf", f32, (C, p)),
            (leaf_sd, "leaf_sd", f32, (C, k)),
            (row_gum, "row_gum", f32, (C, P, n))):
        _check(t, name, dt, shape, dev)
        if not t.is_contiguous():
            raise ValueError(f"grow_round: {name} must be contiguous")
    ld_g = _check_rows(u_grow, "u_grow", f32, (C, P, G), dev)
    if (_check_rows(u_var, "u_var", f32, (C, P, G), dev) != ld_g
            or _check_rows(set_bits, "set_bits", i32, (C, P, G), dev) != ld_g):
        raise ValueError("grow_round: u_grow, u_var and set_bits must share "
                         "one row stride")
    ld_e = _check_rows(eps, "eps", f32, (C, P, k, 2 * G), dev)
    ld_m = 0
    if u_mix is not None:
        ld_m = _check_rows(u_mix, "u_mix", f32, (C, P, 2 * G), dev)

    sv_o = torch.empty_like(sv)
    sl_o = torch.empty_like(sl)
    st_o = torch.empty_like(st)
    lf_o = torch.empty_like(lf)
    ct_o = torch.empty_like(ct)
    sp_o = torch.empty_like(sp)
    li_o = torch.empty_like(leaf_idx)
    pred_o = torch.empty_like(pred_prev)
    ll_o = torch.empty((C, P), dtype=f32, device=dev)

    ptr = torch.Tensor.data_ptr
    err = _lib()(
        ptr(take), ptr(frozen), ptr(sv), ptr(sl), ptr(st), ptr(lf), ptr(ct),
        ptr(sp), ptr(leaf_idx), ptr(pred_prev), ptr(X), ptr(resid),
        ptr(ll_weight), ptr(rules), ptr(alpha_cdf), ptr(leaf_sd),
        ptr(u_grow), ptr(u_var), ptr(set_bits), ld_g, ptr(row_gum),
        ptr(eps), ld_e, ptr(u_mix) if u_mix is not None else None, ld_m,
        ptr(sv_o), ptr(sl_o), ptr(st_o), ptr(lf_o), ptr(ct_o), ptr(sp_o),
        ptr(li_o), ptr(pred_o), ptr(ll_o), C, P, S, n, p, k, d, cfg.m,
        p_grow_of(cfg, d), _RESPONSE_CODE[cfg.response],
        _build.current_stream())
    _build.check_launch(err, "grow_round")
    grow_round.launches += 1
    return sv_o, sl_o, st_o, lf_o, ct_o, sp_o, li_o, pred_o, ll_o


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
