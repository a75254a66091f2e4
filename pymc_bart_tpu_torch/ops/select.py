"""Winner selection and leaf refinement: CUDA kernel wrapper and plain version.

Counterpart of ``pymc_bart_tpu/ops/select_pallas.py``
(``select_refine_pallas``) and of ``pymc_bart_tpu/sampler/pgbart.py::_leaf_rsum``;
the kernel is ``csrc/select.cu``.  The winner is picked by inverse CDF on
``u_sel`` over ``exp(log_w - max)``; its arrays are extracted; per-leaf
residual sums give the prior centres; ``R`` Metropolis sweeps with pre-drawn
noise refine the leaf values under likelihood x
``N(leaf residual mean / m, leaf_sd)`` prior.  ``n_outputs == 1`` and the
constant response only, as the TPU kernel; the wrapper raises otherwise.

Shapes (leading chain axis ``C``, K-major with ``k == 1``): ``sv``, ``sl``,
``st``, ``ct`` (C, P, S); ``lf`` (C, P, 1, S); ``leaf_idx`` (C, P, n) int32;
``pred`` (C, P, 1, n); ``log_w`` (C, P); ``resid``/``ll_weight`` (C, 1, n);
``eps`` (C, R, 1, S) already scaled; ``u_acc`` (C, R); ``u_sel`` (C,);
``half_inv_var`` (C,).  Returns ``sv, sl, st (C, S)``, ``lf (C, 1, S)``,
``ct (C, S)``, ``leaf_idx (C, n)``, ``pred (C, 1, n)``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .sums import (fixed_scale, keyed_sum_fixed, seq_cumsum, sum64,
                   true_div)


def select_refine_plain(sv, sl, st, lf, ct, leaf_idx, pred, log_w, resid,
                        ll_weight, eps, u_acc, u_sel, half_inv_var, *,
                        num_refinements: int, m: int = 1, ll_fn=None):
    """Plain PyTorch version (same signature and outputs as the kernel).

    ``ll_fn(pred (C, n)) -> (C,)`` replaces the Gaussian log-likelihood for
    the other closed-form codes (the kernel is Gaussian only)."""
    C, P, S = sv.shape
    n = leaf_idx.shape[2]
    if lf.shape[2] != 1:
        raise ValueError("select_refine supports n_outputs == 1 only")
    R = num_refinements

    mx = log_w.max(dim=1, keepdim=True).values
    cdf = seq_cumsum(torch.exp(log_w - mx))
    u = u_sel * cdf[:, -1]
    widx = (cdf < u[:, None]).sum(dim=1).clamp(0, P - 1)         # (C,)

    def pick(a):
        idx = widx.reshape((C, 1) + (1,) * (a.dim() - 2))
        return torch.gather(a, 1, idx.expand((C, 1) + a.shape[2:]))[:, 0]

    sv_w, sl_w, st_w, ct_w = pick(sv), pick(sl), pick(st), pick(ct)
    li_w = pick(leaf_idx)
    lf_w = pick(lf)[:, 0]                                        # (C, S)
    pred_w = pick(pred)[:, 0]                                    # (C, n)
    li64 = li_w.to(torch.int64)

    r = resid[:, 0]
    llw = ll_weight[:, 0]
    leaf_mask = ((sv_w < 0) & (ct_w > 0)).to(torch.float32)
    # per-leaf residual sums in fixed point, the other sums in float64
    # rounded once: what the whole-step kernel computes (ops/sums.py)
    leaf_rsum = keyed_sum_fixed(resid, li64[:, None, :], S,
                                *fixed_scale(resid))[:, 0, 0]    # (C, S)
    center = true_div(leaf_rsum / ct_w.clamp_min(1.0), m)
    hiv = half_inv_var

    def ll_of(pred_x):
        if ll_fn is not None:
            return ll_fn(pred_x)
        diff = r - pred_x
        return -0.5 * sum64(llw * diff * diff)

    def lp_of(lf_x):
        dev = lf_x - center
        return -hiv * sum64(leaf_mask * dev * dev)

    ll_c = ll_of(pred_w) + lp_of(lf_w)
    for i in range(R):
        lf_p = lf_w + eps[:, i, 0, :] * leaf_mask
        pred_p = torch.gather(lf_p, 1, li64)
        ll_p = ll_of(pred_p) + lp_of(lf_p)
        acc = (torch.log(u_acc[:, i]) < (ll_p - ll_c))[:, None]
        lf_w = torch.where(acc, lf_p, lf_w)
        pred_w = torch.where(acc, pred_p, pred_w)
        ll_c = torch.where(acc[:, 0], ll_p, ll_c)
    return (sv_w, sl_w, st_w, lf_w[:, None, :], ct_w, li_w,
            pred_w[:, None, :])


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    fn = _build.load("select").select_refine_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 21 + [_I] * 6 + [_P]
        fn.restype = ctypes.c_int
    return fn


def select_refine_kernel(sv, sl, st, lf, ct, leaf_idx, pred, log_w, resid,
                         ll_weight, eps, u_acc, u_sel, half_inv_var, *,
                         num_refinements: int, m: int = 1):
    """Launch ``csrc/select.cu`` on the current stream (no synchronisation)."""
    if not sv.is_cuda:
        raise ValueError("select_refine kernel needs CUDA tensors")
    dev = sv.device
    C, P, S = sv.shape
    n = leaf_idx.shape[2]
    R = num_refinements
    if lf.dim() != 4 or lf.shape[2] != 1:
        raise ValueError("select_refine supports n_outputs == 1 only")
    f32, i32 = torch.float32, torch.int32
    for t, name, dt, shape in (
            (sv, "sv", i32, (C, P, S)), (sl, "sl", f32, (C, P, S)),
            (st, "st", i32, (C, P, S)), (lf, "lf", f32, (C, P, 1, S)),
            (ct, "ct", f32, (C, P, S)), (leaf_idx, "leaf_idx", i32, (C, P, n)),
            (pred, "pred", f32, (C, P, 1, n)), (log_w, "log_w", f32, (C, P)),
            (resid, "resid", f32, (C, 1, n)),
            (ll_weight, "ll_weight", f32, (C, 1, n)),
            (eps, "eps", f32, (C, R, 1, S)), (u_acc, "u_acc", f32, (C, R)),
            (u_sel, "u_sel", f32, (C,)),
            (half_inv_var, "half_inv_var", f32, (C,))):
        if (not isinstance(t, torch.Tensor) or t.device != dev
                or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"select_refine: {name} must be a contiguous "
                             f"{dt} tensor of shape {shape} on {dev}")
    if 4 * (4 * S + S * max(1, 256 // S) + 32) > 232448:
        raise ValueError(f"select_refine kernel: {S} node slots do not fit "
                         "in shared memory")
    sv_o = torch.empty((C, S), dtype=i32, device=dev)
    sl_o = torch.empty((C, S), dtype=f32, device=dev)
    st_o = torch.empty((C, S), dtype=i32, device=dev)
    lf_o = torch.empty((C, 1, S), dtype=f32, device=dev)
    ct_o = torch.empty((C, S), dtype=f32, device=dev)
    li_o = torch.empty((C, n), dtype=i32, device=dev)
    pred_o = torch.empty((C, 1, n), dtype=f32, device=dev)
    ptr = torch.Tensor.data_ptr
    err = _lib()(
        ptr(sv), ptr(sl), ptr(st), ptr(lf), ptr(ct), ptr(leaf_idx), ptr(pred),
        ptr(log_w), ptr(resid), ptr(ll_weight), ptr(eps), ptr(u_acc),
        ptr(u_sel), ptr(half_inv_var), ptr(sv_o), ptr(sl_o), ptr(st_o),
        ptr(lf_o), ptr(ct_o), ptr(li_o), ptr(pred_o), C, P, S, n, R, m,
        _build.current_stream())
    _build.check_launch(err, "select_refine")
    select_refine.launches += 1
    return sv_o, sl_o, st_o, lf_o, ct_o, li_o, pred_o


def select_refine(*args, impl: Optional[str] = None, **kwargs):
    """Select the winner tree and refine its leaves, for all chains (kernel
    on CUDA tensors, plain version on CPU tensors; ``impl`` forces one).
    ``select_refine.launches`` counts kernel launches."""
    if impl is None:
        impl = "kernel" if args[0].is_cuda else "plain"
    if impl == "kernel":
        return select_refine_kernel(*args, **kwargs)
    if impl == "plain":
        return select_refine_plain(*args, **kwargs)
    raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")


select_refine.launches = 0
