"""Winner selection and leaf refinement: CUDA kernel wrapper and plain version.

Counterpart of ``pymc_bart_tpu/ops/select_pallas.py``
(``select_refine_pallas``) and of ``pymc_bart_tpu/sampler/pgbart.py::_leaf_rsum``;
the kernel is ``csrc/select.cu``.  The winner's arrays are extracted;
per-leaf residual sums give the prior centres; ``R`` Metropolis sweeps with
pre-drawn noise refine the leaf values under likelihood x
``N(leaf residual mean / m, leaf_sd)`` prior.  The kernel is Gaussian with
one output; the plain version also takes ``k`` outputs and any likelihood
(``ll_fn``, under every response): the winner and refinement of a joint
forest, of the non-Gaussian codes and of the generic model likelihood, as
the JAX package runs them in XLA.  Two responses:

* ``"constant"``, as the TPU kernel: the winner by inverse CDF on ``u_sel``
  over ``exp(log_w - max)``, the prediction the leaf value;
* ``"linear"`` / ``"mix"``, as the JAX package runs them in XLA
  (``_update_one_tree``, the winner and refinement block after the growth
  rounds): a Gaussian winner by ``jax.random.categorical`` (arg-max of
  ``log_w`` plus the Gumbels ``g_sel``, first index on ties), another
  likelihood's by inverse CDF on ``u_sel`` (the ``fused_other`` branch);
  the prediction with the winner's slope term
  (``ops/predict.py::leaf_values_at``), its slopes ``sp`` extracted too.

``select_refine_linear`` is the same step for the linear and mix responses
with ``k`` outputs, written as the XLA code is (the prediction recomputed
every sweep); the tests hold the plain version's linear form to it.

Shapes (leading chain axis ``C``, K-major; ``k == 1`` for the kernel):
``sv``, ``sl``, ``st``, ``ct`` (C, P, S); ``lf`` and ``sp`` (C, P, k, S);
``leaf_idx`` (C, P, n) int32; ``pred`` (C, P, k, n); ``log_w`` (C, P);
``resid``/``ll_weight`` (C, k, n); ``eps`` (C, R, k, S) already scaled;
``u_acc`` (C, R); ``u_sel`` (C,); ``g_sel`` (C, P); ``half_inv_var`` (C,)
or (C, k); ``X`` (n, p).  Returns ``sv, sl, st (C, S)``, ``lf (C, k, S)``,
``ct (C, S)``, [``sp (C, k, S)`` for linear / mix,] ``leaf_idx (C, n)``,
``pred (C, k, n)``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .grow import node_ll
from .predict import leaf_values_at
from .sums import (FIXED_BITS, fixed_scale, from_fixed, keyed_sum_fixed, pow2,
                   seq_cumsum, sum64, true_div)

RESPONSES = ("constant", "linear", "mix")


def select_refine_plain(sv, sl, st, lf, ct, leaf_idx, pred, log_w, resid,
                        ll_weight, eps, u_acc, u_sel, half_inv_var, *,
                        num_refinements: int, m: int = 1, ll_fn=None,
                        response: str = "constant", sp=None, X=None,
                        g_sel=None, rows=None):
    """Plain PyTorch version (same signature and outputs as the kernel), for
    ``k >= 1`` outputs (``lf``/``sp`` (C, P, k, S), ``pred`` (C, P, k, n),
    ``resid``/``ll_weight`` (C, k, n), ``eps`` (C, R, k, S)).

    ``ll_fn(pred (C, k, n)) -> (C,)`` replaces the Gaussian log-likelihood
    for the other likelihoods (the kernel is Gaussian and one-output only):
    the closed-form codes and the generic model likelihood; their winner is
    drawn by inverse CDF on ``u_sel`` under every response (JAX's
    ``fused_other`` rule).  ``half_inv_var`` is (C,) (one output) or (C, k)
    (a value per output, the prior term of JAX's XLA refinement).  For
    ``response`` ``"linear"`` / ``"mix"`` the slope term ``sp[leaf] * x`` of
    every row is taken once (the sweeps move intercepts only) and added to
    each proposal's leaf value, as the kernel does; a Gaussian winner is
    then ``argmax(log_w + g_sel)``.  ``rows`` (``parallel.mesh.RowShard``):
    the row arrays are this rank's of a row-sharded model; the leaf sums and
    the Gaussian log-likelihood are reduced over the data group (an
    ``ll_fn`` reduces its own)."""
    C, P, S = sv.shape
    k = lf.shape[2]
    n = leaf_idx.shape[2]
    lin = _is_linear(response)
    R = num_refinements

    if lin and ll_fn is None:
        widx = (log_w + g_sel).argmax(dim=1)                     # (C,)
    else:
        mx = log_w.max(dim=1, keepdim=True).values
        cdf = seq_cumsum(torch.exp(log_w - mx))
        u = u_sel * cdf[:, -1]
        widx = (cdf < u[:, None]).sum(dim=1).clamp(0, P - 1)     # (C,)

    def pick(a):
        idx = widx.reshape((C, 1) + (1,) * (a.dim() - 2))
        return torch.gather(a, 1, idx.expand((C, 1) + a.shape[2:]))[:, 0]

    sv_w, sl_w, st_w, ct_w = pick(sv), pick(sl), pick(st), pick(ct)
    li_w = pick(leaf_idx)
    lf_w = pick(lf)                                              # (C, k, S)
    pred_w = pick(pred)                                          # (C, k, n)
    li64 = li_w.to(torch.int64)
    li_k = li64[:, None, :].expand(C, k, n)
    if lin:
        sp_w = pick(sp)                                          # (C, k, S)
        p = X.shape[1]
        pvar = torch.gather(sv_w.to(torch.int64), 1,
                            ((li64 - 1) // 2).clamp_min(0))
        xp = X[torch.arange(n, device=X.device).expand(C, n),
               pvar.clamp(0, p - 1)]
        xp = torch.where((li64 > 0) & (pvar >= 0),
                         torch.nan_to_num(xp, nan=0.0), torch.zeros_like(xp))
        sx = torch.gather(sp_w, 2, li_k) * xp[:, None, :]        # (C, k, n)

    leaf_mask = ((sv_w < 0) & (ct_w > 0)).to(torch.float32)[:, None, :]
    # per-leaf residual sums in fixed point, the other sums in float64
    # rounded once: what the kernels compute (ops/sums.py)
    leaf_rsum = keyed_sum_fixed(resid, li64[:, None, :], S,
                                *fixed_scale(resid, rows),
                                rows=rows)[:, 0]                 # (C, k, S)
    center = true_div(leaf_rsum / ct_w.clamp_min(1.0)[:, None, :], m)
    hiv = half_inv_var
    per_output = hiv.dim() == 2

    def ll_of(pred_x):
        if ll_fn is not None:
            return ll_fn(pred_x)
        diff = resid - pred_x
        return -0.5 * sum64((ll_weight * diff * diff).flatten(1), rows=rows)

    def lp_of(lf_x):
        # the order of products of the JAX package's constant kernel and of
        # its XLA refinement (select_refine_linear, the generic route)
        dev = lf_x - center
        if lin or per_output:
            hv = hiv if per_output else hiv[:, None]
            return -sum64((hv[:, :, None] * leaf_mask * dev * dev).flatten(1))
        return -hiv * sum64((leaf_mask * dev * dev).flatten(1))

    ll_c = ll_of(pred_w) + lp_of(lf_w)
    for i in range(R):
        lf_p = lf_w + eps[:, i] * leaf_mask
        pred_p = torch.gather(lf_p, 2, li_k)
        if lin:
            pred_p = pred_p + sx
        ll_p = ll_of(pred_p) + lp_of(lf_p)
        acc = (torch.log(u_acc[:, i]) < (ll_p - ll_c))[:, None, None]
        lf_w = torch.where(acc, lf_p, lf_w)
        pred_w = torch.where(acc, pred_p, pred_w)
        ll_c = torch.where(acc[:, 0, 0], ll_p, ll_c)
    head = (sv_w, sl_w, st_w, lf_w, ct_w)
    if lin:
        head = head + (sp_w,)
    return head + (li_w, pred_w)


def select_refine_nodes(sv, sl, st, lf, ct, leaf_idx, node_stats, log_w, w,
                        e_r, eps, u_acc, u_sel, half_inv_var, *,
                        num_refinements: int, m: int = 1):
    """Winner and refinement of a Gaussian tree in node space (JAX's
    ``suff_gauss`` branch of ``_update_one_tree``), k = 1, constant response.

    ``node_stats`` ``(N, R, Q, occ)`` (C, P, S) are the particles' node
    statistics from ``grow_round_plain(node_stats=...)`` (fixed point on the
    scale of ``e_r`` (C,)), ``w`` (C,) the chains' precisions; the other
    arguments as ``select_refine_plain``'s (``leaf_idx`` (C, P, n) may hold
    one shard's rows).  The winner is drawn as the constant response's (by
    inverse CDF on ``u_sel``); the prior centres are the winner's leaf sums
    over its counts and each of the ``num_refinements`` sweeps weighs its
    proposal by ``grow.node_ll``: no row is read until the winner's
    prediction, one gather at the end.  Every quantity is replicated over a
    data group, so a row-sharded run refines as the unsharded one does.
    Returns ``sv, sl, st (C, S)``, ``lf (C, 1, S)``, ``ct (C, S)``,
    ``leaf_idx (C, n)``, ``pred (C, 1, n)``."""
    C, P, S = sv.shape
    mx = log_w.max(dim=1, keepdim=True).values
    cdf = seq_cumsum(torch.exp(log_w - mx))
    u = u_sel * cdf[:, -1]
    widx = (cdf < u[:, None]).sum(dim=1).clamp(0, P - 1)         # (C,)

    def pick(a):
        idx = widx.reshape((C, 1) + (1,) * (a.dim() - 2))
        return torch.gather(a, 1, idx.expand((C, 1) + a.shape[2:]))

    sv_w, sl_w, st_w, ct_w, li_w = (pick(a)[:, 0] for a in (
        sv, sl, st, ct, leaf_idx))
    lf_w = pick(lf)[:, 0]                                        # (C, 1, S)
    N_w, R_w, Q_w, occ_w = (pick(a) for a in node_stats)         # (C, 1, S)
    leaf_mask = occ_w.to(torch.float32)                          # (C, 1, S)
    rsum = from_fixed(R_w, pow2(e_r - FIXED_BITS)[:, None, None])
    center = true_div(rsum / ct_w.clamp_min(1.0)[:, None, :], m)
    hiv = half_inv_var

    def ll_of(lf_x):
        return node_ll(lf_x[:, None], N_w, R_w, Q_w, occ_w, w, e_r)[:, 0]

    def lp_of(lf_x):
        dev = lf_x - center
        return -hiv * sum64((leaf_mask * dev * dev).flatten(1))

    ll_c = ll_of(lf_w) + lp_of(lf_w)
    for i in range(num_refinements):
        lf_p = lf_w + eps[:, i] * leaf_mask
        ll_p = ll_of(lf_p) + lp_of(lf_p)
        acc = (torch.log(u_acc[:, i]) < (ll_p - ll_c))
        lf_w = torch.where(acc[:, None, None], lf_p, lf_w)
        ll_c = torch.where(acc, ll_p, ll_c)
    pred_w = torch.gather(lf_w, 2, li_w.to(torch.int64)[:, None, :])
    return sv_w, sl_w, st_w, lf_w, ct_w, li_w, pred_w


def _is_linear(response: str) -> bool:
    if response not in RESPONSES:
        raise ValueError(f"response must be one of {RESPONSES}, got "
                         f"{response!r}")
    return response != "constant"


def select_refine_linear(sv, sl, st, lf, ct, sp, leaf_idx, pred, log_w,
                         resid, ll_weight, X, eps, u_acc, g_sel, leaf_sd, *,
                         num_refinements: int, m: int):
    """Winner and refinement of a linear / mix tree, all chains.

    Shapes as ``select_refine_plain`` with ``k`` outputs (``lf``/``sp``
    (C, P, k, S), ``pred`` (C, P, k, n), ``resid``/``ll_weight`` (C, k, n),
    ``eps`` (C, R, k, S) already scaled, ``leaf_sd`` (C, k)); ``g_sel``
    (C, P) Gumbels; ``X`` (n, p) the covariates the rounds routed on.  The
    winner is ``argmax(log_w + g_sel)`` (first index on ties); each of the
    ``num_refinements`` sweeps (none for 0) proposes ``lf + eps * mask`` on
    the live leaves, predicts with the winner's slopes and accepts by
    likelihood x ``N(leaf residual mean / m, leaf_sd)`` prior.  Returns
    ``sv, sl, st (C, S)``, ``lf (C, k, S)``, ``ct (C, S)``, ``sp (C, k, S)``,
    ``leaf_idx (C, n)``, ``pred (C, k, n)``."""
    C, P, S = sv.shape
    widx = (log_w + g_sel).argmax(dim=1)                          # (C,)

    def pick(a):
        idx = widx.reshape((C, 1) + (1,) * (a.dim() - 2))
        return torch.gather(a, 1, idx.expand((C, 1) + a.shape[2:]))[:, 0]

    sv_w, sl_w, st_w, ct_w, sp_w = (pick(a) for a in (sv, sl, st, ct, sp))
    lf_w, li_w, pred_w = pick(lf), pick(leaf_idx), pick(pred)
    if num_refinements == 0:
        return sv_w, sl_w, st_w, lf_w, ct_w, sp_w, li_w, pred_w
    li64 = li_w.to(torch.int64)
    leaf_mask = ((sv_w < 0) & (ct_w > 0)).to(torch.float32)[:, None, :]
    center = true_div(
        keyed_sum_fixed(resid, li64[:, None, :], S, *fixed_scale(resid))[:, 0]
        / ct_w.clamp_min(1.0)[:, None, :], m)                     # (C, k, S)
    hiv = (0.5 / (leaf_sd * leaf_sd))[:, :, None]
    spT = sp_w.transpose(1, 2)

    def ll_of(pred_x):
        diff = resid - pred_x
        return -0.5 * sum64((ll_weight * diff * diff).flatten(1))

    def lp_of(lf_x):
        dev = lf_x - center
        return -sum64((hiv * leaf_mask * dev * dev).flatten(1))

    ll_c = ll_of(pred_w) + lp_of(lf_w)
    for i in range(num_refinements):
        lf_p = lf_w + eps[:, i] * leaf_mask
        pred_p = leaf_values_at(sv_w, lf_p.transpose(1, 2), spT, X,
                                li64).transpose(1, 2)
        ll_p = ll_of(pred_p) + lp_of(lf_p)
        acc = torch.log(u_acc[:, i]) < (ll_p - ll_c)
        lf_w = torch.where(acc[:, None, None], lf_p, lf_w)
        pred_w = torch.where(acc[:, None, None], pred_p, pred_w)
        ll_c = torch.where(acc, ll_p, ll_c)
    return sv_w, sl_w, st_w, lf_w, ct_w, sp_w, li_w, pred_w


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_POINTERS = ("sv", "sl", "st", "lf", "ct", "sp", "li", "pred", "lw", "resid",
             "llw", "X", "eps", "uacc", "usel", "gsel", "hiv", "sv_o", "sl_o",
             "st_o", "lf_o", "ct_o", "sp_o", "li_o", "pred_o")
_INTS = ("C", "P", "S", "n", "p", "R", "ld_r", "m", "lin", "shared_rows")
_MAX_SMEM = 232448      # dynamic shared memory a block may take (H100)


class _SelectArgs(ctypes.Structure):
    """Field by field the ``SelectArgs`` of csrc/select.cu."""

    _fields_ = ([(name, _P) for name in _POINTERS]
                + [(name, _I) for name in _INTS])


def _lib():
    lib = _build.load("select")
    fn = lib.select_refine_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_SelectArgs), _P]
        fn.restype = _I
        lib.select_refine_smem_bytes.argtypes = [ctypes.POINTER(_SelectArgs)]
        lib.select_refine_smem_bytes.restype = ctypes.c_longlong
        lib.select_refine_args_size.restype = _I
        if lib.select_refine_args_size() != ctypes.sizeof(_SelectArgs):
            raise RuntimeError(
                "select_refine: the argument block of csrc/select.cu has "
                f"{lib.select_refine_args_size()} bytes, the wrapper's "
                f"{ctypes.sizeof(_SelectArgs)}")
    return lib


def smem_bytes(S: int, P: int, n: int, lin: bool, shared_rows: bool) -> int:
    """Dynamic shared memory of one block (mirrors csrc/select.cu::layout)."""
    off = 8 * 6 * 32 + 8 * S + 4 * 32 + 4 * P + 4 * 4 * S
    off = (off + 15) & ~15
    if shared_rows:
        off += (4 + 4 + (4 if lin else 0) + 2) * n
    return (off + 15) & ~15


# shapes whose shared-memory layout the library has confirmed
_checked_layouts = set()


def select_refine_kernel(sv, sl, st, lf, ct, leaf_idx, pred, log_w, resid,
                         ll_weight, eps, u_acc, u_sel, half_inv_var, *,
                         num_refinements: int, m: int = 1,
                         response: str = "constant", sp=None, X=None,
                         g_sel=None):
    """Launch ``csrc/select.cu`` on the current stream (no synchronisation)."""
    if not sv.is_cuda:
        raise ValueError("select_refine kernel needs CUDA tensors")
    dev = sv.device
    C, P, S = sv.shape
    n = leaf_idx.shape[2]
    R = num_refinements
    lin = _is_linear(response)
    if lf.dim() != 4 or lf.shape[2] != 1:
        raise ValueError("the select_refine kernel takes one output "
                         "(select_refine_plain takes k)")
    if R < 0 or n >= 2**24 or S >= 2**16:
        raise ValueError(f"select_refine kernel: R={R} sweeps, n={n} rows and "
                         f"S={S} slots (it takes R >= 0, n < 2^24, S < 2^16)")
    ld_r = eps.shape[1] if eps.dim() == 4 else -1
    if ld_r < max(R, 1):
        raise ValueError(f"select_refine: eps must hold at least {max(R, 1)} "
                         "sweeps")
    f32, i32 = torch.float32, torch.int32
    checks = [
        (sv, "sv", i32, (C, P, S)), (sl, "sl", f32, (C, P, S)),
        (st, "st", i32, (C, P, S)), (lf, "lf", f32, (C, P, 1, S)),
        (ct, "ct", f32, (C, P, S)), (leaf_idx, "leaf_idx", i32, (C, P, n)),
        (pred, "pred", f32, (C, P, 1, n)), (log_w, "log_w", f32, (C, P)),
        (resid, "resid", f32, (C, 1, n)),
        (ll_weight, "ll_weight", f32, (C, 1, n)),
        (eps, "eps", f32, (C, ld_r, 1, S)), (u_acc, "u_acc", f32, (C, ld_r)),
        (half_inv_var, "half_inv_var", f32, (C,))]
    if lin:
        p = X.shape[1] if isinstance(X, torch.Tensor) and X.dim() == 2 else 0
        checks += [(sp, "sp", f32, (C, P, 1, S)), (X, "X", f32, (n, p)),
                   (g_sel, "g_sel", f32, (C, P))]
        if p < 1:
            raise ValueError("select_refine: the linear and mix responses "
                             "need X (n, p)")
    else:
        p = 0
        checks.append((u_sel, "u_sel", f32, (C,)))
    for t, name, dt, shape in checks:
        if (not isinstance(t, torch.Tensor) or t.device != dev
                or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"select_refine: {name} must be a contiguous "
                             f"{dt} tensor of shape {shape} on {dev}")
    shared_rows = smem_bytes(S, P, n, lin, True) <= _MAX_SMEM
    if smem_bytes(S, P, n, lin, shared_rows) > _MAX_SMEM:
        raise ValueError(f"select_refine kernel: {S} node slots need "
                         f"{smem_bytes(S, P, n, lin, False)} bytes of shared "
                         "memory")
    outs = [torch.empty((C, S), dtype=i32, device=dev),
            torch.empty((C, S), dtype=f32, device=dev),
            torch.empty((C, S), dtype=i32, device=dev),
            torch.empty((C, 1, S), dtype=f32, device=dev),
            torch.empty((C, S), dtype=f32, device=dev),
            torch.empty((C, 1, S), dtype=f32, device=dev) if lin else None,
            torch.empty((C, n), dtype=i32, device=dev),
            torch.empty((C, 1, n), dtype=f32, device=dev)]

    def ptr(t):
        return t.data_ptr() if t is not None else None

    a = _SelectArgs(
        *(ptr(t) for t in (sv, sl, st, lf, ct, sp if lin else None, leaf_idx,
                           pred, log_w, resid, ll_weight, X if lin else None,
                           eps, u_acc, None if lin else u_sel,
                           g_sel if lin else None, half_inv_var)),
        *(ptr(t) for t in outs),
        C, P, S, n, p, R, ld_r, m, int(lin), int(shared_rows))
    lib = _lib()
    key = (S, P, n, lin, shared_rows)
    if key not in _checked_layouts:
        got = int(lib.select_refine_smem_bytes(ctypes.byref(a)))
        if got != smem_bytes(*key):
            raise RuntimeError(
                f"select_refine: csrc/select.cu lays out {got} bytes of "
                f"shared memory for {key}, the wrapper {smem_bytes(*key)}")
        _checked_layouts.add(key)
    err = lib.select_refine_launch(ctypes.byref(a), _build.current_stream())
    _build.check_launch(err, "select_refine")
    select_refine.launches += 1
    return tuple(t for t in outs if t is not None)


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
