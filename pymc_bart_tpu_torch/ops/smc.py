"""SMC weight update and resampling: CUDA kernel wrapper and plain version.

Counterpart of ``pymc_bart_tpu/ops/smc_pallas.py`` (``smc_resample_pallas``);
the kernel is ``csrc/smc.cu``.  Semantics are those of ``ops/resample.py``
plus the resampling block of the per-tree SMC: ``log_w += ll - ll_prev``;
softmax over particles ``1..P-1``; ``ESS < (P-1)/2`` gate; systematic
ancestors with the ``+1`` frozen offset; reset to the log-mean weight;
``ll`` gathered at the ancestors.

``ll``, ``ll_prev``, ``log_w``: float32 (C, P); ``u``: float32 (C,).
Returns ``(log_w, take int32, ll_prev)``, each (C, P).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .resample import (effective_sample_size, normalize_log_weights,
                       systematic_indices)


def smc_resample_plain(ll, ll_prev, log_w, u):
    """Plain PyTorch version (same signature and outputs as the kernel)."""
    C, P = ll.shape
    dev = ll.device
    lw1 = log_w + ll - ll_prev
    probs, log_mean = normalize_log_weights(lw1[:, 1:])
    do = effective_sample_size(probs) < 0.5 * (P - 1)            # (C,)
    anc = systematic_indices(u, probs, P - 1) + 1
    anc = anc.clamp(1, P - 1).to(torch.int32)
    ident = torch.arange(P, dtype=torch.int32, device=dev).expand(C, P)
    take = torch.cat([ident[:, :1], torch.where(do[:, None], anc,
                                                ident[:, 1:])], dim=1)
    reset = torch.cat([lw1[:, :1], log_mean[:, None].expand(C, P - 1)], dim=1)
    lw_new = torch.where(do[:, None], reset, lw1)
    llp_new = torch.gather(ll, 1, take.to(torch.int64))
    return lw_new, take, llp_new


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    fn = _build.load("smc").smc_resample_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I, _I, _P]
        fn.restype = ctypes.c_int
    return fn


def smc_resample_kernel(ll, ll_prev, log_w, u):
    """Launch ``csrc/smc.cu`` on the current stream (no synchronisation)."""
    if not ll.is_cuda:
        raise ValueError("smc_resample kernel needs CUDA tensors")
    C, P = ll.shape
    if P < 2:
        raise ValueError("smc_resample needs at least 2 particles")
    for t, name, shape in ((ll, "ll", (C, P)), (ll_prev, "ll_prev", (C, P)),
                           (log_w, "log_w", (C, P)), (u, "u", (C,))):
        if (t.device != ll.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"smc_resample: {name} must be a contiguous "
                             f"float32 tensor of shape {shape} on {ll.device}")
    lw_o = torch.empty_like(log_w)
    take_o = torch.empty((C, P), dtype=torch.int32, device=ll.device)
    llp_o = torch.empty_like(ll)
    err = _lib()(ll.data_ptr(), ll_prev.data_ptr(), log_w.data_ptr(),
                 u.data_ptr(), lw_o.data_ptr(), take_o.data_ptr(),
                 llp_o.data_ptr(), C, P, _build.current_stream())
    _build.check_launch(err, "smc_resample")
    smc_resample.launches += 1
    return lw_o, take_o, llp_o


def smc_resample(ll, ll_prev, log_w, u, impl: Optional[str] = None):
    """One fused SMC bookkeeping step for all chains (kernel on CUDA
    tensors, plain version on CPU tensors; ``impl`` forces one).
    ``smc_resample.launches`` counts kernel launches."""
    if impl is None:
        impl = "kernel" if ll.is_cuda else "plain"
    if impl == "kernel":
        return smc_resample_kernel(ll, ll_prev, log_w, u)
    if impl == "plain":
        return smc_resample_plain(ll, ll_prev, log_w, u)
    raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")


smc_resample.launches = 0
