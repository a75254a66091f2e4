"""Sums that reach a discrete decision, taken as the whole-step kernel takes
them (``csrc/draw.cu``), so that a plain version and the kernel round the
same numbers.

* Sums over rows or nodes of terms that differ from particle to particle (a
  log-likelihood, a prior, the Welford scale) are accumulated in float64 and
  rounded to float32 ONCE (``sum64``).  A float64 sum in another order differs
  by parts in 10^16 and rounds to the same float32 value.
* Sums over the particles of a chain (softmax total, ESS, the resampling
  CDF, the winner's CDF) are float32 sums in INDEX order (``seq_sum``,
  ``seq_cumsum``): a chain of element-wise additions, which every device
  rounds alike; the kernels add in the same order.
* A quotient by a count (``n``, ``m``, ``P - 1``) is a true division
  (``true_div``): PyTorch multiplies a CUDA tensor by the reciprocal of a
  host-scalar divisor, which is one rounding off the kernels' division.
* Sums of residuals keyed by node (child sums, the winner's leaf sums) are
  taken in FIXED POINT (``fixed_scale``, ``keyed_sum_fixed``): a residual r
  becomes the integer ``round(r * 2^k)``, with k chosen per chain and tree so
  that the largest ``|r|`` has 38 bits.  Integer addition has no order, so the
  kernel (integer atomics) and the plain version (``scatter_add_``) get the
  same integer, and one conversion back gives the same float32 bits.
"""

from __future__ import annotations

import torch

FIXED_BITS = 38           # bits of the chain's largest residual (kernel: same)


def sum64(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """Sum over ``dim`` in float64, rounded to float32 once."""
    return x.to(torch.float64).sum(dim=dim).to(torch.float32)


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by additions in index order."""
    tot = x[..., 0]
    for i in range(1, x.shape[-1]):
        tot = tot + x[..., i]
    return tot


def seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums over the last axis by additions in index order."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, dim=-1)


def true_div(x: torch.Tensor, count: float) -> torch.Tensor:
    """``x / count`` rounded once, on every device."""
    return x / torch.full((), float(count), dtype=x.dtype, device=x.device)


def fixed_scale(resid: torch.Tensor):
    """``(scale, inverse)`` float64[C] of the fixed-point sums of a chain's
    residuals ``resid`` (C, ...): powers of two with
    ``max |resid| * scale < 2^FIXED_BITS``."""
    C = resid.shape[0]
    top = resid.reshape(C, -1).abs().amax(dim=1).to(torch.float64)
    usable = (top > 0) & (top < 1e300)
    _mant, e = torch.frexp(torch.where(usable, top, torch.ones_like(top)))
    e = torch.where(usable, e, torch.zeros_like(e)).to(torch.int32)
    one = torch.ones_like(top)
    return torch.ldexp(one, FIXED_BITS - e), torch.ldexp(one, e - FIXED_BITS)


def keyed_sum_fixed(values: torch.Tensor, keys: torch.Tensor, K: int,
                    scale: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """Sums of ``values`` keyed by ``keys``, in fixed point.

    ``values`` float32 (C, k, n); ``keys`` int64 (C, P, n) with the key of
    each row in ``[0, K)`` (any other key: the row is left out); ``scale`` and
    ``inverse`` from ``fixed_scale``.  Returns float32 (C, P, k, K)."""
    C, k, n = values.shape
    P = keys.shape[1]
    q = torch.round(values.to(torch.float64) * scale[:, None, None]).to(
        torch.int64)
    idx = torch.where((keys >= 0) & (keys < K), keys, torch.full_like(keys, K))
    acc = torch.zeros((C, P, k, K + 1), dtype=torch.int64,
                      device=values.device)
    acc.scatter_add_(3, idx[:, :, None, :].expand(C, P, k, n),
                     q[:, None].expand(C, P, k, n))
    return (acc[..., :K].to(torch.float64)
            * inverse[:, None, None, None]).to(torch.float32)
