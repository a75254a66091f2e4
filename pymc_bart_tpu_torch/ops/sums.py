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
* The growth round's least-squares statistics of the linear response (sum x,
  sum x^2, sum x r per child, x the parent's split covariate) likewise
  (``keyed_linear_sums``): x on the scale of its column (``column_exponents``:
  the largest non-NaN ``|x|`` of the column has 38 bits), x^2 on its square,
  x r on the product of the column's and the chain's residual scale; the
  products are exact in float64 before they are rounded to integers.  With
  at most 2^24 rows no sum overflows 63 bits.
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


def fixed_exponent(top: torch.Tensor) -> torch.Tensor:
    """int32 exponents ``e`` with ``|v| < 2^e`` for the float64 maxima
    ``top`` (``frexp``'s; 0 where ``top`` is 0 or not finite)."""
    usable = (top > 0) & (top < 1e300)
    _mant, e = torch.frexp(torch.where(usable, top, torch.ones_like(top)))
    return torch.where(usable, e, torch.zeros_like(e)).to(torch.int32)


def pow2(e: torch.Tensor) -> torch.Tensor:
    """``2^e`` in float64 for integer exponents ``e``."""
    return torch.ldexp(torch.ones(e.shape, dtype=torch.float64,
                                  device=e.device), e)


def fixed_scale(resid: torch.Tensor):
    """``(scale, inverse)`` float64[C] of the fixed-point sums of a chain's
    residuals ``resid`` (C, ...): powers of two with
    ``max |resid| * scale < 2^FIXED_BITS``."""
    e = chain_exponent(resid)
    return pow2(FIXED_BITS - e), pow2(e - FIXED_BITS)


def chain_exponent(resid: torch.Tensor) -> torch.Tensor:
    """int32[C]: ``fixed_exponent`` of the largest ``|resid|`` of each chain
    (C, ...)."""
    C = resid.shape[0]
    return fixed_exponent(resid.reshape(C, -1).abs().amax(dim=1).to(
        torch.float64))


def column_exponents(X: torch.Tensor) -> torch.Tensor:
    """int32[p]: ``fixed_exponent`` of the largest non-NaN ``|x|`` of each
    column of ``X`` (n, p)."""
    finite = torch.where(torch.isnan(X), torch.zeros_like(X), X)
    return fixed_exponent(finite.abs().amax(dim=0).to(torch.float64))


def keyed_isum(q: torch.Tensor, keys: torch.Tensor, K: int) -> torch.Tensor:
    """Integer sums of ``q`` int64 (C, P, J, n) keyed by ``keys`` (C, P, n):
    int64 (C, P, J, K); a row whose key is outside ``[0, K)`` is left out."""
    C, P, J, n = q.shape
    idx = torch.where((keys >= 0) & (keys < K), keys, torch.full_like(keys, K))
    acc = torch.zeros((C, P, J, K + 1), dtype=torch.int64, device=q.device)
    acc.scatter_add_(3, idx[:, :, None, :].expand(C, P, J, n), q)
    return acc[..., :K]


def from_fixed(acc: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """float32 of the integer sums ``acc`` times ``inverse`` (float64)."""
    return (acc.to(torch.float64) * inverse).to(torch.float32)


def keyed_linear_sums(xv: torch.Tensor, resid: torch.Tensor,
                      e_row: torch.Tensor, e_key: torch.Tensor,
                      e_r: torch.Tensor, keys: torch.Tensor, K: int):
    """Sums of x, x^2 and x r keyed by ``keys``, in fixed point.

    ``xv`` float32 (C, P, n) the covariate of each row (NaN already 0);
    ``resid`` float32 (C, k, n); ``e_row`` (C, P, n) the column exponent of
    each row's covariate and ``e_key`` (C, P, K) of each key's
    (``column_exponents``); ``e_r`` (C,) the chains' residual exponents
    (``chain_exponent``); ``keys`` int64 (C, P, n).  Returns float32
    ``(sum x (C, P, 1, K), sum x^2 (C, P, 1, K), sum x r (C, P, k, K))``.
    The products are exact in float64 before they are rounded."""
    def exponents(e_x):  # of the scales of x, x^2 and x r
        e_x = e_x.to(torch.int32)
        return (FIXED_BITS - e_x, FIXED_BITS - 2 * e_x,
                FIXED_BITS - e_x - e_r.to(torch.int32)[:, None, None])

    e1, e2, er = exponents(e_row)
    xd = xv.to(torch.float64)
    q = torch.cat([
        torch.round(xd * pow2(e1))[:, :, None],
        torch.round(xd * xd * pow2(e2))[:, :, None],
        torch.round(resid.to(torch.float64)[:, None] * xd[:, :, None]
                    * pow2(er)[:, :, None])], dim=2).to(torch.int64)
    acc = keyed_isum(q, keys, K)                                  # (C,P,2+k,K)
    e1, e2, er = exponents(e_key)
    return (from_fixed(acc[:, :, 0:1], pow2(-e1)[:, :, None]),
            from_fixed(acc[:, :, 1:2], pow2(-e2)[:, :, None]),
            from_fixed(acc[:, :, 2:], pow2(-er)[:, :, None]))


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
    acc = keyed_isum(q[:, None].expand(C, P, k, n), keys, K)
    return from_fixed(acc, inverse[:, None, None, None])
