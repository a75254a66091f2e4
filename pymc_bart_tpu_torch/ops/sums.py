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

Under row sharding (``rows``: a ``parallel.mesh.RowShard``) every such sum is
reduced over the data group: the fixed-point integers by an int64 SUM (exact,
in no order, so a sharded sum has the bits of the unsharded one), the
exponents by a MAX (every shard scales by the largest value of all rows),
the float64 partial sums before their one rounding.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import row_max, row_sum

FIXED_BITS = 38           # bits of the chain's largest residual (kernel: same)


def sum64(x: torch.Tensor, dim=-1, rows=None) -> torch.Tensor:
    """Sum over ``dim`` in float64, rounded to float32 once (the partial sums
    of the data group added first, with ``rows``)."""
    return row_sum(x.to(torch.float64).sum(dim=dim), rows).to(torch.float32)


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


def alpha_cdf_of(alpha_vec: torch.Tensor) -> torch.Tensor:
    """CDF of the split weights (C, p): prefix sums accumulated in float64
    in index order and rounded to float32 once per entry, the order the
    whole-step kernel uses (a float32 scan would round differently from one
    device to the next; integer-valued weights give the same bits anyway)."""
    return torch.cumsum(alpha_vec.clamp_min(1e-12).to(torch.float64),
                        dim=1).to(torch.float32)


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


def fixed_scale(resid: torch.Tensor, rows=None):
    """``(scale, inverse)`` float64[C] of the fixed-point sums of a chain's
    residuals ``resid`` (C, ...): powers of two with
    ``max |resid| * scale < 2^FIXED_BITS``."""
    e = chain_exponent(resid, rows)
    return pow2(FIXED_BITS - e), pow2(e - FIXED_BITS)


def chain_exponent(resid: torch.Tensor, rows=None) -> torch.Tensor:
    """int32[C]: ``fixed_exponent`` of the largest ``|resid|`` of each chain
    (C, ...) (over every shard's rows, with ``rows``)."""
    C = resid.shape[0]
    top = resid.reshape(C, -1).abs().amax(dim=1).to(torch.float64)
    return fixed_exponent(row_max(top, rows))


def column_exponents(X: torch.Tensor) -> torch.Tensor:
    """int32[p]: ``fixed_exponent`` of the largest non-NaN ``|x|`` of each
    column of ``X`` (n, p)."""
    finite = torch.where(torch.isnan(X), torch.zeros_like(X), X)
    return fixed_exponent(finite.abs().amax(dim=0).to(torch.float64))


def keyed_isum(q: torch.Tensor, keys: torch.Tensor, K: int,
               rows=None) -> torch.Tensor:
    """Integer sums of ``q`` int64 (C, P, J, n) keyed by ``keys`` (C, P, n):
    int64 (C, P, J, K); a row whose key is outside ``[0, K)`` is left out.
    With ``rows`` the sums of the data group's shards are added."""
    C, P, J, n = q.shape
    idx = torch.where((keys >= 0) & (keys < K), keys, torch.full_like(keys, K))
    acc = torch.zeros((C, P, J, K + 1), dtype=torch.int64, device=q.device)
    acc.scatter_add_(3, idx[:, :, None, :].expand(C, P, J, n), q)
    return row_sum(acc[..., :K], rows)


def pack_key(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is that of ``(v, -i)``: the float32 value
    ``v`` above, the row ``i`` below (``csrc/common.cuh::pack_key`` shifted
    to the signed range), so the largest key is the largest value at its
    lowest row; one MAX over rows (and over shards, with global rows) finds
    the Gumbel winner of the kernels' tie rule."""
    b = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(b >= 2**31, 0xFFFFFFFF - b, b + 2**31)
    return (b - 2**31) * 2**32 + (0xFFFFFFFF - i.to(torch.int64))


def key_row(key: torch.Tensor) -> torch.Tensor:
    """The row ``i`` a ``pack_key`` key holds."""
    return 0xFFFFFFFF - (key & 0xFFFFFFFF)


# below every ``pack_key`` key: no row
_NO_KEY = -2**63


def gumbel_pick(gum: torch.Tensor, mask: torch.Tensor, values: torch.Tensor,
                rows=None) -> torch.Tensor:
    """The value of ``values`` at the row of largest Gumbel ``gum`` among the
    rows that ``mask`` holds (the lowest row on a tie), NaN where it holds
    none: the split-value draw of the growth rounds and of rejuvenation.

    The three arrays broadcast together, rows on the last axis; the result
    has their shape without it.  The winner is the largest ``pack_key`` of
    (Gumbel, row); with ``rows`` (``parallel.mesh.RowShard``) the rows are
    one shard's and the key holds the GLOBAL row, so one MAX over the data
    group gives the unsharded winner, and its value comes from the shard
    that owns it (an int64 SUM of the bit pattern, NaN kept)."""
    n = gum.shape[-1]
    row0 = 0 if rows is None else rows.row0
    keys = pack_key(gum, torch.arange(row0, row0 + n, device=gum.device))
    best = row_max(torch.where(mask, keys, _NO_KEY).amax(dim=-1), rows)
    found = best != _NO_KEY
    idx = key_row(best) - row0
    shape = torch.broadcast_shapes(gum.shape, mask.shape, values.shape)
    val = values.expand(shape).gather(
        -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    if rows is not None:
        own = found & (idx >= 0) & (idx < n)
        bits = torch.where(own, val.view(torch.int32).to(torch.int64), 0)
        val = row_sum(bits, rows).to(torch.int32).view(torch.float32)
    return torch.where(found, val, float("nan"))


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
                    scale: torch.Tensor, inverse: torch.Tensor,
                    rows=None) -> torch.Tensor:
    """Sums of ``values`` keyed by ``keys``, in fixed point.

    ``values`` float32 (C, k, n); ``keys`` int64 (C, P, n) with the key of
    each row in ``[0, K)`` (any other key: the row is left out); ``scale`` and
    ``inverse`` from ``fixed_scale``.  Returns float32 (C, P, k, K)."""
    C, k, n = values.shape
    P = keys.shape[1]
    q = torch.round(values.to(torch.float64) * scale[:, None, None]).to(
        torch.int64)
    acc = keyed_isum(q[:, None].expand(C, P, k, n), keys, K, rows)
    return from_fixed(acc, inverse[:, None, None, None])
