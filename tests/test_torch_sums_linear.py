"""The least-squares statistics of the linear response in fixed point
(``ops/sums.py::keyed_linear_sums``): the growth round's kernel and its plain
version take sum x, sum x^2 and sum x r by this rule, so that ``var_x``, the
``usable`` decision and the slope come from the same numbers on both sides
and in any order of the rows."""

import numpy as np
import pytest
import torch

from pymc_bart_tpu_torch.config import BartConfig
from pymc_bart_tpu_torch.ops import sums
from pymc_bart_tpu_torch.ops.grow import grow_round_plain


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(rng, C=2, P=3, k=2, n=3000, K=6):
    x = (rng.normal(size=(C, P, n)) * 10.0 ** rng.integers(-2, 3, (C, P, 1))
         ).astype(np.float32)
    r = (rng.normal(size=(C, k, n)) * 7).astype(np.float32)
    keys = rng.integers(-1, K + 1, size=(C, P, n))
    return x, r, keys


def _sums(x, r, keys, col, e_col, K):
    t = torch.from_numpy
    e_col = t(e_col)
    e_key = e_col[:1].expand(x.shape[0], x.shape[1], 1).expand(
        x.shape[0], x.shape[1], K).contiguous()
    return sums.keyed_linear_sums(t(x), t(r), e_col[t(col)], e_key,
                                  sums.chain_exponent(t(r)), t(keys), K)


def test_linear_sums_have_no_order_and_are_exact_sums():
    rng = np.random.default_rng(0)
    K = 6
    x, r, keys = _case(rng, K=K)
    col = np.zeros_like(keys)                    # one column: one scale
    e_col = sums.column_exponents(
        torch.from_numpy(x.reshape(-1, 1))).numpy()
    got = _sums(x, r, keys, col, e_col, K)
    perm = rng.permutation(x.shape[-1])
    again = _sums(x[..., perm].copy(), r[..., perm].copy(),
                  keys[..., perm].copy(), col[..., perm].copy(), e_col, K)
    for a, b in zip(got, again):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    s_x, s_x2, s_xr = got
    assert tuple(s_x.shape) == (2, 3, 1, K) and tuple(s_xr.shape) == (2, 3, 2, K)
    c, q, g = 1, 2, 4
    sel = keys[c, q] == g
    xd, rd = x[c, q, sel].astype(np.float64), r[c][:, sel].astype(np.float64)
    np.testing.assert_allclose(float(s_x[c, q, 0, g]), xd.sum(), rtol=1e-6)
    np.testing.assert_allclose(float(s_x2[c, q, 0, g]), (xd * xd).sum(),
                               rtol=1e-6)
    np.testing.assert_allclose(s_xr[c, q, :, g].numpy(), (rd * xd).sum(axis=1),
                               rtol=1e-6, atol=1e-6)


def test_linear_sums_hold_2_24_rows_of_the_largest_terms():
    """Every term at the top of its scale, 2^24 of them in one key: the
    integers reach 2^62 and do not overflow int64."""
    n = 2**24
    top = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))
    x = torch.full((1, 1, n), float(top))
    r = torch.full((1, 1, n), -float(top))
    zero = torch.zeros((1, 1, n), dtype=torch.int64)
    e_col = sums.column_exponents(x.reshape(n, 1))
    e_r = sums.chain_exponent(r)
    assert int(e_col[0]) == 0 and int(e_r[0]) == 0
    s_x, s_x2, s_xr = sums.keyed_linear_sums(
        x, r, e_col[zero], e_col[torch.zeros((1, 1, 1), dtype=torch.int64)],
        e_r, zero, 1)
    t = float(top)
    for got, want in ((s_x, n * t), (s_x2, n * t * t), (s_xr, -n * t * t)):
        assert float(got) == float(np.float32(want))


def test_slopes_of_a_growth_round_do_not_depend_on_the_order_of_the_rows():
    """The plain growth round with the linear response on permuted rows (the
    data, the row Gumbels and the particles' rows alike): every output the
    same bits, permuted back; ``var_x`` and ``usable`` come from the sums."""
    rng = np.random.default_rng(3)
    C, P, n, p, d = 2, 5, 400, 3, 1
    cfg = BartConfig(m=5, max_depth=4, response="mix")
    S, G = cfg.n_nodes, 2**d
    X = rng.normal(size=(n, p)).astype(np.float32) + 3.0
    X[rng.random((n, p)) < 0.05] = np.nan
    sv = np.full((C, P, S), -1, np.int32)
    sl = np.zeros((C, P, S), np.float32)
    ct = np.zeros((C, P, S), np.float32)
    left = np.nan_to_num(X[:, 0], nan=9.0) <= 3.0
    sv[:, :, 0], sl[:, :, 0] = 0, 3.0
    ct[:, :, 0], ct[:, :, 1], ct[:, :, 2] = n, left.sum(), (~left).sum()
    li = np.broadcast_to(np.where(left, 1, 2), (C, P, n)).astype(np.int32)
    lf = rng.normal(size=(C, P, 1, S)).astype(np.float32)
    sp = (0.1 * rng.normal(size=(C, P, 1, S))).astype(np.float32)
    pred = rng.normal(size=(C, P, 1, n)).astype(np.float32)
    resid = rng.normal(size=(C, 1, n)).astype(np.float32)
    llw = rng.uniform(0.5, 2, size=(C, 1, n)).astype(np.float32)
    gum = rng.gumbel(size=(C, P, n)).astype(np.float32)
    rest = [rng.random((C, P, G)).astype(np.float32) * 0.5,
            rng.random((C, P, G)).astype(np.float32),
            rng.normal(size=(C, P, 1, 2 * G)).astype(np.float32),
            rng.integers(-2**31, 2**31, size=(C, P, G)).astype(np.int32),
            rng.random((C, P, 2 * G)).astype(np.float32)]
    frozen = np.zeros((C, P), np.int32)
    frozen[:, 0] = 1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731

    def run(order):
        o = t(order)
        out = grow_round_plain(
            t(np.broadcast_to(np.arange(P, dtype=np.int32), (C, P))),
            t(frozen), t(sv), t(sl), t(np.zeros((C, P, S), np.int32)), t(lf),
            t(ct), t(sp), t(li[..., order]), t(pred[..., order]),
            t(X[order]), t(resid[..., order]), t(np.zeros(p, np.int32)),
            t(np.cumsum(np.ones((C, p), np.float32), axis=1)),
            t(np.full((C, 1), 0.3, np.float32)), t(llw[..., order]),
            t(rest[0]), t(rest[1]), t(gum[..., order]), t(rest[2]),
            t(rest[3]), t(rest[4]), d=d, cfg=cfg)
        inv = torch.argsort(o)
        return list(out[:6]) + [out[6][..., inv], out[7][..., inv], out[8]]

    a = run(np.arange(n))
    b = run(rng.permutation(n))
    for x_, y_ in zip(a, b):
        assert torch.equal(torch.nan_to_num(x_, nan=7.0),
                           torch.nan_to_num(y_, nan=7.0))
    assert (a[0][:, :, 1:3] >= 0).any() and (a[5][:, :, 0, 3:7] != 0).any()
