"""The port's plain growth round against the JAX package's Pallas kernel
(interpret mode on the CPU): the same NumPy-seeded inputs go through
``grow_round_pallas`` and ``grow_round_plain``.

Tolerances: integer outputs exactly equal; ``split_val`` rtol 1e-5 /
atol 1e-6; leaves, slopes, predictions and ``ll`` rtol 1e-4 / atol 1e-5
(float sums are taken in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymc_bart_tpu.config import BartConfig
from pymc_bart_tpu.ops.grow_pallas import grow_round_pallas
from pymc_bart_tpu.ops.predict import leaf_values_at

from pymc_bart_tpu_torch.config import BartConfig as TBartConfig
from pymc_bart_tpu_torch.ops.grow import grow_round, grow_round_plain


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _make_case(seed, d, k, response, *, P=4, n=64, p=3, with_nan=False,
               rules=None, take=None):
    """A valid random particle state grown deterministically to depth d
    (the construction of tests/test_grow_pallas.py), as NumPy arrays."""
    rng = np.random.default_rng(seed)
    cfg_kw = dict(m=5, max_depth=4, n_outputs=k, response=response)
    S = 2 ** (cfg_kw["max_depth"] + 1) - 1
    G = 2**d
    rules = np.zeros(p, np.int32) if rules is None else np.asarray(
        rules, np.int32)
    X = rng.normal(size=(n, p)).astype(np.float32)
    for j in range(p):
        if rules[j] != 0:  # categorical columns hold small integer codes
            X[:, j] = rng.integers(0, 5, size=n).astype(np.float32)
    if with_nan:
        X[rng.random(size=(n, p)) < 0.1] = np.nan
    resid = rng.normal(size=(n, k)).astype(np.float32)

    sv = np.full((P, S), -1, np.int32)
    sl = np.zeros((P, S), np.float32)
    st = rng.integers(0, 2**32, size=(P, S), dtype=np.uint32)
    lf = rng.normal(size=(P, S, k)).astype(np.float32)
    ct = np.zeros((P, S), np.float32)
    sp = (0.1 * rng.normal(size=(P, S, k)).astype(np.float32)
          if response != "constant" else np.zeros((P, S, k), np.float32))
    li = np.zeros((P, n), np.int32)
    for pi in range(P):
        ct[pi, 0] = n
        for lev in range(d):
            for node in range(2**lev - 1, 2 ** (lev + 1) - 1):
                rows = np.where(li[pi] == node)[0]
                if rows.size < 4 or rng.random() < 0.3:
                    continue
                var = int(rng.integers(0, p))
                if rules[var] != 0:
                    continue
                col = np.nan_to_num(X[rows, var], nan=1e9)
                val = float(np.median(col[col < 1e8])) if (col < 1e8).any() \
                    else 0.0
                goleft = col <= val
                if goleft.all() or (~goleft).all():
                    continue
                sv[pi, node] = var
                sl[pi, node] = val
                li[pi, rows[goleft]] = 2 * node + 1
                li[pi, rows[~goleft]] = 2 * node + 2
                ct[pi, 2 * node + 1] = goleft.sum()
                ct[pi, 2 * node + 2] = (~goleft).sum()
    take = np.arange(P, dtype=np.int32) if take is None else np.asarray(
        take, np.int32)
    return dict(
        cfg_kw=cfg_kw, d=d, X=X, resid=resid, rules=rules,
        alpha_cdf=np.cumsum(rng.uniform(0.5, 2.0, size=p)).astype(np.float32),
        leaf_sd=np.full((k,), 0.3, np.float32),
        llw=rng.uniform(0.5, 2.0, size=(k, n)).astype(np.float32),
        sv=sv, sl=sl, st=st, lf=lf, ct=ct, sp=sp, li=li, take=take,
        frozen=np.arange(P) == 0,
        # two nodes in three draw a grow decision (p_grow = 0.95 (1+d)^-2)
        u_grow=(rng.random((P, G)) * 1.5 * 0.95 * (1.0 + d) ** -2.0).astype(
            np.float32),
        u_var=rng.random((P, G)).astype(np.float32),
        row_gum=rng.gumbel(size=(P, n)).astype(np.float32),
        eps=rng.normal(size=(P, 2 * G, k)).astype(np.float32),
        set_bits=rng.integers(0, 2**32, size=(P, G), dtype=np.uint32),
        u_mix=rng.random((P, 2 * G)).astype(np.float32),
    )


def _run_jax(c):
    cfg = BartConfig(**c["cfg_kw"])
    J = jnp.asarray
    X = J(c["X"])
    pred_prev = np.stack([
        np.asarray(leaf_values_at(J(c["sv"][i]), J(c["lf"][i]), J(c["sp"][i]),
                                  X, J(c["li"][i]))).T
        for i in range(c["sv"].shape[0])])                      # (P, k, n)
    out = grow_round_pallas(
        J(c["take"]), J(c["frozen"]), J(c["sv"]), J(c["sl"]), J(c["st"]),
        J(c["lf"].transpose(0, 2, 1)), J(c["ct"]),
        J(c["sp"].transpose(0, 2, 1)), J(c["li"]), J(pred_prev), X,
        J(c["resid"].T), J(c["rules"]), J(c["alpha_cdf"]), J(c["leaf_sd"]),
        J(c["llw"]), J(c["u_grow"]), J(c["u_var"]), J(c["row_gum"]),
        J(c["eps"].transpose(0, 2, 1)), J(c["set_bits"]), J(c["u_mix"]),
        d=c["d"], cfg=cfg)
    return [np.asarray(o) for o in out], pred_prev


def _run_torch(c, pred_prev, fn=grow_round_plain, **kw):
    cfg = TBartConfig(**c["cfg_kw"])

    def T(a, dtype=None):  # add the chain axis (C = 1)
        return torch.from_numpy(np.ascontiguousarray(a))[None].to(dtype)

    f32, i32 = torch.float32, torch.int32
    bits = lambda a: np.ascontiguousarray(a).view(np.int32)  # noqa: E731
    out = fn(
        T(c["take"], i32), T(c["frozen"].astype(np.int32), i32),
        T(c["sv"], i32), T(c["sl"], f32), T(bits(c["st"]), i32),
        T(c["lf"].transpose(0, 2, 1), f32), T(c["ct"], f32),
        T(c["sp"].transpose(0, 2, 1), f32), T(c["li"], i32),
        T(pred_prev, f32), torch.from_numpy(c["X"]),
        T(c["resid"].T, f32), torch.from_numpy(c["rules"]),
        T(c["alpha_cdf"], f32), T(c["leaf_sd"], f32), T(c["llw"], f32),
        T(c["u_grow"], f32), T(c["u_var"], f32), T(c["row_gum"], f32),
        T(c["eps"].transpose(0, 2, 1), f32), T(bits(c["set_bits"]), i32),
        T(c["u_mix"], f32), d=c["d"], cfg=cfg, **kw)
    out = [o[0].numpy() for o in out]
    out[2] = out[2].view(np.uint32)
    return out


_NAMES = ["split_var", "split_val", "split_set", "leaf", "count", "slope",
          "leaf_idx", "pred", "ll"]


def _compare(want, got, tag):
    for name, a, b in zip(_NAMES, want, got):
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {tag}")
        elif name == "split_val":
            # compared on internal nodes: the Pallas body commits a level's
            # split values through a one-hot matmul, so one NaN split value
            # (a subset-rule split on a missing category) turns the stored
            # value of every other node of that level into NaN (0 * NaN);
            # the port writes the grown node only.  A leaf's split value is
            # never read.
            internal = want[0] >= 0
            np.testing.assert_allclose(a[internal], b[internal], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} {tag}")
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} {tag}")


@pytest.mark.parametrize("response", ["constant", "linear", "mix"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("d", [0, 1, 3])
def test_grow_plain_matches_pallas(d, k, response):
    c = _make_case(d * 10 + k, d, k, response)
    want, pred_prev = _run_jax(c)
    got = _run_torch(c, pred_prev)
    _compare(want, got, f"d={d} k={k} {response}")
    if d == 0:  # every non-frozen root has rows: some particle must grow
        assert (got[0] >= 0).sum() > (c["sv"] >= 0).sum()


@pytest.mark.parametrize("d", [1, 3])
def test_grow_plain_matches_pallas_with_nans(d):
    c = _make_case(100 + d, d, 1, "constant", with_nan=True)
    want, pred_prev = _run_jax(c)
    _compare(want, _run_torch(c, pred_prev), f"nan d={d}")


@pytest.mark.parametrize("response", ["constant", "linear"])
def test_grow_plain_matches_pallas_onehot_subset(response):
    c = _make_case(7, 0, 1, response, p=4, rules=[0, 1, 2, 2], with_nan=True)
    c["alpha_cdf"] = np.cumsum([0.01, 1.0, 1.0, 1.0]).astype(np.float32)
    want, pred_prev = _run_jax(c)
    got = _run_torch(c, pred_prev)
    _compare(want, got, f"rules {response}")
    grown = (got[0] >= 0) & (c["sv"] < 0)
    assert set(got[0][grown].tolist()) & {1, 2, 3}  # a categorical split


def test_grow_plain_matches_pallas_ancestor_take():
    c = _make_case(3, 1, 1, "constant", take=[0, 2, 2, 1])
    want, pred_prev = _run_jax(c)
    _compare(want, _run_torch(c, pred_prev), "take")


def test_grow_dispatch_on_cpu_is_plain_and_kernel_refuses_cpu():
    c = _make_case(5, 1, 1, "constant")
    _, pred_prev = _run_jax(c)
    plain = _run_torch(c, pred_prev)
    auto = _run_torch(c, pred_prev, fn=grow_round)
    for a, b in zip(plain, auto):
        np.testing.assert_array_equal(a, b)
    assert grow_round.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        _run_torch(c, pred_prev, fn=grow_round, impl="kernel")
