"""The plain side of the select-refine kernel for every response, on the CPU.

``select_refine_plain`` is what ``csrc/select.cu`` is held against on the
card.  For the linear and mix responses it takes each row's slope term once
and adds it to every proposal, where ``select_refine_linear`` (the form of the
JAX package's XLA code, itself held to JAX by
``tests/test_torch_response_linear.py``) recomputes the prediction every
sweep: the two must agree bit for bit, NaN covariates, a root-only winner,
ties in ``log_w + g_sel`` and accepted and rejected sweeps included.  Every
sum of the plain version follows ``ops/sums.py``, so permuting the rows
changes no output at all.  Tolerance: none (bit patterns compared)."""

import numpy as np
import pytest
import torch

from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
from pymc_bart_tpu_torch.ops.predict import leaf_values_at
from pymc_bart_tpu_torch.ops.select import (select_refine,
                                            select_refine_linear,
                                            select_refine_plain)
from pymc_bart_tpu_torch.sampler import pgbart

C, P, DEPTH, N, P_COLS, R = 3, 6, 3, 40, 3, 4
S = 2 ** (DEPTH + 1) - 1
# per sweep: the noise scale and the accept uniform; sweep 1's proposal is far
# off (rejected), sweep 0's and 3's are small steps with a lenient uniform
SWEEPS = ((0.01, 0.5), (50.0, 0.5), (0.3, 0.9), (0.01, 1e-30))


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(seed, response):
    rng = np.random.default_rng(seed)
    sv = rng.integers(-1, P_COLS, size=(C, P, S)).astype(np.int32)
    sv[:, :, S // 2:] = -1                       # the last level: leaves
    ct = rng.integers(0, 6, size=(C, P, S)).astype(np.float32)
    li = rng.integers(0, S, size=(C, P, N)).astype(np.int32)
    lf = rng.normal(size=(C, P, 1, S)).astype(np.float32)
    sp = rng.normal(size=(C, P, 1, S)).astype(np.float32)
    if response == "mix":                        # some leaves without slope
        sp[rng.uniform(size=sp.shape) < 0.5] = 0.0
    X = rng.normal(size=(N, P_COLS)).astype(np.float32)
    X[rng.uniform(size=X.shape) < 0.15] = np.nan
    log_w = rng.normal(size=(C, P)).astype(np.float32)
    g_sel = rng.gumbel(size=(C, P)).astype(np.float32)
    # chain 0: a root-only particle wins
    sv[0, 3], li[0, 3], ct[0, 3] = -1, 0, 0.0
    ct[0, 3, 0] = N
    log_w[0, 3] = 50.0
    # chain 1: two particles tie at the top of log_w + g_sel (the first wins)
    log_w[1, [1, 4]], g_sel[1, [1, 4]] = 20.0, 3.0
    eps = np.stack([scale * rng.normal(size=(C, 1, S))
                    for scale, _ in SWEEPS], axis=1).astype(np.float32)
    u_acc = np.broadcast_to(np.array([u for _, u in SWEEPS], np.float32),
                            (C, R)).copy()
    leaf_sd = rng.uniform(0.3, 1.5, size=(C, 1)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in dict(
        sv=sv, ct=ct, li=li, lf=lf, sp=sp, X=X, log_w=log_w, g_sel=g_sel,
        eps=eps, u_acc=u_acc, leaf_sd=leaf_sd).items()}
    t["sl"] = torch.from_numpy(rng.normal(size=(C, P, S)).astype(np.float32))
    t["st"] = torch.from_numpy(rng.integers(-2**31, 2**31, size=(C, P, S),
                                            dtype=np.int64).astype(np.int32))
    # each particle's prediction as its rows see it
    t["pred"] = leaf_values_at(t["sv"], t["lf"].transpose(2, 3),
                               t["sp"].transpose(2, 3), t["X"],
                               t["li"]).transpose(2, 3).contiguous()
    t["resid"] = torch.from_numpy(
        (2.0 * rng.normal(size=(C, 1, N))).astype(np.float32))
    t["llw"] = torch.from_numpy(
        rng.uniform(0.5, 2.0, size=(C, 1, N)).astype(np.float32))
    return t


def _plain(t, response, num_refinements=R, eps=None, u_acc=None):
    sd = t["leaf_sd"][:, 0]
    return select_refine_plain(
        t["sv"], t["sl"], t["st"], t["lf"], t["ct"], t["li"], t["pred"],
        t["log_w"], t["resid"], t["llw"],
        t["eps"] if eps is None else eps,
        t["u_acc"] if u_acc is None else u_acc, None, 0.5 / (sd * sd),
        num_refinements=num_refinements, m=7, response=response, sp=t["sp"],
        X=t["X"], g_sel=t["g_sel"])


def _identical(got, want, tag):
    assert len(got) == len(want), tag
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (tag, i)
        if g.dtype == torch.float32:   # bit patterns: -0.0 is not +0.0
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), (tag, i)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("response", ["linear", "mix"])
def test_plain_linear_equals_the_xla_form_bit_for_bit(response, seed):
    t = _case(seed, response)
    got = _plain(t, response)
    want = select_refine_linear(
        t["sv"], t["sl"], t["st"], t["lf"], t["ct"], t["sp"], t["li"],
        t["pred"], t["log_w"], t["resid"], t["llw"], t["X"], t["eps"],
        t["u_acc"], t["g_sel"], t["leaf_sd"], num_refinements=R, m=7)
    _identical(got, want, f"{response} seed {seed}")
    # the cases the inputs were made for: a root-only winner, the first of
    # two tied particles, and sweeps accepted and rejected
    assert bool((got[0][0] == -1).all()) and bool((got[6][0] == 0).all())
    assert torch.equal(got[6][1], t["li"][1, 1])
    taken = []
    for r in range(1, R + 1):
        out = _plain(t, response, r, t["eps"][:, :r], t["u_acc"][:, :r])
        prev = _plain(t, response, r - 1, t["eps"][:, :max(r - 1, 1)],
                      t["u_acc"][:, :max(r - 1, 1)])
        taken.append((out[3] != prev[3]).flatten(1).any(dim=1))
    taken = torch.stack(taken)
    assert bool(taken.any()) and not bool(taken.all()), taken
    # no refinement: the winner as it was grown
    bare = _plain(t, response, 0)
    winner = (t["log_w"] + t["g_sel"]).argmax(dim=1)
    assert torch.equal(bare[3], t["lf"][torch.arange(C), winner])


@pytest.mark.parametrize("response", ["constant", "linear", "mix"])
def test_plain_select_ignores_the_order_of_the_rows(response):
    t = _case(5, response)
    perm = torch.from_numpy(np.random.default_rng(6).permutation(N))
    u = dict(t)
    for key in ("li", "pred", "resid", "llw"):
        u[key] = t[key][..., perm].contiguous()
    u["X"] = t["X"][perm].contiguous()

    def run(v):
        if response != "constant":
            return _plain(v, response)
        sd = v["leaf_sd"][:, 0]
        return select_refine_plain(
            v["sv"], v["sl"], v["st"], v["lf"], v["ct"], v["li"], v["pred"],
            v["log_w"], v["resid"], v["llw"], v["eps"], v["u_acc"],
            torch.tensor([0.1, 0.5, 0.9]), 0.5 / (sd * sd),
            num_refinements=R, m=7)

    got, want = run(u), run(t)
    rows = len(got) - 2
    _identical(got[:rows], want[:rows], f"{response} node arrays")
    _identical([got[-2], got[-1]], [want[-2][..., perm], want[-1][..., perm]],
               f"{response} rows")


class _OnCard(torch.Tensor):
    """A CPU tensor that the route gates take for one on the card: their size
    limits (the kernels' own) apply to a CUDA ``X`` only, and read nothing of
    it here but its shape."""

    @property
    def is_cuda(self):
        return True


def test_the_deep_classifier_takes_the_per_round_route_by_itself():
    """Depth 12 at 20 particles: the whole-step kernel's block does not fit
    in shared memory and the large-n kernel covers depth 8 (and no
    refinements for this code), so ``route=None`` resolves
    to the per-round route, whose winner and refinement run in plain PyTorch
    for a non-Gaussian code."""
    cfg = BartConfig(m=50, max_depth=12)
    pg = PgbartConfig(num_particles=20, num_refinements=5)
    X = torch.zeros((1000, 10)).as_subclass(_OnCard)
    taken, why = pgbart.resolve_route(None, cfg, pg, X, None, "bernoulli",
                                      chains=4, w_scalar=False, all_cont=True,
                                      x_nan=False)
    assert taken == "rounds"
    assert "depth 12" in why["fused"], why
    refinements = PgbartConfig(num_particles=20, num_refinements=0)
    assert "max_depth=12" in pgbart.resolve_route(
        None, cfg, refinements, X, None, "bernoulli", chains=4,
        w_scalar=False, all_cont=True, x_nan=False)[1]["bign"]
    # one level less: the whole-step kernel takes it
    assert pgbart.resolve_route(
        None, BartConfig(m=50, max_depth=11), pg, X, None, "bernoulli",
        chains=None, w_scalar=False, all_cont=True, x_nan=False)[0] == "fused"


def test_wrapper_dispatch_and_refusals():
    t = _case(3, "linear")
    select_refine.launches = 0
    sd = t["leaf_sd"][:, 0]
    args = (t["sv"], t["sl"], t["st"], t["lf"], t["ct"], t["li"], t["pred"],
            t["log_w"], t["resid"], t["llw"], t["eps"], t["u_acc"],
            torch.full((C,), 0.5), 0.5 / (sd * sd))
    lin = dict(num_refinements=R, m=7, response="linear", sp=t["sp"],
               X=t["X"], g_sel=t["g_sel"])
    _identical(select_refine(*args, **lin), _plain(t, "linear"), "dispatch")
    assert select_refine.launches == 0          # CPU tensors: plain version
    assert len(select_refine(*args, num_refinements=R, m=7)) == 7
    with pytest.raises(ValueError, match="CUDA"):
        select_refine(*args, impl="kernel", **lin)
    with pytest.raises(ValueError, match="response"):
        select_refine(*args, num_refinements=R, m=7, response="quadratic")
    # two outputs: the plain version takes them (the generic route's joint
    # forests); the winner is the one-output run's, the leaves (C, 2, S)
    def twice(a):
        return torch.cat([a] * 2, dim=-2).contiguous()

    two = list(args)
    for i in (3, 6, 8, 9, 10):        # lf, pred, resid, ll_weight, eps
        two[i] = twice(args[i])
    two[13] = torch.stack([args[13]] * 2, dim=1)                 # (C, 2)
    one = select_refine(*args, num_refinements=R, m=7)
    out = select_refine(*two, num_refinements=R, m=7)
    for a, b in zip(one[:3] + one[4:6], out[:3] + out[4:6]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert out[3].shape == (C, 2, t["lf"].shape[-1])
    assert out[6].shape == (C, 2, t["li"].shape[-1])
    assert torch.isfinite(out[3]).all() and torch.isfinite(out[6]).all()
