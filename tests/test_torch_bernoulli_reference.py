"""The large-n BART classifier against its plain PyTorch reference
(``torch_reference/bart_bernoulli.py``), and the spans and counters of the
large-n step.  No JAX: on the card run it with ``python -m pytest
--noconftest tests/test_torch_bernoulli_reference.py -m card``.

On the CPU, at a tiny size (n = 300, p = 4, m = 4, 5 particles, depth 4, 2
chains, half the trees a step), seeded random forests, labels and blocks:
``pgbart_step_bign(lik="bernoulli", impl="plain")`` against the reference
tree by tree for three steps; the reference's descent and log-likelihood
against the port's prediction; ``sample()``'s normal path takes the large-n
route for the classifier at the benchmark's size.  On the card (``card``)
the kernel against the reference at the benchmark cell's widths (n =
50,000, p = 10, m = 50, 10 particles, depth 6, 4 chains) and the launch
counter.

Rules of the comparison: tree structure (split variables, split values, row
counts) and inclusion counts equal exactly.  Leaves and the sum of trees
within ``LEAF_TOL`` and ``SUM_TOL``: both sides sum rows in float64 and
round once, so a sum taken in another order can land one float32 step
apart at a halfway point; a leaf is such a sum over a count, the sum of
trees adds one leaf to the other trees, |F| < 16.  A prediction row kept in
float16 (11 bits) is off by 2^-12 of |F|, some 1e-3, and fails them.
"""

import numpy as np
import pytest
import torch

import pymc_bart_tpu_torch as pmb
from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
from pymc_bart_tpu_torch.ops import bign
from pymc_bart_tpu_torch.ops.predict import forest_predict
from pymc_bart_tpu_torch.ops.trees import Forest
from pymc_bart_tpu_torch.sampler import pgbart
from torch_reference import bart_bernoulli as ref

LEAF_TOL = dict(rtol=1e-6, atol=1e-7)
SUM_TOL = dict(rtol=0.0, atol=1e-5)
TINY = dict(n=300, p=4, m=4, P=5, D=4, C=2, batch=0.5)
CELL = dict(n=50_000, p=10, m=50, P=10, D=6, C=4, batch=0.1)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def logit1(n, p, seed):
    """The benchmark's data: X uniform, logit 4 sin(pi x0 x1) + 4 x3 - 2."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    f = 4 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 4 * X[:, 3] - 2
    y = rng.binomial(1, 1 / (1 + np.exp(-f))).astype(np.float32)
    return X, y


def random_tree(rng, X, D):
    """A random tree of depth at most ``D`` with its row counts: nodes split
    with probability 0.6 at ``X`` of a random row of theirs."""
    n, p = X.shape
    S = 2 ** (D + 1) - 1
    sv = np.full(S, -1, np.int32)
    sl = np.zeros(S, np.float32)
    ct = np.zeros(S, np.float32)
    node = np.zeros(n, np.int64)
    ct[0] = n
    for s in range(2**D - 1):
        at = node == s
        if at.sum() < 2 or rng.uniform() > 0.6:
            continue
        var = int(rng.integers(p))
        val = X[rng.choice(np.flatnonzero(at)), var]
        left = at & (X[:, var] <= val)
        if left.sum() in (0, at.sum()):
            continue
        sv[s], sl[s] = var, val
        node[left], node[at & ~left] = 2 * s + 1, 2 * s + 2
        ct[2 * s + 1], ct[2 * s + 2] = left.sum(), (at & ~left).sum()
    return sv, sl, ct


def make_case(n, p, m, P, D, C, batch, seed=0, device="cpu"):
    """``(X, y, state, cfg, pg)``: the data, random forests whose leaves
    predict on the scale of the logit, their per-tree predictions and sum,
    random split weights and leaf scales, each chain at its own batch
    offset."""
    rng = np.random.default_rng(seed)
    X, y = logit1(n, p, seed + 1)
    S = 2 ** (D + 1) - 1
    trees = [[random_tree(rng, X, D) for _ in range(m)] for _ in range(C)]
    sv = np.array([[t[0] for t in ts] for ts in trees])
    sl = np.array([[t[1] for t in ts] for ts in trees])
    ct = np.array([[t[2] for t in ts] for ts in trees])
    lf = (rng.normal(size=(C, m, S)) * 2.0 / np.sqrt(m)).astype(np.float32)
    dev = torch.device(device)

    def t(a):
        return torch.as_tensor(a, device=dev)

    Xt = t(X)
    tree_pred = torch.stack([
        t(lf[c]).gather(1, ref.leaf_slots(t(sv[c]), t(sl[c]), Xt))
        for c in range(C)])                                   # (C, m, n)
    forest = Forest(split_var=t(sv), split_val=t(sl),
                    split_set=torch.zeros((C, m, S), dtype=torch.int32,
                                          device=dev),
                    leaf=t(lf)[..., None], count=t(ct),
                    slope=torch.zeros((C, m, S, 1), device=dev))
    state = pgbart.PgbartState(
        forest=forest, tree_pred=tree_pred[..., None].contiguous(),
        sum_trees=tree_pred.sum(dim=1)[..., None].contiguous(),
        alpha_vec=t(rng.uniform(0.5, 3.0, (C, p)).astype(np.float32)),
        leaf_sd=t(rng.uniform(0.05, 0.3, (C, 1)).astype(np.float32)),
        wf_count=torch.zeros((C,), device=dev),
        wf_mean=torch.zeros((C, n, 1), device=dev),
        wf_m2=torch.zeros((C, n, 1), device=dev),
        batch_offset=t(rng.integers(0, m, C).astype(np.int32)),
        iteration=torch.full((C,), 10 * m, dtype=torch.int32, device=dev))
    cfg = BartConfig(m=m, max_depth=D)
    pg = PgbartConfig(num_particles=P, batch=(batch, batch),
                      num_refinements=0)
    return Xt, t(y), state, cfg, pg


def step_rands(gen, state, cfg, pg, n):
    C = state.sum_trees.shape[0]
    return pgbart.draw_rands(
        gen, B=pg.batch_size(cfg.m, False), C=C, P=pg.num_particles,
        D=cfg.max_depth, n=n, k=1, S=cfg.n_nodes, num_refinements=0,
        device=state.sum_trees.device)


def reference_step(forest, F, X, y, state, rands, cfg, pg):
    """The reference's updates of one step, tree by tree and chain by
    chain, on ``forest`` (a list a chain of ``ref.Tree`` lists) and ``F``
    (a list a chain of (n,)), in place; the split weights, the leaf scales
    and the batch offsets are read from the port's ``state`` before its
    step (a draw step adapts none of them)."""
    C = len(forest)
    for c in range(C):
        off = int(state.batch_offset[c])
        for b in range(pg.batch_size(cfg.m, False)):
            j = (off + b) % cfg.m
            forest[c][j], F[c] = ref.update_tree(
                forest[c][j], F[c], X, y, state.alpha_vec[c],
                state.leaf_sd[c, 0], rands, b, c, m=cfg.m, alpha=cfg.alpha,
                beta=cfg.beta)


def reference_forest(state):
    f = state.forest
    C, m, _S = f.split_var.shape
    forest = [[ref.Tree(f.split_var[c, j].clone(), f.split_val[c, j].clone(),
                        f.leaf[c, j, :, 0].clone(), f.count[c, j].clone())
               for j in range(m)] for c in range(C)]
    return forest, [state.sum_trees[c, :, 0].clone() for c in range(C)]


def assert_same(state, vi, forest, F, p, tag):
    """The port's state and inclusion counts against the reference's, by
    the rules of the module docstring."""
    f = state.forest
    for c, trees in enumerate(forest):
        for name in ("split_var", "split_val", "count"):
            want = torch.stack([getattr(t, name) for t in trees])
            assert torch.equal(getattr(f, name)[c], want), (tag, c, name)
        want_vi = torch.stack([t.split_var for t in trees]).flatten()
        want_vi = torch.bincount(want_vi[want_vi >= 0].long(), minlength=p)
        assert torch.equal(vi[c], want_vi.to(vi.dtype)), (tag, c)
        torch.testing.assert_close(
            f.leaf[c, :, :, 0], torch.stack([t.leaf for t in trees]),
            **LEAF_TOL, msg=lambda s: f"{tag} chain {c} leaf: {s}")
        torch.testing.assert_close(
            state.sum_trees[c, :, 0], F[c], **SUM_TOL,
            msg=lambda s: f"{tag} chain {c} sum of trees: {s}")


def run_against_reference(shape, steps, seed, device, impl):
    X, y, state, cfg, pg = make_case(**shape, seed=seed, device=device)
    forest, F = reference_forest(state)
    gen = torch.Generator(device=device).manual_seed(seed)
    grown = 0
    for i in range(steps):
        rands = step_rands(gen, state, cfg, pg, X.shape[0])
        reference_step(forest, F, X, y, state, rands, cfg, pg)
        state, vi = bign.pgbart_step_bign(state, rands, X, y[:, None], cfg,
                                          pg, None, False, lik="bernoulli",
                                          impl=impl)
        assert_same(state, vi, forest, F, X.shape[1], f"step {i}")
        grown += int((state.forest.split_var >= 0).sum())
    assert grown > 0
    # a float16 prediction row would not pass
    half = state.sum_trees[0, :, 0].half().float()
    assert not torch.allclose(half, F[0], **SUM_TOL)
    return X, y, state, cfg


@pytest.mark.parametrize("seed", [3, 11])
def test_plain_large_n_step_equals_the_reference(seed):
    run_against_reference(TINY, 3, seed, "cpu", "plain")


def test_descent_and_loglik_match_the_ports_prediction():
    X, y, state, cfg = run_against_reference(TINY, 1, 5, "cpu", "plain")
    f = state.forest
    rules = torch.zeros(X.shape[1], dtype=torch.int32)
    port = forest_predict(f, X, rules, cfg.max_depth)[..., 0]     # (C, n)
    for c in range(f.split_var.shape[0]):
        sv, sl, lf = f.split_var[c], f.split_val[c], f.leaf[c, :, :, 0]
        slots = ref.leaf_slots(sv, sl, X)
        # each tree's prediction is its leaf values, bit for bit
        assert torch.equal(lf.gather(1, slots), state.tree_pred[c, :, :, 0])
        F = ref.forest_predict(sv, sl, lf, X)
        torch.testing.assert_close(F, port[c], **SUM_TOL)
        torch.testing.assert_close(F, state.sum_trees[c, :, 0], **SUM_TOL)
        ll_of = pgbart.make_ll_of("bernoulli", 0.0, None, y[None, :, None])
        want = ll_of(torch.zeros_like(F)[None, :, None], F[None, :, None])
        assert torch.equal(ref.bernoulli_loglik(F, y), want[0])


class _Routed(Exception):
    pass


def test_sample_takes_the_large_n_route_for_the_classifier(monkeypatch):
    """At the benchmark's size, with ``sample()``'s defaults (no route
    forced), the classifier's PGBART step is the large-n step in its
    row-log-likelihood mode."""
    taken = []
    real = pgbart.resolve_route

    def spy(route, cfg, pg, X, gauss_w, lik, **kw):
        taken.append((route, lik, real(route, cfg, pg, X, gauss_w, lik,
                                       **kw)[0]))
        raise _Routed()

    monkeypatch.setattr(pgbart, "resolve_route", spy)
    X, y = logit1(CELL["n"], CELL["p"], 0)
    with pmb.Model():
        lo = pmb.BART("lo", X, y, m=CELL["m"])
        pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=y)
        with pytest.raises(_Routed):
            pmb.sample(tune=1, draws=1, chains=CELL["C"], num_refinements=0,
                       device="cpu", random_seed=1)
    assert taken == [(None, "bernoulli", "bign")]


def _tiny_fit(kind, device="cpu", n=300, m=5, tune=4, draws=6, **kw):
    X, y = logit1(n, 4, 2)
    timings = {}
    with pmb.Model():
        f = pmb.BART("f", X, y, m=m, max_depth=4)
        if kind == "bernoulli":
            pmb.Bernoulli("y", p=pmb.math.sigmoid(f), observed=y)
        else:
            pmb.Normal("y", f, pmb.HalfNormal("sigma", 1.0), observed=y)
        pmb.sample(tune=tune, draws=draws, chains=2, num_particles=5,
                   num_refinements=0, pgbart_route="bign", device=device,
                   random_seed=3, timings=timings, convergence_checks=False,
                   **kw)
    return timings


@pytest.mark.parametrize("kind", ["bernoulli", "gauss"])
def test_bign_step_span_and_mode_counters(kind):
    """A step of either mode (the prediction rows of ``bernoulli``, the
    node statistics of ``gauss``) is one ``bign_step`` span under
    ``pgbart_step``; on the CPU its launch counter reads no kernel."""
    t = _tiny_fit(kind)
    for phase, steps in (("tune", 4), ("draw", 6)):
        path = f"{phase}/pgbart_step/bign_step"
        assert t["spans"][path][1] == steps
        assert t["counters"][f"{path}/bign_launches"] == 0
        assert [k for k in t["counters"] if k.startswith(path)] == [
            f"{path}/bign_launches"]


@pytest.mark.card
def test_bign_launches_on_the_card(card):
    """On the card the counter holds the kernels the launcher reports it
    enqueued, and they are as many as ``launches_per_step`` designs."""
    n, m, D = 20_000, 20, 4
    t = _tiny_fit("bernoulli", device="cuda", n=n, m=m, tune=3, draws=5)
    pg = PgbartConfig()
    for phase, steps, tuning in (("tune", 3, True), ("draw", 5, False)):
        path = f"{phase}/pgbart_step/bign_step/bign_launches"
        assert t["counters"][path] == steps * bign.launches_per_step(
            pg.batch_size(m, tuning), D)


@pytest.mark.card
def test_kernel_equals_the_reference_at_the_cells_widths(card):
    run_against_reference(CELL, 2, 7, "cuda", "kernel")

