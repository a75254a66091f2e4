"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases device,build,kernels,step,sample,timing]
                          [--ptxas] [--tune N] [--draws N]

Drives ``pymc_bart_tpu_torch`` on the card and exits non-zero if any phase
fails (no exception is caught and carried past).  Each phase prints one JSON
line:

1. ``device``  torch.cuda present (else the script fails); card name and
   power limit from ``nvidia-smi``.
2. ``build``   compile the CUDA sources under ``pymc_bart_tpu_torch/csrc``
   (one nvcc per source, all started together) and load them.
3. ``kernels`` each kernel against its plain PyTorch version on the card, on
   the same inputs, at the main-path shapes (C=4, P=20, n=1000, p=10, S=127,
   every level d for the growth round) and one small mixed growth case (NaNs,
   one-hot and subset columns, linear response, k=2).  The whole-step kernel
   ``pgbart_step_fused`` runs two consecutive steps from a grown state
   against its plain version, same random blocks: at the main shapes (m=50)
   for gauss with tuning on and off, bernoulli, het_abs, het_exp and
   cat_logit, at p=1000 (n=200) and on a small mixed case (NaNs, one-hot and
   subset columns).  Integer outputs must be equal; floats within rtol 1e-4
   / atol 1e-5 (split values rtol 1e-5 / atol 1e-6; sums of trees rtol 1e-4
   / atol 1e-4): the sums are taken in another order.
4. ``step``    one tuning and one draw step of ``pgbart_step`` for 4 chains on
   the fused route, on the per-round kernel route and on ``impl="plain"``,
   same random blocks; a non-Gaussian code must refuse the per-round route
   on the card (its selection kernel is Gaussian).
5. ``sample``  through ``sample()`` on the card at full width (4 chains, 20
   particles, m=50, max_depth=6, n=1000, p=10): the Friedman model on the
   fused route (finite draws, the variable-inclusion recount invariant over
   the stored forests, RMSE against the true f below 1.5), the logistic
   classifier ``y ~ Bernoulli(sigmoid(BART))`` on the fused route at four
   times the steps (finite draws, train accuracy above the majority-class
   rate, mean log-likelihood above the constant-rate model's), and a shorter
   Friedman run on the per-round route.  Kernel launch counts are set to 0 just before each run
   and read just after: a fused run launches the whole-step kernel once a
   step and none of the per-round kernels, a per-round run the reverse.
6. ``timing``  CUDA-event times of each kernel and its plain version at the
   main-path shapes: ``ms``/``plain_ms`` with the card's queue kept full
   (device time only), ``call_ms``/``plain_call_ms`` issued to an idle card
   (the host's cost of a call included); the time of one whole step on both
   routes; the least time the card could take (bytes over 3.35 TB/s,
   operations over 67 TFLOP/s fp32).

``--phases ...,profile`` adds a ``torch.profiler`` pass over a short
``sample()`` run on the fused route: device busy share and the device time by
kernel name.

Then the ``{"kernels": [...]}`` line, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

ALL_PHASES = ("device", "build", "kernels", "step", "sample", "timing")
EXTRA_PHASES = ("profile",)    # only when asked for with --phases
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
C, P, N, PCOLS, M, DEPTH, R = 4, 20, 1000, 10, 50, 6, 5
RMSE_BOUND = 1.5
REPLACES = {
    "grow_round": "pymc_bart_tpu/ops/grow_pallas.py:564",
    "smc_resample": "pymc_bart_tpu/ops/smc_pallas.py:82",
    "select_refine": "pymc_bart_tpu/ops/select_pallas.py:138",
    "pgbart_step_fused": "pymc_bart_tpu/ops/draw_pallas.py:992",
}
SOURCES = {
    "grow_round": "pymc_bart_tpu_torch/csrc/grow.cu",
    "smc_resample": "pymc_bart_tpu_torch/csrc/smc.cu",
    "select_refine": "pymc_bart_tpu_torch/csrc/select.cu",
    "pgbart_step_fused": "pymc_bart_tpu_torch/csrc/draw.cu",
}
ROUND_KERNELS = ("grow_round", "smc_resample", "select_refine")


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def friedman(n, p, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    f = (10 * np.sin(np.pi * X[:, 0] * X[:, 1])
         + 20 * (X[:, 2] - 0.5) ** 2 + 10 * X[:, 3] + 5 * X[:, 4])
    Y = (f + rng.normal(0, 1.0, n)).astype(np.float32)
    return X, Y, f


def logistic(n, p, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    logit = 4 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 4 * X[:, 3] - 2
    Y = rng.binomial(1, 1 / (1 + np.exp(-logit))).astype(np.float32)
    return X, Y


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def nbytes(*tensors):
    """Bytes of the tensors among the arguments (an absent ``u_mix`` is None)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def cuda_ms(fn, iters=20, warmup=3):
    """``(device_ms, call_ms)`` of one call of ``fn``.

    ``call_ms``: CUDA events around ``iters`` calls issued to an idle card,
    so it includes whatever the host needs to issue one call.  ``device_ms``:
    the same, but the calls are queued behind a spinning kernel that outlasts
    the host's issuing, so the card runs them back to back and the events
    see device time only.  Each is the median of three runs.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run(block_s):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if block_s:
            torch.cuda._sleep(int(block_s * 2.0e9))  # cycles at <= 2 GHz
        a.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        issue_s = time.perf_counter() - t0
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters, issue_s

    calls = [run(0.0) for _ in range(3)]
    issue_s = max(c[1] for c in calls)
    device = [run(1.5 * issue_s + 2e-3)[0] for _ in range(3)]
    return float(np.median(device)), float(np.median([c[0] for c in calls]))


def max_err(a, b):
    if a.dtype.is_floating_point:
        both_nan = torch.isnan(a) & torch.isnan(b)
        d = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
        return float(d.max()) if d.numel() else 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_close(name, got, want, rtol, atol):
    """Integer tensors equal, float tensors close (NaNs in the same places);
    returns the max abs error."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    if not got.dtype.is_floating_point:
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{name}: {bad} integer entries differ")
        return 0.0
    if not torch.allclose(got, want, rtol=rtol, atol=atol, equal_nan=True):
        raise AssertionError(f"{name}: max abs err {max_err(got, want)} "
                             f"outside rtol={rtol} atol={atol}")
    return max_err(got, want)


GROW_NAMES = ("sv", "sl", "st", "lf", "ct", "sp", "leaf_idx", "pred", "ll")


def compare_grow(tag, got, want):
    worst = 0.0
    for name, g, w in zip(GROW_NAMES, got, want):
        tol = (1e-5, 1e-6) if name == "sl" else (1e-4, 1e-5)
        worst = max(worst, check_close(f"grow_round {tag} {name}", g, w, *tol))
    return worst


# ---------------------------------------------------------------------------
# inputs at the main-path shapes: a real SMC trajectory of one tree update
# ---------------------------------------------------------------------------


def main_path_inputs(dev, seed=0):
    """Run one tree's SMC with the PLAIN versions on the card and record the
    arguments of every grow / smc / select call (level by level)."""
    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
    from pymc_bart_tpu_torch.ops.grow import grow_round_plain
    from pymc_bart_tpu_torch.ops.select import select_refine_plain
    from pymc_bart_tpu_torch.ops.smc import smc_resample_plain
    from pymc_bart_tpu_torch.sampler import pgbart

    cfg = BartConfig(m=M, max_depth=DEPTH)
    pg = PgbartConfig(num_particles=P, num_refinements=R)
    S = cfg.n_nodes
    X_np, Y_np, _ = friedman(N, PCOLS)
    X = torch.from_numpy(X_np).to(dev)
    Y = torch.from_numpy(Y_np).to(dev)[:, None]
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = pgbart.init_state(X, Y, cfg, chains=C, device=dev)
    rules = torch.zeros(PCOLS, dtype=torch.int32, device=dev)
    gauss_w = torch.ones((C, N, 1), device=dev)
    # a few plain steps so the frozen particle is a grown tree
    for _ in range(12):
        rands = pgbart.draw_rands(gen, B=5, C=C, P=P, D=DEPTH, n=N, k=1, S=S,
                                  num_refinements=R, device=dev)
        state, _ = pgbart.pgbart_step(state, rands, X, Y, rules, cfg, pg,
                                      True, gauss_w, impl="plain")
    rands = pgbart.draw_rands(gen, B=1, C=C, P=P, D=DEPTH, n=N, k=1, S=S,
                              num_refinements=R, device=dev)
    calls = {"grow": [], "smc": [], "select": []}

    def rec_grow(*a, impl=None, **kw):
        calls["grow"].append((a, kw))
        return grow_round_plain(*a, **kw)

    def rec_smc(*a, impl=None):
        calls["smc"].append(a)
        return smc_resample_plain(*a)

    def rec_select(*a, impl=None, **kw):
        calls["select"].append((a, kw))
        return select_refine_plain(*a, **kw)

    saved = (pgbart.grow_round, pgbart.smc_resample, pgbart.select_refine)
    pgbart.grow_round, pgbart.smc_resample, pgbart.select_refine = (
        rec_grow, rec_smc, rec_select)
    try:
        jt = state.batch_offset.to(torch.int64)
        ar = torch.arange(C, device=dev)
        f = state.forest
        tree = type(f)(f.split_var[ar, jt], f.split_val[ar, jt],
                       f.split_set[ar, jt], f.leaf[ar, jt], f.count[ar, jt],
                       f.slope[ar, jt])
        resid = Y - (state.sum_trees - state.tree_pred[ar, jt])
        pgbart._update_one_tree(0, rands, tree, resid, state.alpha_vec,
                                state.leaf_sd, X, rules, cfg, pg, gauss_w,
                                None)
    finally:
        pgbart.grow_round, pgbart.smc_resample, pgbart.select_refine = saved
    if len(calls["grow"]) != DEPTH or len(calls["smc"]) != DEPTH - 1:
        raise AssertionError("one tree update did not make D growth rounds "
                             "and D-1 resampling steps")
    return calls, cfg


def mixed_grow_case(dev, seed=3):
    """Small growth round with NaNs, one-hot and subset columns, the linear
    response, two outputs and a non-identity ``take``."""
    from pymc_bart_tpu_torch.config import BartConfig

    rng = np.random.default_rng(seed)
    Cc, Pp, n, p, k, d = 2, 6, 200, 4, 2, 1
    cfg = BartConfig(m=5, max_depth=4, n_outputs=k, response="linear")
    S, G = cfg.n_nodes, 2**d
    rules = np.array([0, 1, 2, 2], np.int32)
    X = rng.normal(size=(n, p)).astype(np.float32)
    X[:, 1:] = rng.integers(0, 5, size=(n, 3)).astype(np.float32)
    X[rng.random(size=(n, p)) < 0.1] = np.nan
    sv = np.full((Cc, Pp, S), -1, np.int32)
    sl = np.zeros((Cc, Pp, S), np.float32)
    ct = np.zeros((Cc, Pp, S), np.float32)
    li = np.zeros((Cc, Pp, n), np.int32)
    med = float(np.nanmedian(X[:, 0]))
    left = np.nan_to_num(X[:, 0], nan=np.inf) <= med
    sv[:, :, 0], sl[:, :, 0] = 0, med
    li[:, :] = np.where(left, 1, 2)
    ct[:, :, 0], ct[:, :, 1], ct[:, :, 2] = n, left.sum(), (~left).sum()
    # the frozen particle replays a stored subset split on a missing value
    sv[:, 0, 1], sl[:, 0, 1] = 3, np.nan
    sv[:, 0, 2], sl[:, 0, 2] = 1, 2.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    f32 = np.float32
    frozen = np.zeros((Cc, Pp), np.int32)
    frozen[:, 0] = 1
    lf = rng.normal(size=(Cc, Pp, k, S)).astype(f32)
    sp = (0.1 * rng.normal(size=(Cc, Pp, k, S))).astype(f32)
    pred = rng.normal(size=(Cc, Pp, k, n)).astype(f32)
    args = (
        t(np.array([[0, 2, 2, 1, 5, 4]] * Cc, np.int32)), t(frozen), t(sv),
        t(sl), t(rng.integers(-2**31, 2**31, size=(Cc, Pp, S)).astype(np.int32)),
        t(lf), t(ct), t(sp), t(li), t(pred), t(X),
        t(rng.normal(size=(Cc, k, n)).astype(f32)), t(rules),
        t(np.cumsum(rng.uniform(0.5, 2, size=(Cc, p)), axis=1).astype(f32)),
        t(np.full((Cc, k), 0.3, f32)),
        t(rng.uniform(0.5, 2, size=(Cc, k, n)).astype(f32)),
        t((rng.random((Cc, Pp, G)) * 0.3).astype(f32)),
        t(rng.random((Cc, Pp, G)).astype(f32)),
        t(rng.gumbel(size=(Cc, Pp, n)).astype(f32)),
        t(rng.normal(size=(Cc, Pp, k, 2 * G)).astype(f32)),
        t(rng.integers(-2**31, 2**31, size=(Cc, Pp, G)).astype(np.int32)),
        t(rng.random((Cc, Pp, 2 * G)).astype(f32)))
    return args, dict(d=d, cfg=cfg)


STATE_TOL = {  # field: (rtol, atol); None = exactly equal
    "split_var": None, "split_set": None, "count": None, "iteration": None,
    "batch_offset": None, "split_val": (1e-5, 1e-6), "leaf": (1e-4, 1e-5),
    "slope": (1e-4, 1e-5), "sum_trees": (1e-4, 1e-4),
    "tree_pred": (1e-4, 1e-4), "alpha_vec": (1e-6, 1e-6),
    "leaf_sd": (1e-5, 1e-6), "wf_count": (0.0, 0.0), "wf_mean": (1e-4, 1e-5),
    "wf_m2": (1e-3, 1e-5),
}


def compare_state(tag, got, want):
    """Every field of two ``PgbartState``s: integers and counts equal, floats
    within ``STATE_TOL``; returns the max abs error of the float fields."""
    worst = 0.0
    for name, tol in STATE_TOL.items():
        holder = (got, want) if hasattr(got, name) else (got.forest,
                                                         want.forest)
        ta, tb = (getattr(h, name) for h in holder)
        if tol is None:
            check_close(f"{tag} {name}", ta, tb, 0.0, 0.0)
        else:
            worst = max(worst, check_close(f"{tag} {name}", ta, tb, *tol))
    return worst


FUSED_CASES = ("gauss_tune", "gauss_draw", "bernoulli", "het_abs", "het_exp",
               "cat_logit", "gauss_p1000", "gauss_mixed")


def fused_case(dev, name, seed=0):
    """Inputs of one whole-step case: ``dict(cfg, pg, X, Y, rules, row, lik,
    lik_const, chains, tunings)`` with every tensor on the card.  ``row`` is
    the (C, n, 1) row data of the code, or None; ``tunings`` the tuning flag
    of the two compared steps."""
    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig

    rng = np.random.default_rng(100 + seed)
    cfg = BartConfig(m=M, max_depth=DEPTH)
    pg = PgbartConfig(num_particles=P, num_refinements=R)
    chains, lik, lik_const, rules = C, name, 0.0, None
    tunings = (True, False)
    X, Y, _ = friedman(N, PCOLS)
    chain_shift = np.arange(chains, dtype=np.float32)[:, None, None]
    if name.startswith("gauss"):
        lik = "gauss"
        tunings = (False, False) if name == "gauss_draw" else (True, True)
        if name == "gauss_p1000":           # the width of the p=1000 config
            X = rng.uniform(size=(200, 1000)).astype(np.float32)
            Y = (5 * X[:, 0] + 3 * X[:, 1] - 4 * X[:, 2]
                 + rng.normal(0, 0.5, 200)).astype(np.float32)
        elif name == "gauss_mixed":         # NaNs, one-hot and subset columns
            chains = 2
            cfg = BartConfig(m=5, max_depth=4)
            pg = PgbartConfig(num_particles=6, num_refinements=R,
                              batch=(0.4, 0.4))
            X = rng.normal(size=(200, 4)).astype(np.float32)
            X[:, 1:] = rng.integers(0, 5, size=(200, 3)).astype(np.float32)
            Y = (np.sin(2 * X[:, 0]) + 0.5 * (X[:, 1] == 2) + 0.3 * X[:, 3]
                 + rng.normal(0, 0.2, 200)).astype(np.float32)
            X[rng.random(size=X.shape) < 0.1] = np.nan
            rules = np.array([0, 1, 2, 2], np.int32)
            chain_shift = chain_shift[:chains]
        row = np.broadcast_to(1.0 + 0.2 * chain_shift,
                              (chains, X.shape[0], 1))
    elif name == "bernoulli":
        X, Y = logistic(N, PCOLS)
        row = None
    elif name in ("het_abs", "het_exp"):
        # the scale forest of a heteroscedastic model: row data (y - mu0)^2
        # and the link-aware growth target of the scale
        lik_const = 0.05 if name == "het_abs" else 0.0
        mu0 = Y.mean() + 0.1 * chain_shift
        row = (Y[None, :, None] - mu0) ** 2
        s_hat = np.abs(Y - Y.mean()) / 0.7978845608
        Y = (s_hat - lik_const if name == "het_abs"
             else np.log(np.maximum(s_hat, 1e-3))).astype(np.float32)
    elif name == "cat_logit":
        # one class forest of a 3-class softmax: target +-2, row data the
        # logsumexp of the other two classes' outputs
        labels = (3 * X[:, 0]).astype(np.int64) % 3
        Y = (4.0 * (labels == 0) - 2.0).astype(np.float32)
        others = rng.normal(0.0, 0.5, size=(chains, N, 2))
        row = np.log(np.exp(others).sum(axis=2, keepdims=True))
    else:
        raise ValueError(name)
    if rules is None:
        rules = np.zeros(X.shape[1], np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return dict(cfg=cfg, pg=pg, X=t(X), Y=t(Y.astype(np.float32))[:, None],
                rules=t(rules), lik=lik, lik_const=lik_const, chains=chains,
                row=None if row is None else t(row.astype(np.float32)),
                tunings=tunings)


def fused_step(case, state, rands, tuning, impl=None):
    from pymc_bart_tpu_torch.ops.draw import pgbart_step_fused

    return pgbart_step_fused(
        state, rands, case["X"], case["Y"], case["rules"], case["cfg"],
        case["pg"], case["row"], tuning, lik=case["lik"],
        lik_const=case["lik_const"], impl=impl)


def fused_rands(case, gen, tuning, dev):
    from pymc_bart_tpu_torch.sampler import pgbart

    cfg, pg = case["cfg"], case["pg"]
    return pgbart.draw_rands(
        gen, B=pg.batch_size(cfg.m, tuning), C=case["chains"],
        P=pg.num_particles, D=cfg.max_depth, n=case["X"].shape[0], k=1,
        S=cfg.n_nodes, num_refinements=pg.num_refinements, device=dev)


def grown_state(case, gen, dev, steps=11):
    """A state in which every tree has been updated at least once and the
    ``leaf_sd`` adaptation has begun: ``steps`` tuning steps of the kernel."""
    from pymc_bart_tpu_torch.ops.draw import check_status
    from pymc_bart_tpu_torch.sampler import pgbart

    state = pgbart.init_state(case["X"], case["Y"], case["cfg"],
                              chains=case["chains"], device=dev)
    for _ in range(steps):
        state, _ = fused_step(case, state, fused_rands(case, gen, True, dev),
                              True)
    torch.cuda.synchronize()
    check_status()
    if not bool(torch.isfinite(state.sum_trees).all()):
        raise AssertionError("warm-up steps left a non-finite sum of trees")
    return state


def compare_fused(dev, name, seed=17):
    """Two consecutive steps of the whole-step kernel against its plain
    version from one grown state; returns (max abs err, split nodes)."""
    from pymc_bart_tpu_torch.ops.draw import check_status

    case = fused_case(dev, name)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_kernel = grown_state(case, gen, dev)
    s_plain = s_kernel.clone()
    worst = 0.0
    for i, tuning in enumerate(case["tunings"]):
        rands = fused_rands(case, gen, tuning, dev)
        s_kernel, vi_k = fused_step(case, s_kernel, rands, tuning, "kernel")
        torch.cuda.synchronize()
        check_status()
        s_plain, vi_p = fused_step(case, s_plain, rands, tuning, "plain")
        torch.cuda.synchronize()
        tag = f"pgbart_step_fused {name} step {i}"
        check_close(f"{tag} vi", vi_k, vi_p, 0.0, 0.0)
        worst = max(worst, compare_state(tag, s_kernel, s_plain))
    sv = s_kernel.forest.split_var
    splits = int((sv >= 0).sum())
    if splits == 0:
        raise AssertionError(f"{name}: the forest has no split at all")
    if name == "gauss_mixed" and not bool((sv >= 1).any()):
        raise AssertionError("mixed case: no categorical column was split on")
    return worst, splits


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernels(dev, calls, cfg):
    from pymc_bart_tpu_torch.ops.grow import grow_round
    from pymc_bart_tpu_torch.ops.select import select_refine
    from pymc_bart_tpu_torch.ops.smc import smc_resample

    errs = {"grow_round": 0.0, "smc_resample": 0.0, "select_refine": 0.0}
    grown = 0
    for a, kw in calls["grow"]:
        got = grow_round(*a, impl="kernel", **kw)
        torch.cuda.synchronize()
        want = grow_round(*a, impl="plain", **kw)
        torch.cuda.synchronize()
        errs["grow_round"] = max(errs["grow_round"],
                                 compare_grow(f"d={kw['d']}", got, want))
        grown += int(((got[0] >= 0) & (a[2] < 0)).sum())
    if grown == 0:
        raise AssertionError("no particle grew at the main-path shapes")
    a, kw = mixed_grow_case(dev)
    got = grow_round(*a, impl="kernel", **kw)
    torch.cuda.synchronize()
    want = grow_round(*a, impl="plain", **kw)
    torch.cuda.synchronize()
    mixed_err = compare_grow("mixed", got, want)
    if not bool(((got[0] >= 1) & (a[2] < 0)).any()):
        raise AssertionError("mixed case: no categorical split was drawn")

    resampled = 0
    for a in calls["smc"]:
        got = smc_resample(*a, impl="kernel")
        torch.cuda.synchronize()
        want = smc_resample(*a, impl="plain")
        for name, g, w in zip(("log_w", "take", "ll_prev"), got, want):
            errs["smc_resample"] = max(
                errs["smc_resample"],
                check_close(f"smc_resample {name}", g, w, 1e-4, 1e-5))
        ident = torch.arange(P, device=dev, dtype=torch.int32)
        resampled += int((got[1] != ident).any())
    a, kw = calls["select"][0]
    got = select_refine(*a, impl="kernel", **kw)
    torch.cuda.synchronize()
    want = select_refine(*a, impl="plain", **kw)
    for name, g, w in zip(("sv", "sl", "st", "lf", "ct", "leaf_idx", "pred"),
                          got, want):
        tol = (1e-5, 1e-6) if name == "sl" else (1e-4, 1e-5)
        errs["select_refine"] = max(
            errs["select_refine"],
            check_close(f"select_refine {name}", g, w, *tol))
    fused = {}
    for name in FUSED_CASES:
        err, splits = compare_fused(dev, name)
        fused[name] = dict(max_abs_err=err, split_nodes=splits)
    errs["pgbart_step_fused"] = max(v["max_abs_err"] for v in fused.values())
    emit("kernels", max_abs_err=errs, grow_mixed_max_abs_err=mixed_err,
         grown_nodes=grown, smc_calls_that_resampled=resampled,
         pgbart_step_fused_cases=fused,
         tolerance={"integers": "equal", "split_val": "rtol 1e-5 atol 1e-6",
                    "other floats": "rtol 1e-4 atol 1e-5",
                    "state of a whole step": {
                        k: "equal" if v is None else f"rtol {v[0]} atol {v[1]}"
                        for k, v in STATE_TOL.items()}},
         shapes=dict(C=C, P=P, n=N, p=PCOLS, S=cfg.n_nodes, m=M))
    return errs


def phase_step(dev):
    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
    from pymc_bart_tpu_torch.ops.draw import check_status
    from pymc_bart_tpu_torch.sampler import pgbart

    cfg = BartConfig(m=M, max_depth=DEPTH)
    pg = PgbartConfig(num_particles=P, num_refinements=R)
    X_np, Y_np, _ = friedman(N, PCOLS)
    X = torch.from_numpy(X_np).to(dev)
    Y = torch.from_numpy(Y_np).to(dev)[:, None]
    rules = torch.zeros(PCOLS, dtype=torch.int32, device=dev)
    gauss_w = torch.ones((C, N, 1), device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    routes = {"fused": dict(route="fused"), "rounds": dict(route="rounds"),
              "plain": dict(impl="plain")}
    first = pgbart.init_state(X, Y, cfg, chains=C, device=dev)
    states = {k: first.clone() for k in routes}
    worst = {"fused": 0.0, "rounds": 0.0}
    for tuning in (True, False):
        rands = pgbart.draw_rands(
            gen, B=pg.batch_size(M, tuning), C=C, P=P, D=DEPTH, n=N, k=1,
            S=cfg.n_nodes, num_refinements=R, device=dev)
        vis = {}
        for k, kw in routes.items():
            states[k], vis[k] = pgbart.pgbart_step(
                states[k], rands, X, Y, rules, cfg, pg, tuning, gauss_w, **kw)
        torch.cuda.synchronize()
        check_status()
        for k in worst:
            check_close(f"step {k} vi", vis[k], vis["plain"], 0.0, 0.0)
            worst[k] = max(worst[k], compare_state(f"step {k}", states[k],
                                                   states["plain"]))
    splits = int((states["fused"].forest.split_var >= 0).sum())
    if splits == 0:
        raise AssertionError("two steps grew no split at all")
    # the per-round selection kernel is Gaussian: on the card another code
    # must refuse that route, not reach a plain version
    try:
        pgbart.pgbart_step(first.clone(), rands, X, Y, rules, cfg, pg, False,
                           None, lik="bernoulli", route="rounds")
    except NotImplementedError as e:
        refusal = str(e)
    else:
        raise AssertionError("bernoulli ran on the per-round route on the card")
    emit("step", max_abs_err_vs_plain=worst, split_nodes=splits, chains=C,
         rounds_route_refuses_bernoulli=refusal)


def sample_run(model, route, tune, draws):
    """One ``sample()`` run on the card with every launch count set to 0
    just before and read just after; checks the counts of the route."""
    import pymc_bart_tpu_torch as pmb
    from pymc_bart_tpu_torch.ops.draw import pgbart_step_fused
    from pymc_bart_tpu_torch.ops.grow import grow_round
    from pymc_bart_tpu_torch.ops.select import select_refine
    from pymc_bart_tpu_torch.ops.smc import smc_resample

    wrappers = {"grow_round": grow_round, "smc_resample": smc_resample,
                "select_refine": select_refine,
                "pgbart_step_fused": pgbart_step_fused}
    timings = {}
    with pmb.Model():
        rv = model(pmb)
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        idata = pmb.sample(tune=tune, draws=draws, chains=C, random_seed=0,
                           num_particles=P, num_refinements=R,
                           chunk_size=max(1, draws // 2), timings=timings,
                           convergence_checks=False, pgbart_route=route)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: int(w.launches) for k, w in wrappers.items()}
    steps = tune + draws
    B = 5
    if route == "rounds":
        want = {"grow_round": steps * B * DEPTH,
                "smc_resample": steps * B * (DEPTH - 1),
                "select_refine": steps * B, "pgbart_step_fused": 0}
    else:
        want = {"grow_round": 0, "smc_resample": 0, "select_refine": 0,
                "pgbart_step_fused": steps}
    for k, v in launches.items():
        if want[k] and v == 0:
            raise AssertionError(f"the {route} route never launched {k}")
        if v != want[k]:
            raise AssertionError(f"{route} route, {k}: {v} launches, "
                                 f"expected {want[k]}")
    post = np.asarray(idata.posterior[rv.name].values)
    if post.shape != (C, draws, N):
        raise AssertionError(f"posterior shape {post.shape}")
    if not np.isfinite(post).all():
        raise AssertionError("non-finite posterior draws")
    vi = np.asarray(idata["sample_stats"]["variable_inclusion"].values)
    sv = rv.all_trees.split_var
    if sv.shape != (C, draws, M, 2 ** (DEPTH + 1) - 1):
        raise AssertionError(f"stored forests have shape {sv.shape}")
    recount = np.stack([(sv == j).sum(axis=(2, 3)) for j in range(PCOLS)],
                       axis=-1)
    if not np.array_equal(vi[:, :, 0, :], recount):
        raise AssertionError("variable_inclusion != recount over the forests")
    for c in range(1, C):
        if np.array_equal(post[0], post[c]):
            raise AssertionError(f"chain {c} repeats chain 0")
    out = dict(route=route, tune=tune, draws=draws, chains=C, seconds=seconds,
               tune_seconds=timings["tune_seconds"],
               draw_seconds_total=timings["draw_seconds_total"],
               chain_draws_per_s=C * draws / timings["draw_seconds_total"],
               vi_top5=np.argsort(vi.sum(axis=(0, 1))[0])[::-1][:5].tolist(),
               launches=launches)
    return idata, post, out


def phase_sample(dev, tune, draws):
    """Friedman and logistic on the fused route, then a shorter Friedman run
    on the per-round route.  Returns the launch counts of every kernel on
    the path that drives it."""
    X, Y, f_true = friedman(N, PCOLS)

    def friedman_model(pmb):
        mu = pmb.BART("mu", X, Y, m=M, max_depth=DEPTH)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)
        return mu

    def friedman_quality(idata, post, out):
        sig = np.asarray(idata.posterior["sigma"].values)
        if sig.shape != post.shape[:2] or not np.isfinite(sig).all():
            raise AssertionError("sigma draws are missing or not finite")
        rmse = float(np.sqrt(np.mean((post.mean(axis=(0, 1)) - f_true) ** 2)))
        if not rmse < RMSE_BOUND:
            raise AssertionError(f"rmse vs true f {rmse} >= {RMSE_BOUND}")
        return dict(out, model="friedman", rmse_vs_true_f=rmse,
                    sigma_mean=float(sig.mean()))

    runs = {}
    runs["friedman_fused"] = friedman_quality(
        *sample_run(friedman_model, "fused", tune, draws))

    Xl, Yl = logistic(N, PCOLS)

    def logistic_model(pmb):
        lo = pmb.BART("lo", Xl, Yl, m=M, max_depth=DEPTH)
        pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=Yl)
        return lo

    # no NUTS step, so a step is cheap: four times the steps of the others
    idata, post, out = sample_run(logistic_model, "fused", 4 * tune, 4 * draws)
    lo_hat = post.mean(axis=(0, 1))
    acc = float(((lo_hat > 0) == (Yl > 0.5)).mean())
    ph = np.clip(1 / (1 + np.exp(-lo_hat)), 1e-6, 1 - 1e-6)
    ll = float(np.mean(Yl * np.log(ph) + (1 - Yl) * np.log(1 - ph)))
    rate = float(Yl.mean())
    majority = max(rate, 1 - rate)
    ll_const = rate * np.log(rate) + (1 - rate) * np.log(1 - rate)
    if not acc > majority:
        raise AssertionError(f"train accuracy {acc} <= majority {majority}")
    if not ll > ll_const:
        raise AssertionError(f"mean log-likelihood {ll} <= {ll_const} of the "
                             "constant-rate model")
    runs["logistic_fused"] = dict(out, model="logistic", train_accuracy=acc,
                                  majority_rate=majority, mean_loglik=ll,
                                  constant_rate_loglik=float(ll_const))

    short = max(2, draws // 4)
    runs["friedman_rounds"] = friedman_quality(
        *sample_run(friedman_model, "rounds", short, 2 * short))
    emit("sample", runs=runs)
    launches = {k: runs["friedman_rounds"]["launches"][k]
                for k in ROUND_KERNELS}
    launches["pgbart_step_fused"] = (
        runs["friedman_fused"]["launches"]["pgbart_step_fused"]
        + runs["logistic_fused"]["launches"]["pgbart_step_fused"])
    return launches, runs


def phase_timing(dev, calls, cfg, smi, runs=None):
    from pymc_bart_tpu_torch.config import PgbartConfig
    from pymc_bart_tpu_torch.ops.grow import grow_round
    from pymc_bart_tpu_torch.ops.select import select_refine
    from pymc_bart_tpu_torch.ops.smc import smc_resample
    from pymc_bart_tpu_torch.sampler import pgbart

    out = {}

    def bound(bytes_, ops):
        tb, to = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    def timed(kernel_fn, plain_fn):
        ms, call_ms = cuda_ms(kernel_fn)
        plain_ms, plain_call_ms = cuda_ms(plain_fn, iters=5, warmup=1)
        return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                    plain_call_ms=plain_call_ms)

    # growth round: every level, then the mean over the D levels of a tree
    rows = []
    for a, kw in calls["grow"]:
        outs = grow_round(*a, impl="kernel", **kw)
        # every argument read once, every output written once
        bts = nbytes(*a) + nbytes(*outs)
        # per row and particle: Gumbel compare, routing compare, child-sum
        # add, and diff, square, weight, add for the log-likelihood
        ops = C * P * N * (3 + 4 * 1)
        b_ms, by = bound(bts, ops)
        rows.append(dict(
            d=kw["d"], bytes=bts, bound_ms=b_ms, bound_by=by,
            **timed(lambda: grow_round(*a, impl="kernel", **kw),
                    lambda: grow_round(*a, impl="plain", **kw))))
    out["grow_round"] = dict(
        {key: float(np.mean([r[key] for r in rows]))
         for key in ("ms", "call_ms", "plain_ms", "plain_call_ms", "bound_ms")},
        bound_by=rows[0]["bound_by"], by_level=rows)

    a = calls["smc"][0]
    outs = smc_resample(*a, impl="kernel")
    b_ms, by = bound(nbytes(*a) + nbytes(*outs), C * P * 12 + C * P * P)
    out["smc_resample"] = dict(
        bound_ms=b_ms, bound_by=by,
        **timed(lambda: smc_resample(*a, impl="kernel"),
                lambda: smc_resample(*a, impl="plain")))

    a, kw = calls["select"][0]
    outs = select_refine(*a, impl="kernel", **kw)
    S = cfg.n_nodes
    # the work this data needs: the winner's rows only (not all P particles),
    # log_w, resid, ll_weight, the noise, and the outputs
    bts = C * (4 * S + 2 * N) * 4 + nbytes(a[7], a[8], a[9], a[10], a[11],
                                           a[12], a[13]) + nbytes(*outs)
    ops = C * ((R + 1) * (4 * N + 4 * S) + N)
    b_ms, by = bound(bts, ops)
    out["select_refine"] = dict(
        bound_ms=b_ms, bound_by=by,
        **timed(lambda: select_refine(*a, impl="kernel", **kw),
                lambda: select_refine(*a, impl="plain", **kw)))

    # the whole-step kernel at the main shapes, from a grown state; every
    # launch advances the state in place, as on the main path
    case = fused_case(dev, "gauss_draw")
    gen = torch.Generator(device=dev).manual_seed(5)
    st_k = grown_state(case, gen, dev)
    st_p = st_k.clone()
    rands = fused_rands(case, gen, False, dev)
    B = case["pg"].batch_size(M, False)
    S = cfg.n_nodes
    # every random block read once; per updated tree the forest rows and
    # tree_pred row read and written; sum_trees read and written; X, y, the
    # row data, alpha_vec and leaf_sd read; the forest's split variables read
    # for the histogram; the histogram written
    bts = (nbytes(*(getattr(rands, f) for f in
                    ("ug", "uv", "rg", "eps", "sb", "ures", "usel", "epsr",
                     "uacc")))
           + 4 * C * B * (2 * 6 * S + 2 * N) + 4 * 2 * C * N
           + nbytes(case["X"], case["Y"], case["row"], st_k.alpha_vec,
                    st_k.leaf_sd) + 4 * C * M * S + 4 * C * PCOLS)
    # per row, particle and level as the growth round; per row and sweep the
    # refinement's gather, difference, square, weight, add
    ops = B * DEPTH * C * P * N * 7 + B * C * (R + 2) * N * 5
    b_ms, by = bound(bts, ops)
    out["pgbart_step_fused"] = dict(
        bound_ms=b_ms, bound_by=by, bytes=bts,
        **timed(lambda: fused_step(case, st_k, rands, False, "kernel"),
                lambda: fused_step(case, st_p, rands, False, "plain")))

    # the same kernel on the logistic data and at the p=1000 width
    for key, name in (("bernoulli_ms", "bernoulli"),
                      ("p1000_n200_ms", "gauss_p1000")):
        other = fused_case(dev, name)
        st_o = grown_state(other, gen, dev)
        rands_o = fused_rands(other, gen, False, dev)
        out["pgbart_step_fused"][key] = cuda_ms(
            lambda: fused_step(other, st_o, rands_o, False, "kernel"))[0]

    # one whole PGBART step (B = 5 trees) on each route, host clock + sync
    pg = PgbartConfig(num_particles=P, num_refinements=R)
    X_np, Y_np, _ = friedman(N, PCOLS)
    X = torch.from_numpy(X_np).to(dev)
    Y = torch.from_numpy(Y_np).to(dev)[:, None]
    rules = torch.zeros(PCOLS, dtype=torch.int32, device=dev)
    gauss_w = torch.ones((C, N, 1), device=dev)
    state = pgbart.init_state(X, Y, cfg, chains=C, device=dev)
    step_ms, rands_ms = {}, []
    for name, kw, reps in (("fused", dict(route="fused"), 12),
                           ("rounds", dict(route="rounds"), 12),
                           ("plain", dict(impl="plain"), 4)):
        times = []
        for i in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rands = pgbart.draw_rands(gen, B=5, C=C, P=P, D=DEPTH, n=N, k=1,
                                      S=cfg.n_nodes, num_refinements=R,
                                      device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, _ = pgbart.pgbart_step(state, rands, X, Y, rules, cfg, pg,
                                          False, gauss_w, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            rands_ms.append((t1 - t0) * 1e3)
        step_ms[name] = float(np.median(times[2:]))
    rates = {k: v["chain_draws_per_s"] for k, v in (runs or {}).items()}
    emit("timing", card=smi, kernels=out, chain_draws_per_s=rates,
         step_ms_fused_route=step_ms["fused"],
         step_ms_kernel_route=step_ms["rounds"],
         step_ms_plain_route=step_ms["plain"],
         draw_rands_ms=float(np.median(rands_ms[2:])),
         launches_per_step={"pgbart_step_fused": 1, "grow_round": 5 * DEPTH,
                            "smc_resample": 5 * (DEPTH - 1),
                            "select_refine": 5})
    return out


def phase_profile(dev, steps=20):
    """Device busy share and device time by kernel over ``steps`` draw steps
    on the fused route (after a warm-up run), for the Friedman model (PGBART
    + NUTS) and the logistic model (PGBART alone)."""
    import pymc_bart_tpu_torch as pmb
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    X, Y, _ = friedman(N, PCOLS)
    Xl, Yl = logistic(N, PCOLS)

    def friedman_model():
        mu = pmb.BART("mu", X, Y, m=M, max_depth=DEPTH)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)

    def logistic_model():
        lo = pmb.BART("lo", Xl, Yl, m=M, max_depth=DEPTH)
        pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=Yl)

    def run(model, tune, draws):
        with pmb.Model():
            model()
            pmb.sample(tune=tune, draws=draws, chains=C, random_seed=1,
                       num_particles=P, num_refinements=R,
                       convergence_checks=False, pgbart_route="fused")
        torch.cuda.synchronize()

    for name, model in (("friedman", friedman_model),
                        ("logistic", logistic_model)):
        run(model, 5, 5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(model, 0, steps)
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            # kernels and copies only: an operator's row repeats its kernels'
            if dev_us > 0 and e.device_type == DeviceType.CUDA:
                rows.append((dev_us / 1e3, e.count, e.key))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows)
        emit("profile", model=name, route="fused", steps=steps,
             wall_ms=wall_ms, device_busy_ms=busy_ms,
             device_idle_share=1.0 - busy_ms / wall_ms,
             device_events=sum(r[1] for r in rows),
             top=[dict(ms=r[0], count=r[1], name=r[2][:80])
                  for r in rows[:12]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    ap.add_argument("--ptxas", action="store_true",
                    help="print registers and shared memory of each kernel")
    ap.add_argument("--tune", type=int, default=150)
    ap.add_argument("--draws", type=int, default=150)
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES) - set(EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 1
    from pymc_bart_tpu_torch.ops import _build

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    logs = _build.build_all(verbose=args.ptxas)
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    emit("build", seconds=time.perf_counter() - t0,
         sources=[f"pymc_bart_tpu_torch/csrc/{n}.cu"
                  for n in _build.KERNEL_SOURCES],
         directory=str(_build.BUILD_DIR.name))
    if args.ptxas:
        for name, log in logs.items():
            print(f"--- nvcc {name}.cu ---\n{log}", file=sys.stderr)

    need_calls = {"kernels", "timing"} & set(phases)
    calls = cfg = None
    if need_calls:
        calls, cfg = main_path_inputs(dev)
    errs = launches = times = runs = None
    if "kernels" in phases:
        errs = phase_kernels(dev, calls, cfg)
    if "step" in phases:
        phase_step(dev)
    if "sample" in phases:
        launches, runs = phase_sample(dev, args.tune, args.draws)
    if "timing" in phases:
        times = phase_timing(dev, calls, cfg, smi, runs)
    if "profile" in phases:
        phase_profile(dev)

    if set(ALL_PHASES) <= set(phases):
        kernels = []
        for name in ROUND_KERNELS + ("pgbart_step_fused",):
            t = times[name]
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
                "call_ms": t["call_ms"],
                "plain_call_ms": t["plain_call_ms"]})
        print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    if set(ALL_PHASES) <= set(phases):
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    else:
        print(json.dumps({"partial": phases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
