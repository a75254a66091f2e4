"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases device,build,kernels,step,sample,timing]
                          [--ptxas] [--tune N] [--draws N]
                          [--large-tune N] [--large-draws N]

Drives ``pymc_bart_tpu_torch`` on the card and exits non-zero if any phase
fails (no exception is caught and carried past).  Each phase prints one JSON
line:

1. ``device``  torch.cuda present (else the script fails); card name and
   power limit from ``nvidia-smi``.
2. ``build``   compile the CUDA sources under ``pymc_bart_tpu_torch/csrc``
   (one nvcc per source, all started together) and load them.
3. ``kernels`` each kernel against its plain PyTorch version on the card, on
   the same inputs, at the main-path shapes (C=4, P=20, n=1000, p=10, S=127;
   the growth round at every level of one tree update for the constant,
   linear and mix responses from three seeds each, every float output's
   error reported) and one small mixed growth case (NaNs, one-hot and subset
   columns, linear response, k=2) with its rows in shared memory (n=200) and
   in global memory (n=120,000).  The whole-step kernel
   ``pgbart_step_fused`` runs two consecutive steps from a grown state
   against its plain version, same random blocks: at the main shapes (m=50)
   for gauss with tuning on and off, bernoulli, het_abs, het_exp and
   cat_logit, at p=1000 (n=200), on a small mixed case (NaNs, one-hot and
   subset columns), with a hundredth of the precision (the ESS gate falls
   both ways), with 19 particles (an idle slot in the cluster), at p=5000
   (the split-weight CDF stays in global memory), at n=16,384 and at depth
   11 (the form that keeps the per-particle state in global memory, because
   the rows or the node arrays do not fit; the phase prints the plan of
   every case and fails if a case runs with another than it names), each
   from three seeds.  Then its generated-Gumbel mode in both forms:
   equal to the plain version on the written-out block, and the same bits
   from two runs.  Integer outputs must be equal; floats within rtol 1e-4
   / atol 1e-5 (split values rtol 1e-5 / atol 1e-6; sums of trees rtol 1e-4
   / atol 1e-4): float64 sums are taken in another order and rounded once;
   the sums keyed by node are fixed point on both sides.  The large-n kernel
   ``pgbart_step_bign`` likewise, two steps against its plain version on
   pre-drawn Gumbels: at C=4, P=10, n=50,000, p=10, m=20 for gauss with
   tuning on and off (5 refinements), bernoulli, het_abs, het_exp and
   cat_logit (0 refinements), at the n=1000 shapes above (also with a
   hundredth of the precision, where the ESS gate falls both ways), and at
   n=50,001.
   Then its generated-Gumbel mode: the kernel run from a seed equals the
   plain version on the block ``ops.bign.gumbel_block`` writes out for that
   seed, two runs from one seed are identical, and the block's mean and
   variance are a Gumbel's within 1 %, no two of its rows equal, and 216
   million generated values are all finite.
4. ``step``    one tuning and one draw step of ``pgbart_step`` for 4 chains on
   the fused route, on the per-round kernel route and on ``impl="plain"``,
   same random blocks; a non-Gaussian code must refuse the per-round route
   on the card (its selection kernel is Gaussian); a linear forest's two
   steps on the per-round route (which ``route=None`` must choose) against
   ``impl="plain"``.  Then one step at
   n=50,000 three ways on the same blocks: the large-n kernel, its plain
   version (must agree as above) and the whole-step kernel (reported: it
   sums rows in float32 in another order, so at this n a decision may flip).
5. ``sample``  through ``sample()`` on the card at full width (4 chains, 20
   particles, m=50, max_depth=6, n=1000, p=10): the Friedman model on the
   fused route (finite draws, the variable-inclusion recount invariant over
   the stored forests, RMSE against the true f below 1.5), the logistic
   classifier ``y ~ Bernoulli(sigmoid(BART))`` on the fused route at four
   times the steps (finite draws, train accuracy above the majority-class
   rate, mean log-likelihood above the constant-rate model's), a shorter
   Friedman run on the per-round route, and the linear Friedman model of
   ``bench.py`` (``config_friedman_linear``) with a short mix run, with
   ``pgbart_route=None``: the per-round route's warning, 30 growth and 25
   resampling launches a step and nothing else, RMSE below 1.5 (linear), and
   the stored slopes, with the forests, predict the last draw.  Then the two large-n models at
   full width (4 chains, 10 particles, m=20, n=50,000, p=10, no
   refinements, route chosen by ``sample()`` itself): the Friedman regression
   (RMSE against the true f below half of std(f), the recount invariant) and
   the logistic classifier (``store_trees=False``; accuracy and
   log-likelihood as above), on the large-n route with generated Gumbels.
   Kernel launch counts are set to 0 just before each run and read just
   after: a fused run launches the whole-step kernel once a step and none
   of the others, a per-round run the three round kernels (a linear or mix
   run the growth and resampling kernels only), a large-n run
   the large-n kernel once a step and none of the others.  No run may draw
   the (B, D, C, P, n) row-Gumbel block: every route works from a seed.
6. ``timing``  CUDA-event times of each kernel and its plain version at the
   main-path shapes (the growth round for the constant and the linear
   response): ``ms``/``plain_ms`` with the card's queue kept full
   (device time only), ``call_ms``/``plain_call_ms`` issued to an idle card
   (the host's cost of a call included); the time of one whole step on both
   routes; the least time the card could take (bytes over 3.35 TB/s,
   operations over 67 TFLOP/s fp32).  The whole-step kernel is timed as the
   main path runs it (generated Gumbels) with the pre-drawn mode and its
   bound beside.  For the large-n kernel also the traffic of its row passes,
   and the crossover table: device time of one step on the large-n and on
   the whole-step kernel at n = 1000 ... 200,000 (C=4, P=10, m=20) and the
   same at P=20, m=50; the phase fails (after printing its line) if
   ``pgbart_step(route=None)`` takes the slower kernel at a measured shape.
   ``linear_step``: one step of the linear model on the host clock and its
   device time by ``torch.profiler``.

``--phases ...,profile`` adds a ``torch.profiler`` pass over a short
``sample()`` run on the fused route and on the large-n route: device busy
share and the device time by kernel name.  (Where a step of the whole-step
kernel spends its cycles: ``scripts/draw_phase_clocks.py``.)

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
# the large-n models: Friedman regression and logistic classifier at n=50,000
LN = dict(C=4, P=10, N=50_000, PCOLS=10, M=20, DEPTH=6)
REPLACES = {
    "grow_round": "pymc_bart_tpu/ops/grow_pallas.py:564",
    "smc_resample": "pymc_bart_tpu/ops/smc_pallas.py:82",
    "select_refine": "pymc_bart_tpu/ops/select_pallas.py:138",
    "pgbart_step_fused": "pymc_bart_tpu/ops/draw_pallas.py:992",
    "pgbart_step_bign": "pymc_bart_tpu/ops/bign_pallas.py:1011",
}
SOURCES = {
    "grow_round": "pymc_bart_tpu_torch/csrc/grow.cu",
    "smc_resample": "pymc_bart_tpu_torch/csrc/smc.cu",
    "select_refine": "pymc_bart_tpu_torch/csrc/select.cu",
    "pgbart_step_fused": "pymc_bart_tpu_torch/csrc/draw.cu",
    "pgbart_step_bign": "pymc_bart_tpu_torch/csrc/bign.cu",
}
ROUND_KERNELS = ("grow_round", "smc_resample", "select_refine")
# the growth round is held to its plain version at every level of a tree
# update at the main shapes, for each response, from each seed
GROW_RESPONSES = ("constant", "linear", "mix")
GROW_SEEDS = (0, 1, 2)
# rows of a growth round too many for shared memory: the kernel's form that
# keeps them in global memory (ops/grow.py::smem_bytes)
ROWS_GLOBAL = 120_000


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


def compare_grow(tag, got, want, errs=None):
    """Integers equal, floats within tolerance; the max abs error of each
    float output goes into ``errs`` (by name), and where one is not 0 the
    first entry that differs is printed (to stderr)."""
    worst = 0.0
    for name, g, w in zip(GROW_NAMES, got, want):
        tol = (1e-5, 1e-6) if name == "sl" else (1e-4, 1e-5)
        e = check_close(f"grow_round {tag} {name}", g, w, *tol)
        if e > 0:
            diff = ~((g == w) | (torch.isnan(g) & torch.isnan(w)))
            at = [int(v) for v in diff.nonzero()[0].tolist()]
            print(f"grow_round {tag} {name}: max abs err {e}, first at "
                  f"{at}: kernel {float(g[tuple(at)])} plain "
                  f"{float(w[tuple(at)])}", file=sys.stderr, flush=True)
        if errs is not None and g.dtype.is_floating_point:
            errs[name] = max(errs.get(name, 0.0), e)
        worst = max(worst, e)
    return worst


# ---------------------------------------------------------------------------
# inputs at the main-path shapes: a real SMC trajectory of one tree update
# ---------------------------------------------------------------------------


def main_path_inputs(dev, seed=0, response="constant", warm_impl="plain"):
    """Run one tree's SMC with the PLAIN versions on the card and record the
    arguments of every grow / smc / select call (level by level).  The
    frozen particle is a grown tree: 12 steps first, with ``warm_impl``."""
    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
    from pymc_bart_tpu_torch.ops.grow import grow_round_plain
    from pymc_bart_tpu_torch.ops.select import select_refine_plain
    from pymc_bart_tpu_torch.ops.smc import smc_resample_plain
    from pymc_bart_tpu_torch.sampler import pgbart

    cfg = BartConfig(m=M, max_depth=DEPTH, response=response)
    pg = PgbartConfig(num_particles=P, num_refinements=R)
    S = cfg.n_nodes
    X_np, Y_np, _ = friedman(N, PCOLS, seed=6 if response != "constant" else 0)
    X = torch.from_numpy(X_np).to(dev)
    Y = torch.from_numpy(Y_np).to(dev)[:, None]
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = pgbart.init_state(X, Y, cfg, chains=C, device=dev)
    rules = torch.zeros(PCOLS, dtype=torch.int32, device=dev)
    gauss_w = torch.ones((C, N, 1), device=dev)
    for _ in range(12):
        rands = pgbart.draw_rands(gen, B=5, C=C, P=P, D=DEPTH, n=N, k=1, S=S,
                                  num_refinements=R, device=dev,
                                  response=response)
        state, _ = pgbart.pgbart_step(state, rands, X, Y, rules, cfg, pg,
                                      True, gauss_w, impl=warm_impl)
    rands = pgbart.draw_rands(gen, B=1, C=C, P=P, D=DEPTH, n=N, k=1, S=S,
                              num_refinements=R, device=dev, response=response)
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


def mixed_grow_case(dev, seed=3, n=200):
    """Small growth round with NaNs, one-hot and subset columns, the linear
    response, two outputs and a non-identity ``take``; with ``n`` beyond
    what shared memory holds (``ROWS_GLOBAL``) the kernel keeps the rows in
    global memory."""
    from pymc_bart_tpu_torch.config import BartConfig

    rng = np.random.default_rng(seed)
    Cc, Pp, p, k, d = 2, 6, 4, 2, 1
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
               "cat_logit", "gauss_p1000", "gauss_p5000", "gauss_mixed",
               "gauss_flat", "gauss_p19", "gauss_global", "gauss_deep")
# every case runs from each of these seeds of the random blocks
FUSED_SEEDS = (17, 101, 102)
# what a case's launch plan (ops.draw.launch_plan) must say, so that every
# fork of the kernel is held against the plain version: per-particle state in
# shared memory or, where a chain's rows do not fit, in global memory; X and
# the split-weight CDF staged in shared memory or read from global memory
FUSED_PLANS = {
    "gauss_global": dict(form="global", x_staged=False),
    "gauss_deep": dict(form="global", x_staged=False),
    "gauss_p1000": dict(x_staged=False, cdf_staged=True),
    "gauss_p5000": dict(x_staged=False, cdf_staged=False),
}
FUSED_PLAN_DEFAULT = dict(form="shared", x_staged=True, cdf_staged=True)


def fused_case(dev, name, seed=0):
    """Inputs of one whole-step case: ``dict(cfg, pg, X, Y, rules, row, lik,
    lik_const, chains, tunings)`` with every tensor on the card.  ``row`` is
    the (C, n, 1) row data of the code, or None; ``tunings`` the tuning flag
    of the two compared steps.  Beside the eight cases of the likelihood codes
    and widths: ``gauss_flat`` (a hundredth of the precision: the weights stay
    close, so the ESS gate falls both ways and the winner is not always the
    heaviest particle), ``gauss_p19`` (19 particles: one slot of the cluster
    stays idle), ``gauss_global`` (n=16,384 rows: the form that keeps the
    per-particle state in global memory), ``gauss_p5000`` (5000 columns:
    the split-weight CDF is read from global memory) and ``gauss_deep``
    (depth 11 with a flat depth prior: the node arrays of 20 particles do not
    fit shared memory, so the global form at n=1000)."""
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
        if name in ("gauss_p1000", "gauss_p5000"):
            # the width of the p=1000 config; five times that
            X = rng.uniform(size=(200, int(name[7:]))).astype(np.float32)
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
        elif name == "gauss_p19":
            pg = PgbartConfig(num_particles=19, num_refinements=R)
        elif name == "gauss_global":
            chains = 2
            cfg = BartConfig(m=LN["M"], max_depth=DEPTH)
            pg = PgbartConfig(num_particles=LN["P"], num_refinements=R)
            X, Y, _ = friedman(16384, PCOLS, seed=5)
            chain_shift = chain_shift[:chains]
        elif name == "gauss_deep":
            chains = 2
            cfg = BartConfig(m=10, max_depth=11, beta=0.5)
            chain_shift = chain_shift[:chains]
        row = np.broadcast_to(
            (0.01 if name == "gauss_flat" else 1.0) * (1.0 + 0.2 * chain_shift),
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


def fused_rands(case, gen, tuning, dev, row_gumbels=True):
    from pymc_bart_tpu_torch.sampler import pgbart

    cfg, pg = case["cfg"], case["pg"]
    return pgbart.draw_rands(
        gen, B=pg.batch_size(cfg.m, tuning), C=case["chains"],
        P=pg.num_particles, D=cfg.max_depth, n=case["X"].shape[0], k=1,
        S=cfg.n_nodes, num_refinements=pg.num_refinements, device=dev,
        row_gumbels=row_gumbels)


def fused_plan(case):
    """The launch plan of the whole-step kernel for a case's shapes."""
    from pymc_bart_tpu_torch.ops.draw import launch_plan

    cfg, pg = case["cfg"], case["pg"]
    n, p = case["X"].shape
    return launch_plan(case["chains"], pg.num_particles, cfg.max_depth,
                       cfg.n_nodes, n, p, max(pg.num_refinements, 1))


def with_block(case, rands, tuning):
    """``rands`` with the row Gumbels its seed generates written out."""
    import dataclasses

    from pymc_bart_tpu_torch.ops.bign import gumbel_block

    cfg, pg = case["cfg"], case["pg"]
    return dataclasses.replace(rands, rg=gumbel_block(
        rands.seed, B=pg.batch_size(cfg.m, tuning), C=case["chains"],
        P=pg.num_particles, D=cfg.max_depth, n=case["X"].shape[0]))


def grown_state(case, gen, dev, steps=11):
    """A state in which every tree has been updated at least once and the
    ``leaf_sd`` adaptation has begun: ``steps`` tuning steps of the kernel on
    generated Gumbels."""
    from pymc_bart_tpu_torch.sampler import pgbart

    state = pgbart.init_state(case["X"], case["Y"], case["cfg"],
                              chains=case["chains"], device=dev)
    for _ in range(steps):
        state, _ = fused_step(case, state,
                              fused_rands(case, gen, True, dev, False), True)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(state.sum_trees).all()):
        raise AssertionError("warm-up steps left a non-finite sum of trees")
    return state


def compare_fused(dev, name, seed=17):
    """Two consecutive steps of the whole-step kernel against its plain
    version from one grown state, on pre-drawn Gumbels; returns (max abs err,
    split nodes, launch plan)."""
    case = fused_case(dev, name)
    plan = fused_plan(case)
    for key, want in dict(FUSED_PLAN_DEFAULT,
                          **FUSED_PLANS.get(name, {})).items():
        if getattr(plan, key) != want:
            raise AssertionError(f"{name}: the kernel would run with "
                                 f"{key}={getattr(plan, key)!r} ({plan})")
    if name == "gauss_p19" and not (plan.cluster * plan.per_block
                                    > case["pg"].num_particles):
        raise AssertionError(f"{name}: no idle particle slot in {plan}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_kernel = grown_state(case, gen, dev)
    s_plain = s_kernel.clone()
    worst = 0.0
    for i, tuning in enumerate(case["tunings"]):
        rands = fused_rands(case, gen, tuning, dev)
        s_kernel, vi_k = fused_step(case, s_kernel, rands, tuning, "kernel")
        torch.cuda.synchronize()
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
    return worst, splits, plan


def state_fields(state):
    for name in STATE_TOL:
        holder = state if hasattr(state, name) else state.forest
        yield name, getattr(holder, name)


def check_generated_fused(dev, seed=31):
    """The generated-Gumbel mode of the whole-step kernel, in both forms: the
    kernel run from a seed equals the plain version on the block
    ``ops.bign.gumbel_block`` writes out for that seed, and two runs from one
    seed are identical bit for bit."""
    out = {}
    for name in ("gauss_tune", "bernoulli", "gauss_global"):
        case = fused_case(dev, name)
        gen = torch.Generator(device=dev).manual_seed(seed)
        first = grown_state(case, gen, dev)
        tuning = case["tunings"][0]
        rands = fused_rands(case, gen, tuning, dev, row_gumbels=False)
        s_gen, vi_gen = fused_step(case, first.clone(), rands, tuning, "kernel")
        s_again, vi_again = fused_step(case, first.clone(), rands, tuning,
                                       "kernel")
        s_plain, vi_plain = fused_step(case, first.clone(),
                                       with_block(case, rands, tuning), tuning,
                                       "plain")
        torch.cuda.synchronize()
        check_close(f"generated {name} vi", vi_gen, vi_plain, 0.0, 0.0)
        err = compare_state(f"pgbart_step_fused generated {name}", s_gen,
                            s_plain)
        if not torch.equal(vi_gen, vi_again):
            raise AssertionError(f"generated mode, {name}: two runs from one "
                                 "seed differ")
        for (field, ta), (_, tb) in zip(state_fields(s_gen),
                                        state_fields(s_again)):
            if not torch.equal(ta, tb):
                raise AssertionError(f"generated mode, {name}: {field} differs "
                                     "between two runs from one seed")
        out[name] = dict(max_abs_err_vs_plain_on_block=err,
                         identical_reruns=True, form=fused_plan(case).form)
    return out


# ---------------------------------------------------------------------------
# the large-n kernel: cases, steps, comparisons
# ---------------------------------------------------------------------------

BIGN_CASES = ("gauss_tune", "gauss_draw", "bernoulli", "het_abs", "het_exp",
              "cat_logit", "gauss_n1000", "gauss_n50001", "gauss_flat")


def bign_case(dev, name, n=None, seed=0):
    """Inputs of one large-n case, every tensor on the card: ``dict(cfg, pg,
    X, Y, lik, lik_const, chains, w_chain, llw, tunings)``.  The sizes are the
    large-n models' (C=4, P=10, m=20, depth 6, p=10) at ``n`` rows (default
    50,000); ``gauss_n1000`` has the n=1000 shapes (P=20, m=50), and so has
    ``gauss_flat``, whose precision is a hundredth: the particles' weights
    then stay close, the effective sample size falls on both sides of its
    gate and the winner is not always the heaviest particle (at n=50,000 one
    particle carries all the weight and the gate always fires)."""
    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig

    rng = np.random.default_rng(200 + seed)
    chains, particles, m, refinements = LN["C"], LN["P"], LN["M"], 0
    n = n or {"gauss_n1000": N, "gauss_flat": N,
              "gauss_n50001": LN["N"] + 1}.get(name, LN["N"])
    lik, lik_const, tunings = name, 0.0, (True, False)
    X, Y, _ = friedman(n, LN["PCOLS"], seed=5)
    chain_shift = np.arange(chains, dtype=np.float32)[:, None]
    w_chain = llw = None
    if name.startswith("gauss"):
        lik, refinements = "gauss", R
        tunings = (False, False) if name == "gauss_draw" else (True, True)
        if name in ("gauss_n1000", "gauss_flat"):
            particles, m = P, M
        w_chain = (1.0 + 0.2 * chain_shift[:, 0]).astype(np.float32)
        if name == "gauss_flat":
            w_chain *= 0.01
    elif name == "bernoulli":
        X, Y = logistic(n, LN["PCOLS"], seed=7)
    elif name in ("het_abs", "het_exp"):
        lik_const = 0.05 if name == "het_abs" else 0.0
        llw = (Y[None, :] - (Y.mean() + 0.1 * chain_shift)) ** 2
        s_hat = np.abs(Y - Y.mean()) / 0.7978845608
        Y = (s_hat - lik_const if name == "het_abs"
             else np.log(np.maximum(s_hat, 1e-3))).astype(np.float32)
    elif name == "cat_logit":
        labels = (3 * X[:, 0]).astype(np.int64) % 3
        Y = (4.0 * (labels == 0) - 2.0).astype(np.float32)
        others = rng.normal(0.0, 0.5, size=(chains, n, 2))
        llw = np.log(np.exp(others).sum(axis=2))
    else:
        raise ValueError(name)

    def t(a):
        return (None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32)).to(dev))

    return dict(cfg=BartConfig(m=m, max_depth=LN["DEPTH"]),
                pg=PgbartConfig(num_particles=particles,
                                num_refinements=refinements),
                X=t(X), Y=t(Y)[:, None], lik=lik, lik_const=lik_const,
                chains=chains, w_chain=t(w_chain), llw=t(llw),
                rules=torch.zeros(X.shape[1], dtype=torch.int32, device=dev),
                row=(t(np.broadcast_to(w_chain[:, None, None], (chains, n, 1)))
                     if lik == "gauss" else
                     None if llw is None else t(llw)[:, :, None]),
                tunings=tunings)


def bign_step(case, state, rands, tuning, impl=None):
    from pymc_bart_tpu_torch.ops.bign import pgbart_step_bign

    return pgbart_step_bign(
        state, rands, case["X"], case["Y"], case["cfg"], case["pg"],
        case["w_chain"], tuning, lik=case["lik"], lik_const=case["lik_const"],
        llw=case["llw"], impl=impl)


def bign_rands(case, gen, tuning, dev, row_gumbels=True):
    from pymc_bart_tpu_torch.sampler import pgbart

    cfg, pg = case["cfg"], case["pg"]
    return pgbart.draw_rands(
        gen, B=pg.batch_size(cfg.m, tuning), C=case["chains"],
        P=pg.num_particles, D=cfg.max_depth, n=case["X"].shape[0], k=1,
        S=cfg.n_nodes, num_refinements=pg.num_refinements, device=dev,
        row_gumbels=row_gumbels)


def bign_grown_state(case, gen, dev, steps=11):
    """A state in which every tree has been updated at least once and the
    ``leaf_sd`` adaptation has begun: ``steps`` tuning steps of the large-n
    kernel on generated Gumbels."""
    from pymc_bart_tpu_torch.sampler import pgbart

    state = pgbart.init_state(case["X"], case["Y"], case["cfg"],
                              chains=case["chains"], device=dev)
    for _ in range(steps):
        state, _ = bign_step(case, state,
                             bign_rands(case, gen, True, dev, False), True)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(state.sum_trees).all()):
        raise AssertionError("warm-up steps left a non-finite sum of trees")
    return state


def compare_bign(dev, name, seed=23):
    """Two consecutive steps of the large-n kernel against its plain version
    from one grown state, on pre-drawn Gumbels; returns (max abs err, split
    nodes)."""
    case = bign_case(dev, name)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_kernel = bign_grown_state(case, gen, dev)
    s_plain = s_kernel.clone()
    worst = 0.0
    for i, tuning in enumerate(case["tunings"]):
        rands = bign_rands(case, gen, tuning, dev)
        s_kernel, vi_k = bign_step(case, s_kernel, rands, tuning, "kernel")
        torch.cuda.synchronize()
        s_plain, vi_p = bign_step(case, s_plain, rands, tuning, "plain")
        torch.cuda.synchronize()
        tag = f"pgbart_step_bign {name} step {i}"
        check_close(f"{tag} vi", vi_k, vi_p, 0.0, 0.0)
        worst = max(worst, compare_state(tag, s_kernel, s_plain))
    splits = int((s_kernel.forest.split_var >= 0).sum())
    if splits == 0:
        raise AssertionError(f"{name}: the forest has no split at all")
    return worst, splits


def check_generated(dev, seed=29):
    """The generated-Gumbel mode of the large-n kernel: equal to the plain
    version on the written-out block, the same from run to run, and a Gumbel
    in mean and variance."""
    import dataclasses

    from pymc_bart_tpu_torch.ops.bign import gumbel_block

    case = bign_case(dev, "gauss_draw")
    gen = torch.Generator(device=dev).manual_seed(seed)
    first = bign_grown_state(case, gen, dev)
    rands = bign_rands(case, gen, False, dev, row_gumbels=False)
    cfg, pg = case["cfg"], case["pg"]
    block = gumbel_block(rands.seed, B=pg.batch_size(cfg.m, False),
                         C=case["chains"], P=pg.num_particles, D=cfg.max_depth,
                         n=case["X"].shape[0])
    s_gen, vi_gen = bign_step(case, first.clone(), rands, False, "kernel")
    s_again, vi_again = bign_step(case, first.clone(), rands, False, "kernel")
    s_plain, vi_plain = bign_step(case, first.clone(),
                                  dataclasses.replace(rands, rg=block), False,
                                  "plain")
    torch.cuda.synchronize()
    check_close("generated vi", vi_gen, vi_plain, 0.0, 0.0)
    err = compare_state("pgbart_step_bign generated", s_gen, s_plain)
    if not torch.equal(vi_gen, vi_again):
        raise AssertionError("generated mode: two runs from one seed differ")
    for (name, ta), (_, tb) in zip(state_fields(s_gen), state_fields(s_again)):
        if not torch.equal(ta, tb):
            raise AssertionError(f"generated mode: {name} differs between two "
                                 "runs from one seed")
    mean, var = float(block.mean()), float(block.var())
    euler, var_g = 0.5772156649, np.pi**2 / 6
    if abs(mean - euler) > 0.01 * euler or abs(var - var_g) > 0.01 * var_g:
        raise AssertionError(f"generated Gumbels: mean {mean}, variance {var}")
    rows = block.reshape(-1, block.shape[-1])[:, :64]
    if torch.unique(rows, dim=0).shape[0] != rows.shape[0]:
        raise AssertionError("generated Gumbels: two (tree, level, particle) "
                             "rows are equal")
    # every value finite, over enough draws that a mapping which reaches
    # u = 0 or u = 1 once in 2^24 values cannot slip through
    checked = 0
    for _ in range(9):
        if not bool(torch.isfinite(block).all()):
            raise AssertionError("generated Gumbels: not finite")
        checked += block.numel()
        seed = torch.randint(-2**31, 2**31, (2,), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)
        block = gumbel_block(seed, B=block.shape[0], C=block.shape[2],
                             P=block.shape[3], D=block.shape[1],
                             n=block.shape[4])
    return dict(max_abs_err_vs_plain_on_block=err, identical_reruns=True,
                mean=mean, variance=var, rows=int(rows.shape[0]),
                values=int(block.numel()), finite_values_checked=checked)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernels(dev, calls, cfg):
    from pymc_bart_tpu_torch.ops.grow import grow_round
    from pymc_bart_tpu_torch.ops.select import select_refine
    from pymc_bart_tpu_torch.ops.smc import smc_resample

    errs = {"grow_round": 0.0, "smc_resample": 0.0, "select_refine": 0.0}
    grow_cases = {}
    for response in GROW_RESPONSES:
        float_errs, grown, slopes = {}, 0, 0
        for seed in GROW_SEEDS:
            # the constant response's first trajectory is the main path's
            # (its smc and select calls are compared below); the others warm
            # up on the kernels
            traj = (calls if (response, seed) == ("constant", 0) else
                    main_path_inputs(dev, seed, response, warm_impl=None)[0])
            for a, kw in traj["grow"]:
                got = grow_round(*a, impl="kernel", **kw)
                torch.cuda.synchronize()
                want = grow_round(*a, impl="plain", **kw)
                torch.cuda.synchronize()
                compare_grow(f"{response} seed {seed} d={kw['d']}", got, want,
                             float_errs)
                grown += int(((got[0] >= 0) & (a[2] < 0)).sum())
                slopes += int(((got[5] != 0) & (a[7] == 0)).sum())
        if grown == 0:
            raise AssertionError(f"{response}: no particle grew at the "
                                 "main-path shapes")
        if (slopes > 0) != (response != "constant"):
            raise AssertionError(f"{response}: {slopes} slopes drawn")
        grow_cases[response] = dict(max_abs_err=float_errs, grown_nodes=grown,
                                    slopes_drawn=slopes,
                                    seeds=list(GROW_SEEDS),
                                    levels=list(range(DEPTH)))
        errs["grow_round"] = max([errs["grow_round"], *float_errs.values()])
    mixed_err = {}
    for n_rows in (200, ROWS_GLOBAL):
        a, kw = mixed_grow_case(dev, n=n_rows)
        got = grow_round(*a, impl="kernel", **kw)
        torch.cuda.synchronize()
        want = grow_round(*a, impl="plain", **kw)
        torch.cuda.synchronize()
        mixed_err[n_rows] = compare_grow(f"mixed n={n_rows}", got, want)
        errs["grow_round"] = max(errs["grow_round"], mixed_err[n_rows])
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
        err = 0.0
        for seed in FUSED_SEEDS:
            e, splits, plan = compare_fused(dev, name, seed)
            err = max(err, e)
        fused[name] = dict(max_abs_err=err, split_nodes=splits, form=plan.form,
                           cluster=plan.cluster, particles_per_block=plan.per_block,
                           warps_per_particle=plan.warps,
                           x_staged=plan.x_staged, cdf_staged=plan.cdf_staged,
                           smem_bytes=plan.smem, seeds=list(FUSED_SEEDS))
    fused_generated = check_generated_fused(dev)
    errs["pgbart_step_fused"] = max(
        [v["max_abs_err"] for v in fused.values()]
        + [v["max_abs_err_vs_plain_on_block"]
           for v in fused_generated.values()])
    large = {}
    for name in BIGN_CASES:
        err, splits = compare_bign(dev, name)
        large[name] = dict(max_abs_err=err, split_nodes=splits)
    generated = check_generated(dev)
    errs["pgbart_step_bign"] = max(
        [v["max_abs_err"] for v in large.values()]
        + [generated["max_abs_err_vs_plain_on_block"]])
    emit("kernels", max_abs_err=errs, grow_round_cases=grow_cases,
         grow_mixed_max_abs_err=mixed_err,
         smc_calls_that_resampled=resampled,
         pgbart_step_fused_cases=fused,
         pgbart_step_fused_generated=fused_generated,
         pgbart_step_bign_cases=large,
         pgbart_step_bign_generated=generated,
         large_n_shapes=dict(LN, S=2 ** (LN["DEPTH"] + 1) - 1),
         tolerance={"integers": "equal", "split_val": "rtol 1e-5 atol 1e-6",
                    "other floats": "rtol 1e-4 atol 1e-5",
                    "state of a whole step": {
                        k: "equal" if v is None else f"rtol {v[0]} atol {v[1]}"
                        for k, v in STATE_TOL.items()}},
         shapes=dict(C=C, P=P, n=N, p=PCOLS, S=cfg.n_nodes, m=M))
    return errs


def phase_step(dev):
    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
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
    # one step at n = 50,000 three ways, same pre-drawn blocks
    from pymc_bart_tpu_torch.ops.draw import pgbart_step_fused

    case = bign_case(dev, "gauss_draw")
    start = bign_grown_state(case, gen, dev)
    rands = bign_rands(case, gen, False, dev)
    args = (case["X"], case["Y"], case["rules"], case["cfg"], case["pg"],
            False, case["row"])
    outs = {}
    for k, kw in (("bign", dict(route="bign")),
                  ("plain", dict(route="bign", impl="plain")),
                  ("fused", dict(route="fused"))):
        before = pgbart_step_fused.launches
        outs[k] = pgbart.pgbart_step(start.clone(), rands, *args,
                                     w_scalar=True, all_cont=True,
                                     x_nan=False, **kw)
        if (pgbart_step_fused.launches - before) != (k == "fused"):
            raise AssertionError(f"step at n=50,000: route {k} and the "
                                 "whole-step kernel's launch count disagree")
    torch.cuda.synchronize()
    check_close("large-n step vi", outs["bign"][1], outs["plain"][1], 0.0, 0.0)
    large_err = compare_state("large-n step", outs["bign"][0],
                              outs["plain"][0])
    sf, sb = outs["fused"][0], outs["bign"][0]
    if not bool(torch.isfinite(sf.sum_trees).all()):
        raise AssertionError("whole-step kernel at n=50,000: not finite")
    check_close("large-n step iteration", sf.iteration, sb.iteration, 0, 0)
    linear = linear_steps(dev)
    emit("step", max_abs_err_vs_plain=worst, split_nodes=splits, chains=C,
         rounds_route_refuses_bernoulli=refusal, linear=linear,
         large_n=dict(
             n=LN["N"], bign_max_abs_err_vs_plain=large_err,
             fused_split_vars_differing=int(
                 (sf.forest.split_var != sb.forest.split_var).sum()),
             fused_sum_trees_max_abs_diff=max_err(sf.sum_trees, sb.sum_trees)))


def linear_steps(dev):
    """A linear forest at the main shapes (the linear Friedman model's data):
    ``route=None`` must resolve to the per-round route; one tuning and one
    draw step there, the kernels against ``impl="plain"`` on the same
    blocks."""
    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
    from pymc_bart_tpu_torch.sampler import pgbart

    cfg = BartConfig(m=M, max_depth=DEPTH, response="linear")
    pg = PgbartConfig(num_particles=P, num_refinements=R)
    X_np, Y_np, _ = friedman(N, PCOLS, seed=6)
    X = torch.from_numpy(X_np).to(dev)
    Y = torch.from_numpy(Y_np).to(dev)[:, None]
    rules = torch.zeros(PCOLS, dtype=torch.int32, device=dev)
    gauss_w = torch.ones((C, N, 1), device=dev)
    taken, why = pgbart.resolve_route(None, cfg, pg, X, gauss_w, "gauss",
                                      chains=C, w_scalar=True, all_cont=True,
                                      x_nan=False)
    if taken != "rounds":
        raise AssertionError(f"a linear forest resolves to route {taken!r}")
    gen = torch.Generator(device=dev).manual_seed(13)
    first = pgbart.init_state(X, Y, cfg, chains=C, device=dev)
    states = {"rounds": first.clone(), "plain": first.clone()}
    worst = 0.0
    for tuning in (True, False):
        rands = pgbart.draw_rands(
            gen, B=pg.batch_size(M, tuning), C=C, P=P, D=DEPTH, n=N, k=1,
            S=cfg.n_nodes, num_refinements=R, device=dev, response="linear")
        vis = {}
        for k, impl in (("rounds", None), ("plain", "plain")):
            states[k], vis[k] = pgbart.pgbart_step(
                states[k], rands, X, Y, rules, cfg, pg, tuning, gauss_w,
                impl=impl)
        torch.cuda.synchronize()
        check_close("linear step vi", vis["rounds"], vis["plain"], 0.0, 0.0)
        worst = max(worst, compare_state("linear step", states["rounds"],
                                         states["plain"]))
    f = states["rounds"].forest
    slopes = int((f.slope != 0).sum())
    if slopes == 0 or not bool((f.split_var >= 0).any()):
        raise AssertionError("two linear steps grew no split or no slope")
    return dict(route=taken, max_abs_err_vs_plain=worst,
                split_nodes=int((f.split_var >= 0).sum()), slopes=slopes,
                whole_step_refuses=why["fused"], large_n_refuses=why["bign"])


def sample_run(model, route, tune, draws, shape=None, choose=False):
    """One ``sample()`` run on the card with every launch count set to 0
    just before and read just after; checks the counts of the route.

    ``shape``: ``dict(C, P, N, PCOLS, M, DEPTH)`` plus the ``sample()``
    arguments ``refinements`` and ``store_trees``; default the n=1000 shapes.
    ``route``: ``"fused"`` / ``"rounds"`` force that route; ``"bign"``, or
    any route with ``choose``, leaves the choice to ``sample()``
    (``pgbart_route=None``), which must then take that route (the per-round
    route also says so in its warning).  A linear or mix forest must in
    addition store slopes that, with the rest of its last draw's forests,
    predict that draw."""
    import warnings

    from pymc_bart_tpu_torch.ops.predict import forest_predict
    from pymc_bart_tpu_torch.ops.trees import Forest
    import pymc_bart_tpu_torch as pmb
    from pymc_bart_tpu_torch.ops.bign import pgbart_step_bign
    from pymc_bart_tpu_torch.ops.draw import pgbart_step_fused
    from pymc_bart_tpu_torch.ops.grow import grow_round
    from pymc_bart_tpu_torch.ops.select import select_refine
    from pymc_bart_tpu_torch.ops.smc import smc_resample

    sh = dict(C=C, P=P, N=N, PCOLS=PCOLS, M=M, DEPTH=DEPTH, refinements=R,
              store_trees=True)
    sh.update(shape or {})
    wrappers = {"grow_round": grow_round, "smc_resample": smc_resample,
                "select_refine": select_refine,
                "pgbart_step_fused": pgbart_step_fused,
                "pgbart_step_bign": pgbart_step_bign}
    from pymc_bart_tpu_torch.sampler import pgbart

    timings = {}
    blocks_drawn = []          # row_gumbels of every draw_rands call
    real_draw = pgbart.draw_rands

    def spy(*a, **kw):
        blocks_drawn.append(bool(kw.get("row_gumbels", True)))
        return real_draw(*a, **kw)

    choose = choose or route == "bign"
    with pmb.Model(), warnings.catch_warnings(record=True) as said:
        warnings.simplefilter("always")
        rv = model(pmb)
        for w in wrappers.values():
            w.launches = 0
        pgbart.draw_rands = spy
        try:
            t0 = time.perf_counter()
            idata = pmb.sample(tune=tune, draws=draws, chains=sh["C"],
                               random_seed=0, num_particles=sh["P"],
                               num_refinements=sh["refinements"],
                               store_trees=sh["store_trees"],
                               chunk_size=max(1, draws // 2), timings=timings,
                               convergence_checks=False,
                               pgbart_route=None if choose else route)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            pgbart.draw_rands = real_draw
        launches = {k: int(w.launches) for k, w in wrappers.items()}
    per_round_said = any("per-round sampler route" in str(w.message)
                         for w in said)
    if choose and per_round_said != (route == "rounds"):
        raise AssertionError(f"route=None, expected {route!r}: the per-round "
                             f"warning {'was' if per_round_said else 'was not'}"
                             " given")
    constant = rv.config.response == "constant"
    # on the card sample() draws no (B, D, C, P, n) block on any route: the
    # whole-step kernels generate their row Gumbels from a seed, the
    # per-round route has the same generator write them out
    if len(blocks_drawn) != tune + draws or any(blocks_drawn):
        raise AssertionError(
            f"{route} route: {len(blocks_drawn)} draw_rands calls, "
            f"{sum(blocks_drawn)} of them with the row-Gumbel block")
    steps = tune + draws
    B = max(1, int(sh["M"] * 0.1))
    want = dict.fromkeys(wrappers, 0)
    if route == "rounds":
        # a linear / mix winner is selected in plain PyTorch, as in JAX
        want.update(grow_round=steps * B * sh["DEPTH"],
                    smc_resample=steps * B * (sh["DEPTH"] - 1),
                    select_refine=steps * B if constant else 0)
    else:
        want["pgbart_step_" + route] = steps
    for k, v in launches.items():
        if want[k] and v == 0:
            raise AssertionError(f"the {route} route never launched {k}")
        if v != want[k]:
            raise AssertionError(f"{route} route, {k}: {v} launches, "
                                 f"expected {want[k]}")
    post = np.asarray(idata.posterior[rv.name].values)
    if post.shape != (sh["C"], draws, sh["N"]):
        raise AssertionError(f"posterior shape {post.shape}")
    if not np.isfinite(post).all():
        raise AssertionError("non-finite posterior draws")
    vi = np.asarray(idata["sample_stats"]["variable_inclusion"].values)
    if sh["store_trees"]:
        sv = rv.all_trees.split_var
        if sv.shape != (sh["C"], draws, sh["M"], 2 ** (sh["DEPTH"] + 1) - 1):
            raise AssertionError(f"stored forests have shape {sv.shape}")
        recount = np.stack([(sv == j).sum(axis=(2, 3))
                            for j in range(sh["PCOLS"])], axis=-1)
        if not np.array_equal(vi[:, :, 0, :], recount):
            raise AssertionError("variable_inclusion != recount over the "
                                 "forests")
        if not constant:
            tr = rv.all_trees
            if not (tr.slope != 0).any():
                raise AssertionError("the stored forests hold no slope")
            last = Forest(*(torch.as_tensor(np.ascontiguousarray(a[:, -1]))
                            .cuda() for a in (
                tr.split_var, tr.split_val, tr.split_set.view(np.int32),
                tr.leaf, tr.count, tr.slope)))
            fp = forest_predict(
                last, torch.as_tensor(rv.X, dtype=torch.float32).cuda(),
                torch.as_tensor(rv.rules_array()).cuda(), sh["DEPTH"])
            fp = fp[..., 0].cpu().numpy()
            if not np.allclose(fp, post[:, -1], rtol=1e-4, atol=1e-3):
                raise AssertionError(
                    "the stored forests with their slopes do not predict the "
                    f"last draw: max abs diff {np.abs(fp - post[:, -1]).max()}")
    elif not (vi.sum(axis=-1) > 0).all():
        raise AssertionError("a draw's forest has no split at all")
    for c in range(1, sh["C"]):
        if np.array_equal(post[0], post[c]):
            raise AssertionError(f"chain {c} repeats chain 0")
    out = dict(route=route, route_chosen_by_sample=choose,
               response=rv.config.response, tune=tune, draws=draws,
               chains=sh["C"],
               n=sh["N"], seconds=seconds,
               tune_seconds=timings["tune_seconds"],
               draw_seconds_total=timings["draw_seconds_total"],
               chain_draws_per_s=sh["C"] * draws
               / timings["draw_seconds_total"],
               vi_top5=np.argsort(vi.sum(axis=(0, 1))[0])[::-1][:5].tolist(),
               launches=launches, gumbel_blocks_drawn=sum(blocks_drawn))
    return idata, post, out


def classifier_quality(post, labels):
    """Train accuracy above the majority rate and mean log-likelihood above
    the constant-rate model's, from the posterior mean of the logit."""
    lo_hat = post.mean(axis=(0, 1))
    acc = float(((lo_hat > 0) == (labels > 0.5)).mean())
    ph = np.clip(1 / (1 + np.exp(-lo_hat)), 1e-6, 1 - 1e-6)
    ll = float(np.mean(labels * np.log(ph) + (1 - labels) * np.log(1 - ph)))
    rate = float(labels.mean())
    majority = max(rate, 1 - rate)
    ll_const = rate * np.log(rate) + (1 - rate) * np.log(1 - rate)
    if not acc > majority:
        raise AssertionError(f"train accuracy {acc} <= majority {majority}")
    if not ll > ll_const:
        raise AssertionError(f"mean log-likelihood {ll} <= {ll_const} of the "
                             "constant-rate model")
    return dict(train_accuracy=acc, majority_rate=majority, mean_loglik=ll,
                constant_rate_loglik=float(ll_const))


def phase_sample(dev, tune, draws, large_tune, large_draws):
    """Friedman and logistic on the fused route, a shorter Friedman run on
    the per-round route, then the two n=50,000 models on the large-n route.
    Returns the launch counts of every kernel on the path that drives it."""
    X, Y, f_true = friedman(N, PCOLS)

    def friedman_model(pmb):
        mu = pmb.BART("mu", X, Y, m=M, max_depth=DEPTH)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)
        return mu

    def friedman_quality(idata, post, out, f=f_true, model="friedman",
                         bound=True):
        sig = np.asarray(idata.posterior["sigma"].values)
        if sig.shape != post.shape[:2] or not np.isfinite(sig).all():
            raise AssertionError("sigma draws are missing or not finite")
        rmse = float(np.sqrt(np.mean((post.mean(axis=(0, 1)) - f) ** 2)))
        if bound and not rmse < RMSE_BOUND:
            raise AssertionError(f"rmse vs true f {rmse} >= {RMSE_BOUND}")
        return dict(out, model=model, rmse_vs_true_f=rmse,
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
    runs["logistic_fused"] = dict(out, model="logistic",
                                  **classifier_quality(post, Yl))

    short = max(2, draws // 4)
    runs["friedman_rounds"] = friedman_quality(
        *sample_run(friedman_model, "rounds", short, 2 * short))

    # the linear Friedman model of bench.py (config_friedman_linear) at full
    # width: sample() takes the per-round route by itself; a short mix run
    Xn, Yn, fn = friedman(N, PCOLS, seed=6)

    def slope_model(response):
        def build(pmb):
            mu = pmb.BART("mu", Xn, Yn, m=M, max_depth=DEPTH,
                          response=response)
            sigma = pmb.HalfNormal("sigma", 1.0)
            pmb.Normal("y", mu, sigma, observed=Yn)
            return mu
        return build

    runs["friedman_linear"] = friedman_quality(
        *sample_run(slope_model("linear"), "rounds", short, 2 * short,
                    choose=True), f=fn, model="friedman linear")
    mix_steps = max(2, draws // 16)
    runs["friedman_mix"] = friedman_quality(
        *sample_run(slope_model("mix"), "rounds", mix_steps, mix_steps,
                    choose=True), f=fn, model="friedman mix", bound=False)

    # the two large-n models; sample() itself must choose the large-n route
    big = dict(LN, refinements=0)
    Xb, Yb, fb = friedman(LN["N"], LN["PCOLS"], seed=5)

    def large_regression(pmb):
        mu = pmb.BART("mu", Xb, Yb, m=LN["M"])
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Yb)
        return mu

    idata, post, out = sample_run(large_regression, "bign", large_tune,
                                  large_draws, dict(big, store_trees=True))
    rmse = float(np.sqrt(np.mean((post.mean(axis=(0, 1)) - fb) ** 2)))
    if not rmse < 0.5 * float(np.std(fb)):
        raise AssertionError(f"large-n rmse vs true f {rmse} >= half of "
                             f"std(f) {float(np.std(fb))}")
    sig = np.asarray(idata.posterior["sigma"].values)
    if not np.isfinite(sig).all():
        raise AssertionError("large-n sigma draws are not finite")
    runs["large_n_regression"] = dict(
        out, model="friedman n=50,000", rmse_vs_true_f=rmse,
        std_f=float(np.std(fb)), sigma_mean=float(sig.mean()))
    del idata, post

    Xc, Yc = logistic(LN["N"], LN["PCOLS"], seed=7)

    def large_classifier(pmb):
        lo = pmb.BART("lo", Xc, Yc, m=LN["M"])
        pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=Yc)
        return lo

    idata, post, out = sample_run(large_classifier, "bign", large_tune,
                                  large_draws, dict(big, store_trees=False))
    runs["large_n_classifier"] = dict(out, model="logistic n=50,000",
                                      **classifier_quality(post, Yc))
    del idata, post
    emit("sample", runs=runs)
    per_round = ("friedman_rounds", "friedman_linear", "friedman_mix")
    launches = {k: sum(runs[r]["launches"][k] for r in per_round)
                for k in ROUND_KERNELS}
    for name, used_by in (
            ("pgbart_step_fused", ("friedman_fused", "logistic_fused")),
            ("pgbart_step_bign", ("large_n_regression",
                                  "large_n_classifier"))):
        launches[name] = sum(runs[r]["launches"][name] for r in used_by)
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

    # growth round: every level, then the mean over the D levels of a tree;
    # the constant response's main path, and the linear model's
    def grow_levels(traj):
        rows = []
        for a, kw in traj["grow"]:
            outs = grow_round(*a, impl="kernel", **kw)
            # every argument read once, every output written once
            bts = nbytes(*a) + nbytes(*outs)
            # per row and particle: Gumbel compare, routing compare, child-sum
            # add, and diff, square, weight, add for the log-likelihood; the
            # linear response adds x, x^2, x r and the slope term
            lin = kw["cfg"].response != "constant"
            ops = C * P * N * (3 + 4 * 1 + (5 if lin else 0))
            b_ms, by = bound(bts, ops)
            rows.append(dict(
                d=kw["d"], bytes=bts, bound_ms=b_ms, bound_by=by,
                **timed(lambda: grow_round(*a, impl="kernel", **kw),
                        lambda: grow_round(*a, impl="plain", **kw))))
        return dict(
            {key: float(np.mean([r[key] for r in rows]))
             for key in ("ms", "call_ms", "plain_ms", "plain_call_ms",
                         "bound_ms")},
            bound_by=rows[0]["bound_by"], by_level=rows)

    out["grow_round"] = grow_levels(calls)
    out["grow_round"]["linear"] = grow_levels(
        main_path_inputs(dev, 0, "linear", warm_impl=None)[0])

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
    # launch advances the state in place, as on the main path.  The main path
    # gives it a seed and no Gumbel block, so `ms` is the generated mode's
    # and `bound_ms` counts no block; the pre-drawn mode stands beside both.
    case = fused_case(dev, "gauss_draw")
    gen = torch.Generator(device=dev).manual_seed(5)
    st_k = grown_state(case, gen, dev)
    st_p = st_k.clone()
    r_gen = fused_rands(case, gen, False, dev, row_gumbels=False)
    r_pre = with_block(case, r_gen, False)
    B = case["pg"].batch_size(M, False)
    S = cfg.n_nodes
    # every random block read once; per updated tree the forest rows and
    # tree_pred row read and written; sum_trees read and written; X, y, the
    # row data, alpha_vec and leaf_sd read; the forest's split variables read
    # for the histogram; the histogram written
    small = nbytes(*(getattr(r_gen, f) for f in
                     ("ug", "uv", "eps", "sb", "ures", "usel", "epsr", "uacc",
                      "seed")))
    bts = (small + 4 * C * B * (2 * 6 * S + 2 * N) + 4 * 2 * C * N
           + nbytes(case["X"], case["Y"], case["row"], st_k.alpha_vec,
                    st_k.leaf_sd) + 4 * C * M * S + 4 * C * PCOLS)
    # per row, particle and level as the growth round; per row and sweep the
    # refinement's gather, difference, square, weight, add
    ops = B * DEPTH * C * P * N * 7 + B * C * (R + 2) * N * 5
    b_ms, by = bound(bts, ops)
    b_pre, by_pre = bound(bts + nbytes(r_pre.rg), ops)
    plan = fused_plan(case)
    out["pgbart_step_fused"] = dict(
        bound_ms=b_ms, bound_by=by, bytes=bts, generated=True,
        pre_drawn=dict(
            bound_ms=b_pre, bound_by=by_pre, bytes=bts + nbytes(r_pre.rg),
            ms=cuda_ms(lambda: fused_step(case, st_k, r_pre, False,
                                          "kernel"))[0]),
        plan=dict(form=plan.form, cluster=plan.cluster,
                  particles_per_block=plan.per_block,
                  warps_per_particle=plan.warps, x_staged=plan.x_staged,
                  smem_bytes=plan.smem),
        **timed(lambda: fused_step(case, st_k, r_gen, False, "kernel"),
                lambda: fused_step(case, st_p, r_pre, False, "plain")))

    # the same kernel on the logistic data, at the p=1000 width, with 19
    # particles and in the global form
    for key, name in (("bernoulli_ms", "bernoulli"),
                      ("p1000_n200_ms", "gauss_p1000"),
                      ("p19_ms", "gauss_p19"),
                      ("global_form_n16384_c2_p10_ms", "gauss_global")):
        other = fused_case(dev, name)
        st_o = grown_state(other, gen, dev)
        rands_o = fused_rands(other, gen, False, dev, row_gumbels=False)
        out["pgbart_step_fused"][key] = cuda_ms(
            lambda: fused_step(other, st_o, rands_o, False, "kernel"))[0]

    out["pgbart_step_bign"], crossover = time_bign(dev, gen, bound, timed)

    # one whole PGBART step (B = 5 trees) on each route, host clock + sync
    pg = PgbartConfig(num_particles=P, num_refinements=R)
    X_np, Y_np, _ = friedman(N, PCOLS)
    X = torch.from_numpy(X_np).to(dev)
    Y = torch.from_numpy(Y_np).to(dev)[:, None]
    rules = torch.zeros(PCOLS, dtype=torch.int32, device=dev)
    gauss_w = torch.ones((C, N, 1), device=dev)
    state = pgbart.init_state(X, Y, cfg, chains=C, device=dev)
    step_ms, rands_ms = {}, {}
    for name, kw, reps in (("fused", dict(route="fused"), 12),
                           ("rounds", dict(route="rounds"), 12),
                           ("plain", dict(impl="plain"), 4)):
        times, draws = [], []
        for i in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # as sample() draws them: a seed for the whole-step kernel, the
            # (B, D, C, P, n) Gumbel block for the per-round route
            rands = pgbart.draw_rands(gen, B=5, C=C, P=P, D=DEPTH, n=N, k=1,
                                      S=cfg.n_nodes, num_refinements=R,
                                      device=dev, row_gumbels=name != "fused")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, _ = pgbart.pgbart_step(state, rands, X, Y, rules, cfg, pg,
                                          False, gauss_w, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            draws.append((t1 - t0) * 1e3)
        step_ms[name] = float(np.median(times[2:]))
        rands_ms[name] = float(np.median(draws[2:]))
    rates = {k: v["chain_draws_per_s"] for k, v in (runs or {}).items()}
    emit("timing", card=smi, kernels=out, chain_draws_per_s=rates,
         linear_step=linear_step_times(dev),
         step_ms_fused_route=step_ms["fused"],
         step_ms_kernel_route=step_ms["rounds"],
         step_ms_plain_route=step_ms["plain"],
         draw_rands_ms=rands_ms["fused"],
         draw_rands_with_block_ms=rands_ms["rounds"],
         large_n_crossover=crossover,
         launches_per_step={"pgbart_step_fused": 1, "grow_round": 5 * DEPTH,
                            "smc_resample": 5 * (DEPTH - 1),
                            "select_refine": "5 (constant), 0 (linear, mix)",
                            "pgbart_step_bign": 1})
    check_crossover(crossover)
    return out


def linear_step_times(dev, reps=12, profiled=5):
    """One PGBART step of the linear Friedman model at full width as
    ``sample()`` issues it on the per-round route (blocks drawn with a seed,
    the step enqueued, host clock around a synchronisation), and the device
    busy time of a step (``torch.profiler``, kernels and copies), so that
    the host's share is what is left."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
    from pymc_bart_tpu_torch.sampler import pgbart

    cfg = BartConfig(m=M, max_depth=DEPTH, response="linear")
    pg = PgbartConfig(num_particles=P, num_refinements=R)
    X_np, Y_np, _ = friedman(N, PCOLS, seed=6)
    X = torch.from_numpy(X_np).to(dev)
    Y = torch.from_numpy(Y_np).to(dev)[:, None]
    rules = torch.zeros(PCOLS, dtype=torch.int32, device=dev)
    gauss_w = torch.ones((C, N, 1), device=dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    state = pgbart.init_state(X, Y, cfg, chains=C, device=dev)

    def step():
        nonlocal state
        rands = pgbart.draw_rands(
            gen, B=pg.batch_size(M, False), C=C, P=P, D=DEPTH, n=N, k=1,
            S=cfg.n_nodes, num_refinements=R, device=dev, row_gumbels=False,
            response="linear")
        state, _ = pgbart.pgbart_step(state, rands, X, Y, rules, cfg, pg,
                                      False, gauss_w, w_scalar=True)

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            step()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0 and e.device_type == DeviceType.CUDA:
            rows.append((dev_us / 1e3 / profiled, e.count // profiled,
                         e.key[:60]))
    rows.sort(reverse=True)
    step_ms = float(np.median(times[2:]))
    device_ms = sum(r[0] for r in rows)
    return dict(step_ms=step_ms, device_ms=device_ms,
                host_ms=step_ms - device_ms,
                device_share=device_ms / step_ms,
                device_events_per_step=sum(r[1] for r in rows),
                top=[dict(ms=r[0], count=r[1], name=r[2]) for r in rows[:8]])


def bign_bytes(case, rands, state, tuning):
    """``(io_bytes, pass_bytes, ops)`` of one large-n step.

    ``io_bytes``: every input of the FUNCTION read once and every output
    written once: X, y, the precision or row data, the random blocks (the row
    Gumbels only when pre-drawn), per updated tree the four forest rows and
    the ``tree_pred`` row read and written, ``sum_trees`` (and the Welford
    buffers while tuning) read and written, ``alpha_vec``, ``leaf_sd``, the
    forest's split variables for the histogram, the histogram.
    ``pass_bytes``: what the row passes move when every particle has an
    active node on every level: per tree the residual pass (sum_trees,
    tree_pred, y read; noi, resid written) and the row set-up (li written);
    per level li read and written by pass 1 (plus the Gumbel row when
    pre-drawn), li, one X column and resid read by pass 2, li read and
    written and one X column read by pass 3; the final pass (winner's li,
    noi read; tree_pred, sum_trees written).  The row regime adds the
    prediction row wherever li moves, and noi, y and the row data in pass 3.
    ``ops``: float operations per row, particle and level (compare, square,
    two float64 adds, routing compare, two logarithms of the Gumbel; the row
    regime's closed form on top)."""
    cfg, pg = case["cfg"], case["pg"]
    Cc, Pp, m, S, D = (case["chains"], pg.num_particles, cfg.m, cfg.n_nodes,
                       cfg.max_depth)
    n, p = case["X"].shape
    B = pg.batch_size(m, tuning)
    rowll = case["lik"] != "gauss"
    io = (nbytes(case["X"], case["Y"], case["w_chain"], case["llw"],
                 *(getattr(rands, f) for f in
                   ("ug", "uv", "rg", "eps", "ures", "usel", "epsr", "uacc",
                    "seed")), state.alpha_vec, state.leaf_sd)
          + 4 * Cc * B * (2 * 4 * S + 2 * n) + 4 * 2 * Cc * n
          + (4 * 4 * Cc * n * B if tuning else 0)
          + 4 * Cc * m * S + 4 * Cc * p)
    CPn, Cn = Cc * Pp * n, Cc * n
    row_state = 2 if rowll else 1          # li, and the prediction row
    per_level = (2 * CPn * row_state + (CPn if rands.rg is not None else 0)
                 + CPn + CPn + Cn
                 + 2 * CPn * row_state + CPn + (3 * Cn if rowll else 0))
    per_tree = (5 * Cn + CPn * row_state + D * per_level + 4 * Cn)
    ops = B * D * CPn * (20 if rowll else 8)
    return io, 4 * B * per_tree, ops


def time_bign(dev, gen, bound, timed):
    """Times of the large-n kernel at n = 50,000 (gauss: the entry of the
    ``kernels`` line; bernoulli beside it) and the crossover table against
    the whole-step kernel."""
    from pymc_bart_tpu_torch.ops.bign import launches_per_step
    from pymc_bart_tpu_torch.sampler.pgbart import resolve_route

    entry = {}
    for name in ("gauss_draw", "bernoulli"):
        case = bign_case(dev, name)
        st_k = bign_grown_state(case, gen, dev)
        st_p = st_k.clone()
        r_gen = bign_rands(case, gen, False, dev, row_gumbels=False)
        r_pre = bign_rands(case, gen, False, dev)
        io, passes, ops = bign_bytes(case, r_gen, st_k, False)
        b_ms, by = bound(io, ops)
        t = dict(bound_ms=b_ms, bound_by=by, io_bytes=io, pass_bytes=passes,
                 pass_bound_ms=passes / HBM_BYTES_PER_S * 1e3,
                 **timed(lambda: bign_step(case, st_k, r_gen, False, "kernel"),
                         lambda: bign_step(case, st_p, r_pre, False, "plain")))
        t["pre_drawn_ms"] = cuda_ms(
            lambda: bign_step(case, st_k, r_pre, False, "kernel"))[0]
        t["cuda_kernels_per_step"] = launches_per_step(
            case["pg"].batch_size(case["cfg"].m, False), case["cfg"].max_depth)
        # one step as the main path issues it: blocks drawn, step enqueued,
        # host clock around a synchronisation
        times = []
        for _ in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bign_step(case, st_k, bign_rands(case, gen, False, dev, False),
                      False, "kernel")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        t["step_ms_with_draw_rands"] = float(np.median(times[2:]))
        if name == "gauss_draw":
            entry = dict(t, shapes=dict(LN, lik="gauss", generated=True))
        else:
            entry["bernoulli"] = t
        del st_k, st_p, r_pre

    def cross(name, n, lik, row):
        """Device ms of one draw step on both kernels, generated Gumbels."""
        case = bign_case(dev, name, n=n)
        st_b = bign_grown_state(case, gen, dev)
        st_f = st_b.clone()
        r_gen = bign_rands(case, gen, False, dev, row_gumbels=False)
        iters = 20 if n <= 16384 else 5
        row[f"{lik}_bign_ms"] = cuda_ms(
            lambda: bign_step(case, st_b, r_gen, False, "kernel"),
            iters=iters)[0]
        row[f"{lik}_fused_ms"] = cuda_ms(
            lambda: fused_step(case, st_f, r_gen, False, "kernel"),
            iters=iters)[0]
        row[f"{lik}_fused_form"] = fused_plan(case).form
        row[f"{lik}_route"] = resolve_route(
            None, case["cfg"], case["pg"], case["X"], case["row"], lik,
            chains=case["chains"], w_scalar=True, all_cont=True,
            x_nan=False)[0]

    table = []
    for n in (1000, 2000, 4000, 8192, 16384, 32768, 50_000, 200_000):
        row = dict(n=n)
        for lik, name in (("gauss", "gauss_draw"), ("bernoulli", "bernoulli")):
            cross(name, n, lik, row)
        table.append(row)
    # the same at the n=1000 models' shapes (P=20, m=50: B=5 trees a step,
    # 5 refinements), where the rows leave shared memory earlier
    wide = []
    for n in (1000, 4000, 6000, 8192, 16384, 50_000):
        row = dict(n=n)
        cross("gauss_n1000", n, "gauss", row)
        wide.append(row)
    torch.cuda.synchronize()
    return entry, dict(rule="route=None takes the large-n kernel where the "
                       "whole-step kernel's form is global", C=LN["C"],
                       P=LN["P"], m=LN["M"], rows=table,
                       rows_at_p20_m50=dict(C=LN["C"], P=P, m=M, rows=wide))


def check_crossover(crossover, slack=1.15):
    """The route ``pgbart_step(route=None)`` takes must be what the crossover
    table supports: at every measured shape the kernel of the route taken is
    the faster of the two, or within ``slack`` of the other (at the crossover
    itself the two are close and either will do).  The n=1000 models must
    stay on the whole-step kernel, the n=50,000 models on the large-n one."""
    rows = crossover["rows"] + crossover["rows_at_p20_m50"]["rows"]
    for row in rows:
        for lik in ("gauss", "bernoulli"):
            if f"{lik}_route" not in row:
                continue
            taken = row[f"{lik}_route"]
            other = "fused" if taken == "bign" else "bign"
            if row[f"{lik}_{taken}_ms"] > slack * row[f"{lik}_{other}_ms"]:
                raise AssertionError(
                    f"route=None takes {taken!r} at n={row['n']} ({lik}), "
                    f"but the other kernel is the faster one: {row}")
            want = {1000: "fused", 50_000: "bign"}.get(row["n"], taken)
            if taken != want:
                raise AssertionError(
                    f"route=None takes {taken!r} at n={row['n']}: {row}")


def phase_profile(dev, steps=20):
    """Device busy share and device time by kernel over ``steps`` draw steps
    (after a warm-up run), for the Friedman model (PGBART + NUTS) and the
    logistic model (PGBART alone) at n=1000 on the fused route and at
    n=50,000 on the large-n route."""
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

    def run(model, tune, draws, large):
        with pmb.Model():
            model()
            if large:    # sample() takes the large-n route by itself
                pmb.sample(tune=tune, draws=draws, chains=LN["C"],
                           random_seed=1, num_particles=LN["P"],
                           num_refinements=0, store_trees=False,
                           convergence_checks=False)
            else:
                pmb.sample(tune=tune, draws=draws, chains=C, random_seed=1,
                           num_particles=P, num_refinements=R,
                           convergence_checks=False, pgbart_route="fused")
        torch.cuda.synchronize()

    Xb, Yb, _ = friedman(LN["N"], LN["PCOLS"], seed=5)
    Xc, Yc = logistic(LN["N"], LN["PCOLS"], seed=7)

    def large_regression():
        mu = pmb.BART("mu", Xb, Yb, m=LN["M"])
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Yb)

    def large_classifier():
        lo = pmb.BART("lo", Xc, Yc, m=LN["M"])
        pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=Yc)

    for name, model in (("friedman", friedman_model),
                        ("logistic", logistic_model),
                        ("large_n_regression", large_regression),
                        ("large_n_classifier", large_classifier)):
        large = name.startswith("large")
        run(model, 5, 5, large)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(model, 0, steps, large)
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
        emit("profile", model=name, route="bign" if large else "fused",
             steps=steps,
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
    ap.add_argument("--large-tune", type=int, default=100,
                    help="tuning steps of the n=50,000 models")
    ap.add_argument("--large-draws", type=int, default=100)
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
        launches, runs = phase_sample(dev, args.tune, args.draws,
                                      args.large_tune, args.large_draws)
    if "timing" in phases:
        times = phase_timing(dev, calls, cfg, smi, runs)
    if "profile" in phases:
        phase_profile(dev)

    if set(ALL_PHASES) <= set(phases):
        kernels = []
        for name in ROUND_KERNELS + ("pgbart_step_fused",
                                     "pgbart_step_bign"):
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
