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
   one-hot and subset columns, linear response, k=2).  Integer outputs must
   be equal; floats within rtol 1e-4 / atol 1e-5 (split values rtol 1e-5 /
   atol 1e-6): the sums are taken in another order.
4. ``step``    one tuning and one draw step of ``pgbart_step`` for 4 chains on
   the kernel route and on ``impl="plain"``, same random blocks.
5. ``sample``  the Friedman model (n=1000, p=10, m=50, max_depth=6, 4 chains,
   20 particles, 5 refinements) through ``sample()`` on the card: finite
   draws, the variable-inclusion recount invariant over the stored forests,
   RMSE against the true f below 1.5.  Kernel launch counts are set to 0
   just before and read just after.
6. ``timing``  CUDA-event times of each kernel and its plain version at the
   main-path shapes: ``ms``/``plain_ms`` with the card's queue kept full
   (device time only), ``call_ms``/``plain_call_ms`` issued to an idle card
   (the host's cost of a call included); the time of one whole step; the
   least time the card could take (bytes over 3.35 TB/s, operations over
   67 TFLOP/s fp32).

``--phases ...,profile`` adds a ``torch.profiler`` pass over a short
``sample()`` run: device busy share and the device time by kernel name.

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
}
SOURCES = {
    "grow_round": "pymc_bart_tpu_torch/csrc/grow.cu",
    "smc_resample": "pymc_bart_tpu_torch/csrc/smc.cu",
    "select_refine": "pymc_bart_tpu_torch/csrc/select.cu",
}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def friedman(n, p, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    f = (10 * np.sin(np.pi * X[:, 0] * X[:, 1])
         + 20 * (X[:, 2] - 0.5) ** 2 + 10 * X[:, 3] + 5 * X[:, 4])
    Y = (f + rng.normal(0, 1.0, n)).astype(np.float32)
    return X, Y, f


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
    emit("kernels", max_abs_err=errs, grow_mixed_max_abs_err=mixed_err,
         grown_nodes=grown, smc_calls_that_resampled=resampled,
         tolerance={"integers": "equal", "split_val": "rtol 1e-5 atol 1e-6",
                    "other floats": "rtol 1e-4 atol 1e-5"},
         shapes=dict(C=C, P=P, n=N, p=PCOLS, S=cfg.n_nodes))
    return errs


STATE_TOL = {  # field: (rtol, atol); None = exactly equal
    "split_var": None, "split_set": None, "count": None, "iteration": None,
    "batch_offset": None, "split_val": (1e-5, 1e-6), "leaf": (1e-4, 1e-5),
    "slope": (1e-4, 1e-5), "sum_trees": (1e-4, 1e-4),
    "tree_pred": (1e-4, 1e-4), "alpha_vec": (1e-6, 1e-6),
    "leaf_sd": (1e-5, 1e-6), "wf_count": (0.0, 0.0), "wf_mean": (1e-4, 1e-5),
    "wf_m2": (1e-3, 1e-5),
}


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
    s_kernel = pgbart.init_state(X, Y, cfg, chains=C, device=dev)
    s_plain = s_kernel.clone()
    worst = 0.0
    for tuning in (True, False):
        rands = pgbart.draw_rands(
            gen, B=pg.batch_size(M, tuning), C=C, P=P, D=DEPTH, n=N, k=1,
            S=cfg.n_nodes, num_refinements=R, device=dev)
        s_kernel, vi_k = pgbart.pgbart_step(s_kernel, rands, X, Y, rules, cfg,
                                            pg, tuning, gauss_w)
        s_plain, vi_p = pgbart.pgbart_step(s_plain, rands, X, Y, rules, cfg,
                                           pg, tuning, gauss_w, impl="plain")
        torch.cuda.synchronize()
        check_close("step vi", vi_k, vi_p, 0.0, 0.0)
        for name, tol in STATE_TOL.items():
            holder = (s_kernel, s_plain) if hasattr(s_kernel, name) else (
                s_kernel.forest, s_plain.forest)
            ta, tb = (getattr(h, name) for h in holder)
            if tol is None:
                check_close(f"step {name}", ta, tb, 0.0, 0.0)
            else:
                worst = max(worst, check_close(f"step {name}", ta, tb, *tol))
    splits = int((s_kernel.forest.split_var >= 0).sum())
    if splits == 0:
        raise AssertionError("two steps grew no split at all")
    emit("step", max_abs_err=worst, split_nodes=splits, chains=C)


def phase_sample(dev, tune, draws):
    import pymc_bart_tpu_torch as pmb
    from pymc_bart_tpu_torch.ops.grow import grow_round
    from pymc_bart_tpu_torch.ops.select import select_refine
    from pymc_bart_tpu_torch.ops.smc import smc_resample

    X, Y, f_true = friedman(N, PCOLS)
    wrappers = {"grow_round": grow_round, "smc_resample": smc_resample,
                "select_refine": select_refine}
    timings = {}
    with pmb.Model():
        mu = pmb.BART("mu", X, Y, m=M, max_depth=DEPTH)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        idata = pmb.sample(tune=tune, draws=draws, chains=C, random_seed=0,
                           num_particles=P, num_refinements=R,
                           chunk_size=max(1, draws // 2), timings=timings,
                           convergence_checks=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: int(w.launches) for k, w in wrappers.items()}
    steps = tune + draws
    B = 5
    want = {"grow_round": steps * B * DEPTH,
            "smc_resample": steps * B * (DEPTH - 1),
            "select_refine": steps * B}
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"the main path never launched {k}")
        if v != want[k]:
            raise AssertionError(f"{k}: {v} launches, expected {want[k]}")
    post = np.asarray(idata.posterior["mu"].values)
    sig = np.asarray(idata.posterior["sigma"].values)
    if post.shape != (C, draws, N) or sig.shape != (C, draws):
        raise AssertionError(f"posterior shapes {post.shape} {sig.shape}")
    if not (np.isfinite(post).all() and np.isfinite(sig).all()):
        raise AssertionError("non-finite posterior draws")
    vi = np.asarray(idata["sample_stats"]["variable_inclusion"].values)
    sv = mu.all_trees.split_var
    if sv.shape != (C, draws, M, 2 ** (DEPTH + 1) - 1):
        raise AssertionError(f"stored forests have shape {sv.shape}")
    recount = np.stack([(sv == j).sum(axis=(2, 3)) for j in range(PCOLS)],
                       axis=-1)
    if not np.array_equal(vi[:, :, 0, :], recount):
        raise AssertionError("variable_inclusion != recount over the forests")
    for c in range(1, C):
        if np.array_equal(post[0], post[c]):
            raise AssertionError(f"chain {c} repeats chain 0")
    rmse = float(np.sqrt(np.mean((post.mean(axis=(0, 1)) - f_true) ** 2)))
    if not rmse < RMSE_BOUND:
        raise AssertionError(f"rmse vs true f {rmse} >= {RMSE_BOUND}")
    emit("sample", tune=tune, draws=draws, chains=C, seconds=seconds,
         tune_seconds=timings["tune_seconds"],
         draw_seconds_total=timings["draw_seconds_total"],
         chain_draws_per_s=C * draws / timings["draw_seconds_total"],
         rmse_vs_true_f=rmse, sigma_mean=float(sig.mean()),
         vi_top5=np.argsort(vi.sum(axis=(0, 1))[0])[::-1][:5].tolist(),
         launches=launches)
    return launches


def phase_timing(dev, calls, cfg, smi):
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

    # one whole PGBART step (B = 5 trees), kernel route, host clock + sync
    pg = PgbartConfig(num_particles=P, num_refinements=R)
    X_np, Y_np, _ = friedman(N, PCOLS)
    X = torch.from_numpy(X_np).to(dev)
    Y = torch.from_numpy(Y_np).to(dev)[:, None]
    rules = torch.zeros(PCOLS, dtype=torch.int32, device=dev)
    gauss_w = torch.ones((C, N, 1), device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    state = pgbart.init_state(X, Y, cfg, chains=C, device=dev)
    step_ms, rands_ms = {}, []
    for impl in ("kernel", "plain"):
        times = []
        for i in range(12 if impl == "kernel" else 4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rands = pgbart.draw_rands(gen, B=5, C=C, P=P, D=DEPTH, n=N, k=1,
                                      S=cfg.n_nodes, num_refinements=R,
                                      device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, _ = pgbart.pgbart_step(state, rands, X, Y, rules, cfg, pg,
                                          False, gauss_w, impl=impl)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            rands_ms.append((t1 - t0) * 1e3)
        step_ms[impl] = float(np.median(times[2:]))
    emit("timing", card=smi, kernels=out, step_ms_kernel_route=step_ms["kernel"],
         step_ms_plain_route=step_ms["plain"],
         draw_rands_ms=float(np.median(rands_ms[2:])),
         launches_per_step={"grow_round": 5 * DEPTH,
                            "smc_resample": 5 * (DEPTH - 1),
                            "select_refine": 5})
    return out


def phase_profile(dev, steps=20):
    """Device busy share and device time by kernel over ``steps`` draw steps
    of the Friedman model (after a warm-up run)."""
    import pymc_bart_tpu_torch as pmb
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    X, Y, _ = friedman(N, PCOLS)

    def run(tune, draws):
        with pmb.Model():
            mu = pmb.BART("mu", X, Y, m=M, max_depth=DEPTH)
            sigma = pmb.HalfNormal("sigma", 1.0)
            pmb.Normal("y", mu, sigma, observed=Y)
            pmb.sample(tune=tune, draws=draws, chains=C, random_seed=1,
                       num_particles=P, num_refinements=R,
                       convergence_checks=False)
        torch.cuda.synchronize()

    run(5, 5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(0, steps)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        # kernels and copies only: an operator's row repeats its kernels' time
        if dev_us > 0 and e.device_type == DeviceType.CUDA:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    emit("profile", steps=steps, wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / wall_ms,
         device_events=sum(r[1] for r in rows),
         top=[dict(ms=r[0], count=r[1], name=r[2][:80]) for r in rows[:15]])


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
    errs = launches = times = None
    if "kernels" in phases:
        errs = phase_kernels(dev, calls, cfg)
    if "step" in phases:
        phase_step(dev)
    if "sample" in phases:
        launches = phase_sample(dev, args.tune, args.draws)
    if "timing" in phases:
        times = phase_timing(dev, calls, cfg, smi)
    if "profile" in phases:
        phase_profile(dev)

    if set(ALL_PHASES) <= set(phases):
        kernels = []
        for name in ("grow_round", "smc_resample", "select_refine"):
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
