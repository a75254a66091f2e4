"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases device,build,kernels,step,sample,models,
                                    generic,interpret,aids,linlik,mesh,
                                    examples,timing]
                          [--ptxas] [--tune N] [--draws N]
                          [--large-tune N] [--large-draws N]
                          [--model-tune N] [--model-draws N]

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
   in global memory (n=120,000), and the growth rounds and resampling steps
   of one tree update of each model of phase ``generic`` on its own inputs
   from three seeds: the joint heteroscedastic model (constant response,
   k=2, n=500, p=2, m=30, 10 particles, the generic likelihood's zero row
   weights) and the coal model (k=1, n=56, p=1, m=20, 10 particles, Poisson
   log-likelihoods), every output bit for bit, where at least one resampling
   call of each model must resample; likewise one tree update of the linear
   logistic forest of phase ``linlik`` (m=50, 20 particles, n=1000, p=10,
   zero row weights, the linear statistics) from three seeds.  The
   resampling steps of the main path's tree update bit for bit.
   The selection kernel ``select_refine``
   against its plain version with every output equal bit for bit: the
   selection of one tree update for the constant, linear and mix responses
   from three seeds each (the constant ones with accepted and rejected
   sweeps among them, which the phase checks), the linear and mix ones also
   with a tenth of X NaN, a root-only winner and two tied particles, and a
   linear one at n=50,000 (its rows in global memory).  The whole-step kernel
   ``pgbart_step_fused`` runs two consecutive steps from a grown state
   against its plain version, same random blocks: at the main shapes (m=50)
   for gauss with tuning on and off, bernoulli, het_abs (with one growth
   target a chain, as a scale forest has it), het_exp and cat_logit, at
   p=1000 (n=200), on a small mixed case (NaNs, one-hot and
   subset columns), with a hundredth of the precision (the ESS gate falls
   both ways), with 19 particles (an idle slot in the cluster), at p=5000
   (the split-weight CDF stays in global memory), at n=16,384 and at depth
   11 (the form that keeps the per-particle state in global memory, because
   the rows or the node arrays do not fit; the phase prints the plan of
   every case and fails if a case runs with another than it names), and on
   the inputs phase ``models`` gives it (n=500, m=30, P=10): the
   heteroscedastic model's mean forest (gauss with a precision
   1/(|w1| + 0.05)^2 that varies row by row, p=2), its scale forest
   (het_abs, one target a chain, p=2) and a class forest of the
   Categorical model (cat_logit, p=4, k=3), each from three seeds.  Then its generated-Gumbel mode in both forms:
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
   same random blocks; the logistic classifier's draw step on the per-round
   route (growth and resampling kernels, the winner and refinement in plain
   PyTorch as the JAX package runs them in XLA) against ``impl="plain"``; a
   linear forest's two steps on the per-round route (which ``route=None``
   must choose) against ``impl="plain"``.  Then one step at
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
   ``pgbart_route=None``: the per-round route's warning, 30 growth, 25
   resampling and 5 selection launches a step and nothing else, no call of
   ``select_refine_linear``, RMSE below 1.5 (linear), and the stored slopes,
   with the forests, predict the last draw; the logistic classifier at depth
   12 (both whole-step gates refuse it) with ``pgbart_route=None``: the
   per-round route, its winner and refinement in plain PyTorch (accuracy and
   log-likelihood as below).  Then the two large-n models at
   full width (4 chains, 10 particles, m=20, n=50,000, p=10, no
   refinements, route chosen by ``sample()`` itself): the Friedman regression
   (RMSE against the true f below half of std(f), the recount invariant) and
   the logistic classifier (``store_trees=False``; accuracy and
   log-likelihood as above), on the large-n route with generated Gumbels.
   Kernel launch counts are set to 0 just before each run and read just
   after: a fused run launches the whole-step kernel once a step and none
   of the others, a per-round run the three round kernels (a classifier the
   growth and resampling kernels only), a large-n run
   the large-n kernel once a step and none of the others.  No run may draw
   the (B, D, C, P, n) row-Gumbel block: every route works from a seed.
6. ``models``  the separate-trees models and rejuvenation through
   ``sample()``: the heteroscedastic model of ``bench.py`` (n=500, two
   forests of m=30, 4 chains, ``ancestor_sampling``; 200/200 steps by
   default): both forests must run on the whole-step kernel (2 launches a
   step, nothing else), ``corr_mean_output`` at least 0.8, and
   ``scale_hi_over_lo`` printed; its posterior predictions on 200 new rows
   after ``set_data`` (shapes, finite, the mean y against the mean w[0]); a
   separate-trees Categorical model (k=3, cat_logit on the whole-step kernel,
   3 launches a step, accuracy above the majority rate); the large-n
   regression without and with ``ancestor_sampling`` from one seed and
   budget (the large-n kernel once a step; rmse, sigma and step time of
   both); one rejuvenation sweep at the large-n shapes on the card against
   the CPU from the same state and numbers (trees equal, leaves within 1e-6),
   its host time, device time and CUDA kernels (``torch.profiler``), and a
   step's time with and without it on the large-n route and at the
   heteroscedastic shapes.  The phase prints the launch counts of each run
   in its own line; the kernels line counts phase ``sample``'s.
7. ``generic`` the generic model likelihood through ``sample()`` with
   ``pgbart_route=None``: the joint heteroscedastic model of ``bench.py``
   (``config_het_joint``: ONE forest of m=30 with two leaf values a node,
   ``Normal(w[0], |w[1]| + 0.05)``, n=500, 4 chains, 10 particles; 200/200
   steps) and the coal-mining model of
   ``examples/coal_disasters.py`` (``Poisson(exp(BART) x exposure)``, 56
   bins, m=20, 4 chains; 300/300): both on the per-round route with its
   warning, ``grow.cu`` D and ``smc.cu`` D-1 launches a tree and no other
   kernel, finite draws, ``corr_mean_output`` at least 0.8 with
   ``scale_hi_over_lo`` printed, the coal rate before 1890 over the rate
   after 1900 above 2; chain-draws/s, and each model's device busy share
   of a draw step (``torch.profiler``).  Its launch counts stand in its own
   line.
8. ``interpret`` the interpretability suite on phase ``sample``'s Friedman
   forests (m=50, 4 chains): partial dependence of all ten covariates, ICE
   of all ten and ``compute_variable_importance(method="VI")`` timed on the
   card, equal to the CPU port's on the same forests and seeds (rtol 1e-5;
   on both sides the ICE of the first two covariates with 10 instances and
   20 draws and a VI run on 200 rows with 10 draws), the five active covariates ranked first, the full
   submodel's mean R^2 at least 0.9 and within the band of the full model's
   R^2 against itself; no matplotlib imported.
9. ``aids``    checkpoint / resume and the debug aids of ``sample()`` on the
   Friedman main path at full width (4 chains, 20 particles, m=50, depth 6,
   n=1000, p=10, fused route; 60 tuning and 60 draw steps in chunks of 15):
   two runs with ``checkpoint_dir`` from one seed agree bit for bit, and
   with a run that saves nothing; a run stopped once its checkpoint after
   half the draws is written (step 90) and resumed equals the uninterrupted
   run bit for bit (posterior, sample stats, stored forests); the seconds
   and bytes of a checkpoint and the draw rate with and without
   checkpointing.  The same resume check on the n=50,000 regression on the
   large-n route (10/10 steps, chunks of 5).  ``posterior_dtype`` float16
   and bfloat16 within 1e-2 of the float32 run relative to its largest
   value, the sample stats unchanged, the bytes drained by each;
   ``debug_nans`` gives the same bits as the run without it (its draw rate
   beside those of two runs without an aid, before and after the aids'
   runs), and a model whose target holds a NaN raises
   ``FloatingPointError`` (the phase fails if it does not); ``profile_dir``
   writes a Chrome trace that names ``draw.cu``'s kernel once a step.  The
   launch counts of each run are checked (fused: one a step; large-n: one a
   step; resumed: the remaining steps only) and printed in its own line.
10. ``linlik`` the linear and mix responses under the non-Gaussian
   likelihoods through ``sample()`` with ``pgbart_route=None``: the logistic
   classifier of phase ``sample`` with ``response="linear"`` (75/75 steps)
   and a ``mix`` run (25/25): the per-round route with its warning,
   ``grow.cu`` 30 and ``smc.cu`` 25 launches a step, ``select.cu`` none and
   nothing else, accuracy above the majority rate, mean log-likelihood above
   the constant-rate model's, the stored slopes and forests predict the last
   draw, and the linear classifier's device busy share of a draw step
   (``torch.profiler``); the coal model with ``response="linear"`` (the
   generic Poisson likelihood, 200/200): ``grow.cu`` D and ``smc.cu`` D-1
   launches a tree,
   the rate before 1890 over the rate after 1900 above 2; a model of
   tests/test_categorical.py's kind at n=1000 (a Subset column of 48
   categories, a OneHot column, a continuous column a tenth NaN; m=50,
   100/100): ``draw.cu`` once a step, the category groups' gap above 3, the
   Subset column first in the variable inclusion.
11. ``mesh``    ``sample(mesh=...)`` over two ranks that share the card
   (gloo, spawned processes, ``parallel.mesh.run_local_world`` with a
   900 s limit; every rank's failure fails the phase).  First ``draw.cu``
   and ``bign.cu`` on chains 2 and 3 of 4 (``StepRands.shard``: the global
   chain offset of the generated row Gumbels) equal bit for bit the same
   kernel's chains 2 and 3 of one launch for all four and the plain version
   on the block written out for those chains.  Then (a) the Friedman main
   path (n=1000, p=10, m=50, 20 particles, 4 chains, 60/60) with chains over
   the ranks on ``draw.cu`` and (b) ``config_large_n`` (n=50,000, m=20, 10
   particles, 20/20) on ``bign.cu``: every rank's posterior, sample stats
   and stored forests equal bit for bit the one-process run's in this
   process, one launch a step on every rank, chain-draws/s of both; (c)
   ``config_large_n`` with rows over the ranks: three node-space steps on
   25,000 rows a rank equal in structure and counts to the unsharded ones
   (float errors printed), and ``sample()`` at 100/100 on the per-round
   route (``smc.cu`` only, plain node-space growth) with rmse against the
   true f below half of std(f), its step time and all-reduces a step.
12. ``examples`` the six examples of ``examples/port/`` (seven entries) at
   their own budgets through their entries with ``device=None``: each
   example's kernels launched exactly as its steps ask (``draw.cu`` once a
   step and forest for Friedman, out-of-sample, binary, categorical (three
   forests), heteroscedastic (two) and high-dim; ``grow.cu`` D and ``smc.cu``
   D-1 times a tree for coal) and no other, no plain version of a kernel
   called (coal's winner and refinement are plain PyTorch by design, as in
   JAX's XLA), and each example's check: coal's early over late rate above
   2, Friedman rmse below 1.5, the classifiers' accuracy above their
   majority rates, heteroscedastic ``corr_mean_output`` at least 0.8, the
   five active columns the high-dim top five, out-of-sample rmse below
   half of std(f_test).  Chain-draws/s and seconds of each; the high-dim
   example's PDP / ICE seconds, and its plots' computations through the
   shared continuous-only descent rule against the full ``decide_left``
   in turns (equal bit for bit).
13. ``timing``  CUDA-event times of each kernel and its plain version at the
   main-path shapes (the growth round and the selection for the constant and
   the linear response): ``ms``/``plain_ms`` with the card's queue kept full
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

``--phases device,build,parity`` (not in the default run): the nine models
of ``bench.py`` (``config_friedman`` ... ``config_het_joint``) through
``sample()`` at the bench's budgets and settings (4 chains,
``posterior_dtype="float16"``, ``chunk_size`` a quarter of the draws, the
rows' particles, batch, split-prior decay, refinements, ``ancestor_sampling``
and ``store_trees``), data from copies of the bench's generators, quality
as the bench's ``quality`` functions (and sigma of large-n regression, and
bench.py's R-hat rows), each row held to a band around the JAX package's
record in ``BENCH_FULL.json``: seed 0, seed 1 for a row outside its band;
a row outside at both seeds fails the phase.  One line a row.

``--phases nccl`` (a machine of two cards or more; not in the default run):
``sample(mesh=...)`` launched as a user launches it, ``torchrun`` with one
rank a card and NCCL (``initialize_distributed("env://", ...)``; every rank
on ``cuda:<local rank>``; 600 s limit, the whole process group killed past
it).  (a) the Friedman main path with chains over every card, each rank's
posterior, sample stats and stored forests bit for bit this process's
one-process run on card 0, ``draw.cu`` once a step on every rank; (b)
checkpoint and resume under that mesh, each rank with a checkpoint_dir of
its own (only rank 0's holds files): the resumed run returns the first
run's posterior bit for bit; (c) the Friedman model with rows over two data
shards (every rank the same posterior, rmse against the true f below half
of std(f), all-reduces a step).

Then the ``{"kernels": [...]}`` line, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

ALL_PHASES = ("device", "build", "kernels", "step", "sample", "models",
              "generic", "interpret", "aids", "linlik", "mesh", "examples",
              "timing")
EXTRA_PHASES = ("profile", "nccl", "parity")  # only when asked for by name
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


def main_path_inputs(dev, seed=0, response="constant", warm_impl="plain",
                     n=N):
    """Run one tree's SMC with the PLAIN versions on the card and record the
    arguments of every grow / smc / select call (level by level).  The
    frozen particle is a grown tree: 12 steps first, with ``warm_impl``.
    ``n`` rows of the Friedman data (default the main shapes')."""
    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
    from pymc_bart_tpu_torch.sampler import pgbart

    cfg = BartConfig(m=M, max_depth=DEPTH, response=response)
    pg = PgbartConfig(num_particles=P, num_refinements=R)
    S = cfg.n_nodes
    X_np, Y_np, _ = friedman(n, PCOLS, seed=6 if response != "constant" else 0)
    X = torch.from_numpy(X_np).to(dev)
    Y = torch.from_numpy(Y_np).to(dev)[:, None]
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = pgbart.init_state(X, Y, cfg, chains=C, device=dev)
    rules = torch.zeros(PCOLS, dtype=torch.int32, device=dev)
    gauss_w = torch.ones((C, n, 1), device=dev)
    for _ in range(12):
        rands = pgbart.draw_rands(gen, B=5, C=C, P=P, D=DEPTH, n=n, k=1, S=S,
                                  num_refinements=R, device=dev,
                                  response=response)
        state, _ = pgbart.pgbart_step(state, rands, X, Y, rules, cfg, pg,
                                      True, gauss_w, impl=warm_impl)
    rands = pgbart.draw_rands(gen, B=1, C=C, P=P, D=DEPTH, n=n, k=1, S=S,
                              num_refinements=R, device=dev, response=response)
    return record_tree_update(state, rands, X, Y, rules, cfg, pg, gauss_w), cfg


def record_tree_update(state, rands, X, Y, rules, cfg, pg, gauss_w,
                       **update_kw):
    """Run the SMC of the first tree of ``state``'s batch with the PLAIN
    versions and record the arguments of every grow / smc / select call
    (level by level); ``update_kw`` goes to ``pgbart._update_one_tree``
    (the likelihood)."""
    from pymc_bart_tpu_torch.ops.grow import grow_round_plain
    from pymc_bart_tpu_torch.ops.select import select_refine_plain
    from pymc_bart_tpu_torch.ops.smc import smc_resample_plain
    from pymc_bart_tpu_torch.sampler import pgbart

    dev = X.device
    Cc = state.sum_trees.shape[0]
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
        ar = torch.arange(Cc, device=dev)
        f = state.forest
        tree = type(f)(f.split_var[ar, jt], f.split_val[ar, jt],
                       f.split_set[ar, jt], f.leaf[ar, jt], f.count[ar, jt],
                       f.slope[ar, jt])
        sum_noi = state.sum_trees - state.tree_pred[ar, jt]
        Y = Y.reshape(-1, X.shape[0], cfg.n_outputs)          # (1, n, k)
        pgbart._update_one_tree(0, rands, tree, Y - sum_noi, state.alpha_vec,
                                state.leaf_sd, X, rules, cfg, pg, gauss_w,
                                None, sum_noi=sum_noi, Y=Y, **update_kw)
    finally:
        pgbart.grow_round, pgbart.smc_resample, pgbart.select_refine = saved
    # a Gaussian forest selects through the kernel's wrapper, the others in
    # plain PyTorch
    selects = 1 if update_kw.get("lik", "gauss") == "gauss" else 0
    D = cfg.max_depth
    if (len(calls["grow"]) != D or len(calls["smc"]) != D - 1
            or len(calls["select"]) != selects):
        raise AssertionError("one tree update did not make D growth rounds, "
                             f"D-1 resampling steps and {selects} selection")
    return calls


# the joint heteroscedastic model of bench.py (config_het_joint): one forest,
# two leaf values a node, the generic likelihood Normal(w[0], |w[1]| + 0.05)
HJ = dict(N=500, M=30, P=10, K=2, TUNE=200, DRAWS=200)
# the coal-mining model of examples/coal_disasters.py: Poisson(exp(BART) x
# exposure) over 56 bins, the sampler's default particles and refinements
COAL = dict(M=20, P=10, TUNE=300, DRAWS=300)
GENERIC_SHAPES = {"het_joint": dict(C=C, P=HJ["P"], n=HJ["N"], p=2, k=HJ["K"],
                                    m=HJ["M"]),
                  "coal": dict(C=C, P=COAL["P"], n=56, p=1, k=1, m=COAL["M"])}
GENERIC_MODELS = tuple(GENERIC_SHAPES)


def het_joint_model(X, Y):
    """The model builder of ``config_het_joint`` (``bench.py:453``)."""
    def build(pmb):
        w = pmb.BART("w", X, Y, m=HJ["M"], shape=(2, len(Y)))
        pmb.Normal("y", w[0], pmb.math.abs(w[1]) + 0.05, observed=Y)
        return w
    return build


def coal_model(pmb):
    """The model builder of ``examples/coal_disasters.py``."""
    centers, counts, exposure = coal_data()
    mu = pmb.BART("mu", centers[:, None], np.log1p(counts), m=COAL["M"])
    pmb.Poisson("y", mu=pmb.math.exp(mu) * exposure / exposure.mean(),
                observed=counts)
    return mu


def generic_inputs(dev, seed, name):
    """The growth rounds and resampling steps of one tree update of a
    generic-likelihood model as ``sample()`` gives them to ``grow.cu`` and
    ``smc.cu``, after 12 steps on the plain versions from seed ``seed``:
    ``het_joint`` (constant response, k=2, n=500, p=2, m=30, 10 particles,
    the likelihood's zero row weights) or ``coal`` (k=1, n=56, p=1, m=20,
    10 particles, Poisson log-likelihoods).  Both models have no free
    parameter besides the forest, so theta is empty."""
    import pymc_bart_tpu_torch as pmb
    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
    from pymc_bart_tpu_torch.sampler import compound, pgbart

    if name == "het_joint":
        X_np, Y_np, _ = het_data(HJ["N"])
        build, m, k, parts = het_joint_model(X_np, Y_np), HJ["M"], HJ["K"], HJ
    else:
        centers, counts, _ = coal_data()
        X_np, Y_np = centers[:, None], np.log1p(counts)
        build, m, k, parts = coal_model, COAL["M"], 1, COAL
    with pmb.Model() as model:
        vname = build(pmb).name
    loglik = compound.make_loglik(compound.CompiledModel(model, dev), vname)
    cfg = BartConfig(m=m, max_depth=DEPTH, n_outputs=k)
    pg = PgbartConfig(num_particles=parts["P"], num_refinements=R)
    X = torch.from_numpy(np.asarray(X_np, np.float32)).to(dev)
    Y = torch.from_numpy(np.repeat(np.asarray(Y_np, np.float32)[:, None], k,
                                   1)).to(dev)
    n = X.shape[0]
    rules = torch.zeros(X.shape[1], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = pgbart.init_state(X, Y, cfg, chains=C, device=dev)

    def params():
        return (torch.zeros((C, 0), device=dev),
                {vname: state.sum_trees.clone()})

    def rands(B):
        return pgbart.draw_rands(gen, B=B, C=C, P=parts["P"], D=DEPTH, n=n,
                                 k=k, S=cfg.n_nodes, num_refinements=R,
                                 device=dev)

    for _ in range(12):
        state, _ = pgbart.pgbart_step(
            state, rands(3), X, Y, rules, cfg, pg, True, None, impl="plain",
            lik="generic", route="rounds", loglik_fn=loglik,
            lik_params=params())
    return record_tree_update(
        state, rands(1), X, Y, rules, cfg, pg, None, lik="generic",
        loglik=pgbart.batched_loglik(loglik, params()))


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
               "gauss_flat", "gauss_p19", "gauss_global", "gauss_deep",
               "het_mean", "het_scale", "cat_model")
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
    fit shared memory, so the global form at n=1000).  ``het_mean``,
    ``het_scale`` and ``cat_model``: the inputs of phase ``models``' sampler
    entries at their shapes (n=500, m=30, P=10, the models' data), with the
    row data and targets made by the sampler's own functions from the other
    forests' values, which vary by chain and by row."""
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
        # and the link-aware growth target of the scale; het_abs with one
        # target a chain from each chain's mu0, as sample() gives it
        # (Y (C, n, 1): the kernel's y_stride), het_exp one for all chains
        lik_const = 0.05 if name == "het_abs" else 0.0
        mu0 = Y.mean() + 0.1 * chain_shift
        row = (Y[None, :, None] - mu0) ** 2
        s_hat = (np.abs(Y[None, :, None] - mu0) if name == "het_abs"
                 else np.abs(Y - Y.mean())) / 0.7978845608
        Y = (s_hat - lik_const if name == "het_abs"
             else np.log(np.maximum(s_hat, 1e-3))).astype(np.float32)
    elif name == "cat_logit":
        # one class forest of a 3-class softmax: target +-2, row data the
        # logsumexp of the other two classes' outputs
        labels = (3 * X[:, 0]).astype(np.int64) % 3
        Y = (4.0 * (labels == 0) - 2.0).astype(np.float32)
        others = rng.normal(0.0, 0.5, size=(chains, N, 2))
        row = np.log(np.exp(others).sum(axis=2, keepdims=True))
    elif name in ("het_mean", "het_scale", "cat_model"):
        X, Y, lik, lik_const, row = model_entry_inputs(name, rng, chains)
        cfg = BartConfig(m=30, max_depth=DEPTH)
        pg = PgbartConfig(num_particles=10, num_refinements=R)
    else:
        raise ValueError(name)
    if rules is None:
        rules = np.zeros(X.shape[1], np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    Y = t(Y.astype(np.float32))
    return dict(cfg=cfg, pg=pg, X=t(X), Y=Y[:, None] if Y.dim() == 1 else Y,
                rules=t(rules), lik=lik, lik_const=lik_const, chains=chains,
                row=None if row is None else t(row.astype(np.float32)),
                tunings=tunings)


def model_entry_inputs(name, rng, chains):
    """``(X, Y, lik, lik_const, row)`` of one sampler entry of phase
    ``models`` as ``sample()`` hands them to the kernel: the heteroscedastic
    model's mean forest (``het_mean``: the precision 1/(|w1| + 0.05)^2 of
    the scale forest's values w1) and scale forest (``het_scale``: row data
    and one growth target a chain from the mean forest's values, by
    ``compound.scale_forest_data``), or class forest 1 of the Categorical
    model (``cat_model``: the +-2 target, the other classes' logsumexp by
    ``compound.class_forest_data``).  The other forests' values are drawn
    around the truth, different in every chain and row."""
    from pymc_bart_tpu_torch.sampler.compound import (class_forest_data,
                                                      scale_forest_data)

    if name == "cat_model":
        X, labels, _prob = categorical_data()
        j = 1
        W = torch.from_numpy(rng.normal(0.0, 1.0, size=(chains, len(labels),
                                                        3)).astype(np.float32))
        row = class_forest_data(W, j).numpy()
        Y = (4.0 * (labels == j) - 2.0).astype(np.float32)
        return X, Y, "cat_logit", 0.0, row
    X, y, mu_true = het_data()
    jitter = rng.normal(0.0, 0.1, size=(chains, len(y))).astype(np.float32)
    if name == "het_mean":
        # sigma = |w[1]| + 0.05 and its precision, as sample()'s row data
        w1 = (0.2 + 1.5 * (X[:, 1] > 0)).astype(np.float32) + jitter
        sigma = np.abs(w1) + np.float32(0.05)
        row = (np.float32(1.0) / sigma ** 2)[..., None]
        if not (row.std(axis=1) > 0).all():
            raise AssertionError("het_mean: the precision does not vary "
                                 "over the rows")
        return X, y, "gauss", 0.0, row
    mu0 = torch.from_numpy(mu_true.astype(np.float32) + jitter)
    row, target = scale_forest_data("het_abs", 0.05, torch.from_numpy(y), mu0)
    return X, target.numpy(), "het_abs", 0.05, row.numpy()


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


def initial_target(case):
    """The (n, 1) target the state starts from: chain 0's where a case has
    one a chain."""
    return case["Y"][0] if case["Y"].dim() == 3 else case["Y"]


def grown_state(case, gen, dev, steps=11):
    """A state in which every tree has been updated at least once and the
    ``leaf_sd`` adaptation has begun: ``steps`` tuning steps of the kernel on
    generated Gumbels."""
    from pymc_bart_tpu_torch.sampler import pgbart

    state = pgbart.init_state(case["X"], initial_target(case), case["cfg"],
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
        # as in fused_case: het_abs with one target a chain
        lik_const = 0.05 if name == "het_abs" else 0.0
        mu0 = Y.mean() + 0.1 * chain_shift
        llw = (Y[None, :] - mu0) ** 2
        s_hat = (np.abs(Y[None, :] - mu0) if name == "het_abs"
                 else np.abs(Y - Y.mean())) / 0.7978845608
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
                X=t(X), Y=t(Y)[..., None], lik=lik, lik_const=lik_const,
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

    state = pgbart.init_state(case["X"], initial_target(case), case["cfg"],
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


SELECT_NAMES = {
    False: ("sv", "sl", "st", "lf", "ct", "leaf_idx", "pred"),
    True: ("sv", "sl", "st", "lf", "ct", "sp", "leaf_idx", "pred")}
# rows of a linear selection too many for shared memory: the kernel's form
# that keeps them in global memory (ops/select.py::smem_bytes)
SELECT_ROWS_GLOBAL = 50_000


def check_same(name, got, want):
    """Every entry equal, bit for bit (float32 compared as bit patterns, so
    -0.0 is not +0.0); returns the max abs error, 0."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    g, w = got, want
    if got.dtype == torch.float32:
        g, w = got.view(torch.int32), want.view(torch.int32)
    if not torch.equal(g, w):
        bad = (g != w).nonzero()[0].tolist()
        raise AssertionError(
            f"{name}: {int((g != w).sum())} entries differ, max abs err "
            f"{max_err(got, want)}, first at {bad}: kernel "
            f"{float(got[tuple(bad)])} plain {float(want[tuple(bad)])}")
    return 0.0


def sweep_decisions(a, kw):
    """``(accepted, rejected)``: the Metropolis decisions, over chains and
    sweeps, of one selection call, read off the plain version run with one
    sweep more each time (a sweep accepted where the leaves moved)."""
    from pymc_bart_tpu_torch.ops.select import select_refine_plain

    a = list(a)
    R_ = kw["num_refinements"]
    eps, u_acc = a[10], a[11]

    def leaves(r):
        a[10], a[11] = eps[:, :max(r, 1)], u_acc[:, :max(r, 1)]
        return select_refine_plain(*a, **dict(kw, num_refinements=r))[3]

    prev, taken = leaves(0), []
    for r in range(1, R_ + 1):
        cur = leaves(r)
        taken.append((cur != prev).flatten(1).any(dim=1))
        prev = cur
    taken = torch.stack(taken)
    return int(taken.sum()), int((~taken).sum())


def with_nan_and_root_winner(a, kw, seed=41):
    """A linear / mix selection call made harder: a tenth of X NaN; in chain
    0 particle 1 a root-only tree and the winner; in chain 1 particles 2 and
    5 tied at the top of ``log_w + g_sel`` (the first must win)."""
    a, kw = list(a), dict(kw)
    gen = torch.Generator(device=a[0].device).manual_seed(seed)
    X = kw["X"].clone()
    X[torch.rand(X.shape, generator=gen, device=X.device) < 0.1] = float("nan")
    sv, ct, li, pred = (a[i].clone() for i in (0, 4, 5, 6))
    log_w, g_sel = a[7].clone(), kw["g_sel"].clone()
    n = li.shape[2]
    sv[0, 1] = -1
    ct[0, 1] = 0.0
    ct[0, 1, 0] = float(n)
    li[0, 1] = 0
    pred[0, 1] = a[3][0, 1, :, 0:1]     # the root's leaf value, no slope
    g_sel[0, 1] = 1e4
    log_w[1, 2] = log_w[1, 5] = 0.0
    g_sel[1, 2] = g_sel[1, 5] = 2e4
    a[0], a[4], a[5], a[6], a[7] = sv, ct, li, pred, log_w
    kw.update(X=X, g_sel=g_sel)
    return tuple(a), kw


def compare_select(dev, trajs):
    """``csrc/select.cu`` against its plain version, every output equal bit
    for bit: the selection call of one tree update at the main shapes for
    each response and seed (the constant response's with accepted and
    rejected sweeps among them); for linear and mix also those calls with NaN
    in X, a root-only winner and tied particles; a linear call at
    n=SELECT_ROWS_GLOBAL, whose rows stay in global memory."""
    from pymc_bart_tpu_torch.ops.select import select_refine, smem_bytes

    def compare(tag, a, kw):
        lin = kw.get("response", "constant") != "constant"
        got = select_refine(*a, impl="kernel", **kw)
        torch.cuda.synchronize()
        want = select_refine(*a, impl="plain", **kw)
        torch.cuda.synchronize()
        if len(got) != len(SELECT_NAMES[lin]):
            raise AssertionError(f"select_refine {tag}: {len(got)} outputs")
        return max(check_same(f"select_refine {tag} {name}", g, w)
                   for name, g, w in zip(SELECT_NAMES[lin], got, want))

    out = {}
    for response in GROW_RESPONSES:
        err, acc, rej = 0.0, 0, 0
        for seed in GROW_SEEDS:
            a, kw = trajs[response, seed]["select"][0]
            err = max(err, compare(f"{response} seed {seed}", a, kw))
            n_acc, n_rej = sweep_decisions(a, kw)
            acc, rej = acc + n_acc, rej + n_rej
            if response != "constant":
                a2, kw2 = with_nan_and_root_winner(a, kw)
                err = max(err, compare(f"{response} seed {seed} nan/root",
                                       a2, kw2))
        if response == "constant" and not (acc and rej):
            raise AssertionError(f"constant selection: {acc} sweeps accepted "
                                 f"and {rej} rejected; both are needed")
        out[response] = dict(max_abs_err=err, seeds=list(GROW_SEEDS),
                             sweeps_accepted=acc, sweeps_rejected=rej,
                             nan_x_root_winner_ties=response != "constant")
    big, _ = main_path_inputs(dev, 0, "linear", warm_impl=None,
                              n=SELECT_ROWS_GLOBAL)
    a, kw = big["select"][0]
    S = a[0].shape[2]
    if smem_bytes(S, P, SELECT_ROWS_GLOBAL, True, True) <= 232448:
        raise AssertionError("the large linear selection fits shared memory")
    out[f"linear_n{SELECT_ROWS_GLOBAL}"] = dict(
        max_abs_err=compare(f"linear n={SELECT_ROWS_GLOBAL}", a, kw),
        form="global", sweeps_accepted=sweep_decisions(a, kw)[0])
    return out


def compare_smc(tag, calls):
    """``csrc/smc.cu`` against its plain version on each recorded call,
    every output equal bit for bit.  Returns the max abs error (0) and the
    number of calls that resampled."""
    from pymc_bart_tpu_torch.ops.smc import smc_resample

    err, resampled = 0.0, 0
    for a in calls:
        got = smc_resample(*a, impl="kernel")
        torch.cuda.synchronize()
        want = smc_resample(*a, impl="plain")
        for name, g, w in zip(("log_w", "take", "ll_prev"), got, want):
            err = max(err, check_same(f"smc_resample {tag} {name}", g, w))
        ident = torch.arange(g.shape[1], device=g.device, dtype=torch.int32)
        resampled += int((got[1] != ident).any())
    return err, resampled


def phase_kernels(dev, calls, cfg):
    from pymc_bart_tpu_torch.ops.grow import grow_round

    errs = {"grow_round": 0.0, "smc_resample": 0.0, "select_refine": 0.0}
    grow_cases = {}
    trajs = {}
    for response in GROW_RESPONSES:
        float_errs, grown, slopes = {}, 0, 0
        for seed in GROW_SEEDS:
            # the constant response's first trajectory is the main path's
            # (its smc calls are compared below); the others warm up on the
            # kernels
            traj = (calls if (response, seed) == ("constant", 0) else
                    main_path_inputs(dev, seed, response, warm_impl=None)[0])
            trajs[response, seed] = traj
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

    # grow.cu and smc.cu on the generic-likelihood models' own inputs (the
    # joint heteroscedastic model: k=2, the constant response, zero row
    # weights; coal: Poisson log-likelihoods), bit for bit
    generic_smc = {}
    for name in GENERIC_MODELS:
        g_errs, g_grown, s_err, s_calls, s_resampled = {}, 0, 0.0, 0, 0
        for seed in GROW_SEEDS:
            traj = generic_inputs(dev, seed, name)
            for a, kw in traj["grow"]:
                got = grow_round(*a, impl="kernel", **kw)
                torch.cuda.synchronize()
                want = grow_round(*a, impl="plain", **kw)
                torch.cuda.synchronize()
                compare_grow(f"{name} seed {seed} d={kw['d']}", got, want,
                             g_errs)
                g_grown += int(((got[0] >= 0) & (a[2] < 0)).sum())
            e, r = compare_smc(f"{name} seed {seed}", traj["smc"])
            s_err, s_calls = max(s_err, e), s_calls + len(traj["smc"])
            s_resampled += r
        if any(g_errs.values()) or g_grown == 0:
            raise AssertionError(f"grow_round {name}: errors {g_errs}, "
                                 f"{g_grown} nodes grown")
        if s_resampled == 0:
            raise AssertionError(f"smc_resample {name}: no call resampled")
        grow_cases[name] = dict(
            max_abs_err=g_errs, grown_nodes=g_grown, seeds=list(GROW_SEEDS),
            levels=list(range(DEPTH)), shapes=GENERIC_SHAPES[name])
        generic_smc[name] = dict(max_abs_err=s_err, calls=s_calls,
                                 calls_that_resampled=s_resampled,
                                 seeds=list(GROW_SEEDS))
        errs["grow_round"] = max([errs["grow_round"], *g_errs.values()])
        errs["smc_resample"] = max(errs["smc_resample"], s_err)

    # grow.cu and smc.cu on the linear logistic forest of phase linlik (zero
    # row weights, the linear statistics, Bernoulli log-likelihoods), bit
    # for bit
    g_errs, g_grown, g_slopes, s_err, s_calls, s_resampled = ({}, 0, 0, 0.0,
                                                              0, 0)
    for seed in GROW_SEEDS:
        traj = linear_logistic_inputs(dev, seed)
        for a, kw in traj["grow"]:
            got = grow_round(*a, impl="kernel", **kw)
            torch.cuda.synchronize()
            want = grow_round(*a, impl="plain", **kw)
            torch.cuda.synchronize()
            compare_grow(f"linear logistic seed {seed} d={kw['d']}", got,
                         want, g_errs)
            g_grown += int(((got[0] >= 0) & (a[2] < 0)).sum())
            g_slopes += int(((got[5] != 0) & (a[7] == 0)).sum())
        e, r = compare_smc(f"linear logistic seed {seed}", traj["smc"])
        s_err, s_calls = max(s_err, e), s_calls + len(traj["smc"])
        s_resampled += r
    if any(g_errs.values()) or g_grown == 0 or g_slopes == 0:
        raise AssertionError(f"grow_round linear logistic: errors {g_errs}, "
                             f"{g_grown} nodes grown, {g_slopes} slopes")
    grow_cases["linear_logistic"] = dict(
        max_abs_err=g_errs, grown_nodes=g_grown, slopes_drawn=g_slopes,
        seeds=list(GROW_SEEDS), levels=list(range(DEPTH)),
        shapes=dict(C=C, P=P, n=N, p=PCOLS, k=1, m=M))
    generic_smc["linear_logistic"] = dict(
        max_abs_err=s_err, calls=s_calls, calls_that_resampled=s_resampled,
        seeds=list(GROW_SEEDS))
    errs["smc_resample"] = max(errs["smc_resample"], s_err)

    main_smc_err, resampled = compare_smc("main path", calls["smc"])
    errs["smc_resample"] = max(errs["smc_resample"], main_smc_err)
    select_cases = compare_select(dev, trajs)
    errs["select_refine"] = max(v["max_abs_err"]
                                for v in select_cases.values())
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
         smc_resample_generic_cases=generic_smc,
         select_refine_cases=select_cases,
         pgbart_step_fused_cases=fused,
         pgbart_step_fused_generated=fused_generated,
         pgbart_step_bign_cases=large,
         pgbart_step_bign_generated=generated,
         large_n_shapes=dict(LN, S=2 ** (LN["DEPTH"] + 1) - 1),
         tolerance={"integers": "equal", "split_val": "rtol 1e-5 atol 1e-6",
                    "other floats": "rtol 1e-4 atol 1e-5",
                    "select_refine": "every output equal, bit for bit",
                    "smc_resample": "every output equal, bit for bit",
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
    bernoulli = bernoulli_rounds_step(dev, rands)
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
         bernoulli_rounds=bernoulli, linear=linear,
         large_n=dict(
             n=LN["N"], bign_max_abs_err_vs_plain=large_err,
             fused_split_vars_differing=int(
                 (sf.forest.split_var != sb.forest.split_var).sum()),
             fused_sum_trees_max_abs_diff=max_err(sf.sum_trees, sb.sum_trees)))


def bernoulli_rounds_step(dev, rands):
    """The logistic classifier's draw step on the per-round route: growth and
    resampling kernels, its winner and refinement in plain PyTorch (as the
    JAX package runs them in XLA), against ``impl="plain"`` on the same
    blocks."""
    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
    from pymc_bart_tpu_torch.ops.grow import grow_round
    from pymc_bart_tpu_torch.ops.select import select_refine
    from pymc_bart_tpu_torch.sampler import pgbart

    cfg = BartConfig(m=M, max_depth=DEPTH)
    pg = PgbartConfig(num_particles=P, num_refinements=R)
    Xl, Yl = logistic(N, PCOLS)
    X = torch.from_numpy(Xl).to(dev)
    Y = torch.from_numpy(Yl).to(dev)[:, None]
    rules = torch.zeros(PCOLS, dtype=torch.int32, device=dev)
    first = pgbart.init_state(X, Y, cfg, chains=C, device=dev)
    outs, launches = {}, {}
    for k, impl in (("rounds", None), ("plain", "plain")):
        before = (grow_round.launches, select_refine.launches)
        outs[k] = pgbart.pgbart_step(first.clone(), rands, X, Y, rules, cfg,
                                     pg, False, None, impl=impl,
                                     lik="bernoulli", route="rounds")
        launches[k] = dict(grow_round=grow_round.launches - before[0],
                           select_refine=select_refine.launches - before[1])
    torch.cuda.synchronize()
    B = pg.batch_size(M, False)
    if launches["rounds"] != dict(grow_round=B * DEPTH, select_refine=0) or \
            any(launches["plain"].values()):
        raise AssertionError(f"bernoulli per-round step: launches {launches}")
    check_close("bernoulli rounds vi", outs["rounds"][1], outs["plain"][1],
                0.0, 0.0)
    err = compare_state("bernoulli rounds step", outs["rounds"][0],
                        outs["plain"][0])
    f = outs["rounds"][0].forest
    if not bool((f.split_var >= 0).any()):
        raise AssertionError("the bernoulli per-round step grew no split")
    return dict(max_abs_err_vs_plain=err, launches=launches["rounds"],
                split_nodes=int((f.split_var >= 0).sum()))


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


def kernel_wrappers():
    """The five kernels' wrappers by name (each counts its launches)."""
    from pymc_bart_tpu_torch.ops.bign import pgbart_step_bign
    from pymc_bart_tpu_torch.ops.draw import pgbart_step_fused
    from pymc_bart_tpu_torch.ops.grow import grow_round
    from pymc_bart_tpu_torch.ops.select import select_refine
    from pymc_bart_tpu_torch.ops.smc import smc_resample

    return {"grow_round": grow_round, "smc_resample": smc_resample,
            "select_refine": select_refine,
            "pgbart_step_fused": pgbart_step_fused,
            "pgbart_step_bign": pgbart_step_bign}


def sample_run(model, route, tune, draws, shape=None, choose=False,
               gaussian=True):
    """One ``sample()`` run on the card with every launch count set to 0
    just before and read just after; checks the counts of the route.
    ``gaussian``: the model's likelihood is Normal (the per-round route
    selects with the kernel; a classifier selects in plain PyTorch).
    No plain version of a kernel may run (``plain_calls``; a classifier's
    plain selection excepted), ``ops.select.select_refine_linear`` (the
    XLA-shaped form of the linear selection that only the tests use) neither.

    ``shape``: ``dict(C, P, N, PCOLS, M, DEPTH)`` plus the ``sample()``
    arguments ``refinements`` and ``store_trees``; default the n=1000 shapes.
    ``route``: ``"fused"`` / ``"rounds"`` force that route; ``"bign"``, or
    any route with ``choose``, leaves the choice to ``sample()``
    (``pgbart_route=None``), which must then take that route (the per-round
    route also says so in its warning).  A linear or mix forest must in
    addition store slopes that, with the rest of its last draw's forests,
    predict that draw."""
    import warnings

    import pymc_bart_tpu_torch as pmb

    sh = dict(C=C, P=P, N=N, PCOLS=PCOLS, M=M, DEPTH=DEPTH, refinements=R,
              store_trees=True)
    sh.update(shape or {})
    wrappers = kernel_wrappers()
    from pymc_bart_tpu_torch.sampler import pgbart

    timings = {}
    blocks_drawn = []          # row_gumbels of every draw_rands call
    real_draw = pgbart.draw_rands

    def spy(*a, **kw):
        blocks_drawn.append(bool(kw.get("row_gumbels", True)))
        return real_draw(*a, **kw)

    choose = choose or route == "bign"
    with (pmb.Model(), warnings.catch_warnings(record=True) as said,
          plain_calls() as plain):
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
    expect_no_plain(f"{route} route", plain,
                    () if gaussian else ("plain_selection",))
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
        # every Gaussian forest selects with the kernel; another likelihood
        # in plain PyTorch, as in JAX
        want.update(grow_round=steps * B * sh["DEPTH"],
                    smc_resample=steps * B * (sh["DEPTH"] - 1),
                    select_refine=steps * B if gaussian else 0)
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
            slopes_predict_last_draw(f"{route} route", rv, post)
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
               launches=launches, gumbel_blocks_drawn=sum(blocks_drawn),
               plain_calls=plain)
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
    fused_fit = sample_run(friedman_model, "fused", tune, draws)
    runs["friedman_fused"] = friedman_quality(*fused_fit)
    # phase interpret reads these forests
    friedman_fit = (fused_fit[0], X, f_true)
    del fused_fit

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

    # a depth-12 classifier at 20 particles: both whole-step gates refuse it,
    # so sample() takes the per-round route by itself
    deep_steps = max(4, draws // 8)

    def deep_classifier(pmb):
        lo = pmb.BART("lo", Xl, Yl, m=M, max_depth=12)
        pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=Yl)
        return lo

    idata, post, out = sample_run(
        deep_classifier, "rounds", deep_steps, deep_steps,
        dict(DEPTH=12, store_trees=False), choose=True, gaussian=False)
    runs["logistic_depth12_rounds"] = dict(out, model="logistic depth 12",
                                           **classifier_quality(post, Yl))
    del idata, post

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
    per_round = ("friedman_rounds", "friedman_linear", "friedman_mix",
                 "logistic_depth12_rounds")
    launches = {k: sum(runs[r]["launches"][k] for r in per_round)
                for k in ROUND_KERNELS}
    for name, used_by in (
            ("pgbart_step_fused", ("friedman_fused", "logistic_fused")),
            ("pgbart_step_bign", ("large_n_regression",
                                  "large_n_classifier"))):
        launches[name] = sum(runs[r]["launches"][name] for r in used_by)
    return launches, runs, friedman_fit


def het_data(n=500, seed=3):
    """The heteroscedastic model's data of ``bench.py:304-337``."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    mu_true = 3 * np.sin(2 * X[:, 0])
    sd_true = 0.2 + 1.5 * (X[:, 1] > 0)
    return X, rng.normal(mu_true, sd_true).astype(np.float32), mu_true


def categorical_data(n=500, p=4, k=3, seed=8):
    """Three classes whose log-odds are smooth functions of two columns."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    logits = np.stack([4 * X[:, 0], 4 * X[:, 1], 4 * (1 - X[:, 0])], 1)[:, :k]
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob /= prob.sum(1, keepdims=True)
    labels = (prob.cumsum(1) > rng.uniform(size=(n, 1))).argmax(1)
    return X, labels.astype(np.float32), prob


def counted_sample(build, **kw):
    """``sample(**kw)`` of the model ``build(pmb)`` makes, on the card, with
    every launch count set to 0 just before and read just after.  Returns
    ``(model, rv, idata, launches, routes, seconds, timings)``: ``routes``
    the ``(likelihood code, route)`` of each sampler entry (the first step's
    ``pgbart_step`` calls, in entry order)."""
    import pymc_bart_tpu_torch as pmb
    from pymc_bart_tpu_torch.sampler import pgbart

    wrappers = kernel_wrappers()
    calls = []
    real_step = pgbart.pgbart_step

    def spy(*a, **k):
        calls.append((k.get("lik"), k.get("route")))
        return real_step(*a, **k)

    timings = {}
    model = pmb.Model()
    with model:
        rv = build(pmb)
        for w in wrappers.values():
            w.launches = 0
        pgbart.pgbart_step = spy
        try:
            t0 = time.perf_counter()
            idata = pmb.sample(timings=timings, convergence_checks=False,
                               **kw)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            pgbart.pgbart_step = real_step
    launches = {k: int(w.launches) for k, w in wrappers.items()}
    entries = len(rv.all_trees) if isinstance(rv.all_trees, list) else 1
    if not kw.get("store_trees", True):
        entries = len(calls) // (kw["tune"] + kw["draws"])
    return (model, rv, idata, launches, calls[:entries], seconds, timings)


def expect_launches(tag, launches, want):
    """Fail unless every kernel was launched exactly as often as ``want``
    says (0 for a kernel it does not name)."""
    for k, v in launches.items():
        if want.get(k, 0) and v == 0:
            raise AssertionError(f"{tag}: {k} was never launched")
        if v != want.get(k, 0):
            raise AssertionError(f"{tag}: {k} launched {v} times, expected "
                                 f"{want.get(k, 0)}")


def rejuvenation_on_card_vs_cpu(dev, steps=10, reps=5):
    """``rejuvenate_forest`` at the large-n shapes (C=4, m=20, n=50,000,
    p=10, depth 6) on the card and on the CPU from the same state (grown by
    ``steps`` large-n steps on the card) and the same explicit randoms:
    equal trees, leaves within rtol 1e-6 / atol 1e-6.  Then the host time
    and CUDA kernels (``torch.profiler``) of one sweep, and a step's time on
    the large-n route with and without it (host clock around a
    synchronisation, the step's random numbers drawn inside)."""
    from torch.profiler import ProfilerActivity, profile

    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
    from pymc_bart_tpu_torch.sampler import pgbart, rejuvenate

    cfg = BartConfig(m=LN["M"], max_depth=LN["DEPTH"])
    pg_on = PgbartConfig(num_particles=LN["P"], num_refinements=0,
                         ancestor_sampling=True)
    pg_off = PgbartConfig(num_particles=LN["P"], num_refinements=0)
    n, p, Cn = LN["N"], LN["PCOLS"], LN["C"]
    X_np, Y_np, _ = friedman(n, p, seed=5)
    X = torch.from_numpy(X_np).to(dev)
    Y = torch.from_numpy(Y_np).to(dev)[:, None]
    rules = torch.zeros(p, dtype=torch.int32, device=dev)
    gw = torch.ones((Cn, n, 1), device=dev)
    gen = torch.Generator(device=dev).manual_seed(41)
    state = pgbart.init_state(X, Y, cfg, chains=Cn, device=dev)

    def step(pgc, st):
        rands = pgbart.draw_rands(
            gen, B=pgc.batch_size(cfg.m, False), C=Cn, P=LN["P"],
            D=cfg.max_depth, n=n, k=1, S=cfg.n_nodes, num_refinements=0,
            device=dev, row_gumbels=dev.type != "cuda")
        rejuv = (rejuvenate.draw_rejuv_rands(
            gen, moves=cfg.m, C=Cn, S=cfg.n_nodes, n=n, k=1, device=dev)
            if pgc.ancestor_sampling else None)
        return pgbart.pgbart_step(st, rands, X, Y, rules, cfg, pgc, False, gw,
                                  route="bign", w_scalar=True, all_cont=True,
                                  x_nan=False, rejuv=rejuv)[0]

    for _ in range(steps):
        state = step(pg_off, state)
    # the large-n kernel works in node space: its cached per-tree predictions
    # and their sum must be the forest's, which the moves read
    fresh = pgbart.refresh_tree_pred(state.clone(), X, rules, cfg)
    check_close("large-n tree_pred", state.tree_pred, fresh.tree_pred, 0.0,
                1e-5)
    check_close("large-n sum_trees", state.sum_trees,
                state.tree_pred.sum(dim=1), 0.0, 1e-4)
    moves = rejuvenate.draw_rejuv_rands(gen, moves=cfg.m, C=Cn,
                                        S=cfg.n_nodes, n=n, k=1, device=dev)
    ll_dev = pgbart.make_ll_of("gauss", 0.0, gw, Y[None])
    cpu = torch.device("cpu")

    def moved_to(obj, device):
        """A dataclass of tensors (and nested ones) on ``device``."""
        return type(obj)(**{
            g.name: (getattr(obj, g.name).to(device)
                     if isinstance(getattr(obj, g.name), torch.Tensor)
                     else moved_to(getattr(obj, g.name), device))
            for g in dataclasses.fields(obj)})

    state_cpu, moves_cpu = moved_to(state, cpu), moved_to(moves, cpu)
    ll_cpu = pgbart.make_ll_of("gauss", 0.0, gw.cpu(), Y.cpu()[None])
    before = state.forest.clone()
    got = rejuvenate.rejuvenate_forest(state.clone(), moves, X, Y, rules, cfg,
                                       pg_on, ll_dev, all_cont=True)
    want = rejuvenate.rejuvenate_forest(state_cpu, moves_cpu, X.cpu(),
                                        Y.cpu(), rules.cpu(), cfg, pg_on,
                                        ll_cpu, all_cont=True)
    torch.cuda.synchronize()
    errs = {}
    for g in dataclasses.fields(got.forest):
        a = getattr(got.forest, g.name).cpu()
        b = getattr(want.forest, g.name)
        if g.name in ("leaf", "slope"):
            check_close(f"rejuvenate {g.name}", a, b, 1e-6, 1e-6)
        elif not torch.equal(a, b):
            raise AssertionError(f"rejuvenate on the card: {g.name} differs "
                                 f"from the CPU's ({max_err(a, b)})")
        errs[g.name] = max_err(a, b)
    for name in ("tree_pred", "sum_trees"):
        a, b = getattr(got, name).cpu(), getattr(want, name)
        check_close(f"rejuvenate {name}", a, b, 1e-5, 1e-5)
        errs[name] = max_err(a, b)
    moved = int(((got.forest.split_var != before.split_var).any(-1)
                 | (got.forest.leaf != before.leaf).flatten(2).any(-1)
                 ).sum())
    structure = int((got.forest.split_var != before.split_var).any(-1).sum())

    def sweep(st):
        rejuvenate.rejuvenate_forest(st, moves, X, Y, rules, cfg, pg_on,
                                     ll_dev, all_cont=True)

    sweep_ms = []
    for _ in range(reps):
        st = state.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep(st)
        torch.cuda.synchronize()
        sweep_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = {}
    for name, pgc in (("without", pg_off), ("with", pg_on),
                      ("with_2", pg_on), ("without_2", pg_off)):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = step(pgc, state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms[name] = float(np.median(times))
    st = state.clone()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sweep(st)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    kernels = sum(r[1] for r in rows)
    device_ms = sum(r[0] for r in rows)
    return dict(shapes=dict(C=Cn, m=cfg.m, n=n, p=p, depth=cfg.max_depth),
                max_abs_err=errs, trees_moved=moved,
                trees_restructured=structure,
                sweep_ms=float(np.median(sweep_ms)),
                sweep_device_ms=device_ms, sweep_cuda_kernels=int(kernels),
                cuda_kernels_per_move=kernels / cfg.m,
                host_ms_per_move=float(np.median(sweep_ms)) / cfg.m,
                bign_step_ms=step_ms)


def het_step_times(dev, reps=7):
    """The heteroscedastic model's PGBART work a step at its shapes (two
    forests of m=30, n=500, 4 chains, fused route), host clock around a
    synchronisation, with and without rejuvenation, in turns."""
    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
    from pymc_bart_tpu_torch.sampler import pgbart, rejuvenate

    X_np, Y_np, _ = het_data()
    n = X_np.shape[0]
    cfg = BartConfig(m=30, max_depth=DEPTH)
    X = torch.from_numpy(X_np).to(dev)
    Y = torch.from_numpy(Y_np).to(dev)[:, None]
    rules = torch.zeros(2, dtype=torch.int32, device=dev)
    row = torch.ones((C, n, 1), device=dev)
    gen = torch.Generator(device=dev).manual_seed(43)
    states = [pgbart.init_state(X, Y, cfg, chains=C, device=dev)
              for _ in range(2)]

    def step(pgc):
        for i, lik in enumerate(("gauss", "het_abs")):
            rands = pgbart.draw_rands(
                gen, B=pgc.batch_size(cfg.m, False), C=C, P=10,
                D=cfg.max_depth, n=n, k=1, S=cfg.n_nodes, num_refinements=5,
                device=dev, row_gumbels=False)
            rejuv = (rejuvenate.draw_rejuv_rands(
                gen, moves=cfg.m, C=C, S=cfg.n_nodes, n=n, k=1, device=dev)
                if pgc.ancestor_sampling else None)
            states[i] = pgbart.pgbart_step(
                states[i], rands, X, Y, rules, cfg, pgc, False, row, lik=lik,
                lik_const=0.05, route="fused", all_cont=True, rejuv=rejuv)[0]

    out = {}
    for name, flag in (("without", False), ("with", True), ("with_2", True),
                       ("without_2", False)):
        pgc = PgbartConfig(num_particles=10, ancestor_sampling=flag)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(pgc)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = float(np.median(times[1:]))
    return out


def phase_models(dev, tune, draws, large_tune, large_draws):
    """The models this slice brings to the card, through ``sample()``: the
    heteroscedastic model (separate trees, rejuvenation), a separate-trees
    Categorical model, the large-n regression with and without
    rejuvenation, posterior prediction on new X; rejuvenation on the card
    against the CPU and its cost.  Each run's launch counts stand in this
    phase's line."""
    import pymc_bart_tpu_torch as pmb

    runs = {}
    # -- the heteroscedastic model of bench.py (config_heteroscedastic) ----
    Xh, Yh, mu_h = het_data()
    nh = Xh.shape[0]

    def het_model(pmb):
        Xd = pmb.Data("X", Xh)
        w = pmb.BART("w", Xd, Yh, m=30, shape=(2, nh), separate_trees=True)
        pmb.Normal("y", w[0], pmb.math.abs(w[1]) + 0.05, observed=Yh)
        return w

    model, rv, idata, launches, routes, seconds, timings = counted_sample(
        het_model, tune=tune, draws=draws, chains=C, random_seed=0,
        ancestor_sampling=True)
    if routes != [("gauss", "fused"), ("het_abs", "fused")]:
        raise AssertionError(f"heteroscedastic entries' routes: {routes}")
    expect_launches("heteroscedastic", launches,
                    {"pgbart_step_fused": 2 * (tune + draws)})
    w_post = np.asarray(idata.posterior["w"].values)
    if w_post.shape != (C, draws, 2, nh) or not np.isfinite(w_post).all():
        raise AssertionError(f"heteroscedastic posterior {w_post.shape}")
    if not (isinstance(rv.all_trees, list) and len(rv.all_trees) == 2):
        raise AssertionError("separate trees: all_trees is not a list of 2")
    # bench.py's quality function
    corr = float(np.corrcoef(w_post.mean(axis=(0, 1))[0], mu_h)[0, 1])
    s_hat = np.abs(w_post[:, :, 1, :]).mean(axis=(0, 1)) + 0.05
    ratio = float(s_hat[Xh[:, 1] > 0].mean() / s_hat[Xh[:, 1] <= 0].mean())
    if not corr >= 0.8:
        raise AssertionError(f"heteroscedastic corr_mean_output {corr} < 0.8")
    runs["heteroscedastic"] = dict(
        model="heteroscedastic (bench.py:304-337), separate_trees, "
              "ancestor_sampling", n=nh, m=30, chains=C, tune=tune,
        draws=draws, routes=routes, launches=launches, seconds=seconds,
        tune_seconds=timings["tune_seconds"],
        draw_seconds_total=timings["draw_seconds_total"],
        chain_draws_per_s=C * draws / timings["draw_seconds_total"],
        corr_mean_output=corr, scale_hi_over_lo=ratio, true_ratio=8.5)

    # -- posterior prediction of that model on new X, on the card ----------
    rng = np.random.default_rng(13)
    X_new = rng.uniform(-1, 1, size=(200, 2)).astype(np.float32)
    pmb.set_data({"X": X_new}, model=model)
    t0 = time.perf_counter()
    pmb.sample_posterior_predictive(idata, model=model, predictions=True,
                                    sample_vars=["y", "w"], random_seed=1)
    predict_s = time.perf_counter() - t0
    y_new = np.asarray(idata.predictions["y"].values)
    w_new = np.asarray(idata.predictions["w"].values)
    if (y_new.shape != (C, draws, 200) or w_new.shape != (C, draws, 2, 200)
            or not np.isfinite(y_new).all()):
        raise AssertionError(f"predictions y {y_new.shape} w {w_new.shape}")
    y_mean = y_new.mean(axis=(0, 1))
    w0_mean = w_new[:, :, 0].mean(axis=(0, 1))
    corr_y_w0 = float(np.corrcoef(y_mean, w0_mean)[0, 1])
    corr_w0_true = float(np.corrcoef(w0_mean, 3 * np.sin(2 * X_new[:, 0]))[0,
                                                                          1])
    if not (corr_y_w0 > 0.95 and corr_w0_true > 0.8):
        raise AssertionError(f"predictions: corr(y, w0) {corr_y_w0}, "
                             f"corr(w0, true mu) {corr_w0_true}")
    runs["posterior_predictive"] = dict(
        model="heteroscedastic after set_data to 200 new rows",
        y_shape=list(y_new.shape), w_shape=list(w_new.shape),
        seconds=predict_s, mean_y=float(y_new.mean()),
        mean_w0=float(w_new[:, :, 0].mean()), corr_mean_y_mean_w0=corr_y_w0,
        corr_mean_w0_true_mu=corr_w0_true)
    del idata

    # -- a separate-trees Categorical model, k=3 ---------------------------
    Xk, Yk, prob = categorical_data()

    def categorical_model(pmb):
        lo = pmb.BART("lo", Xk, Yk, m=30, shape=(3, Xk.shape[0]),
                      separate_trees=True)
        pmb.Categorical("y", p=pmb.math.softmax(lo.T, axis=-1), observed=Yk)
        return lo

    _m, _rv, idata, launches, routes, seconds, timings = counted_sample(
        categorical_model, tune=tune, draws=draws, chains=C, random_seed=0)
    if routes != [("cat_logit", "fused")] * 3:
        raise AssertionError(f"categorical entries' routes: {routes}")
    expect_launches("categorical", launches,
                    {"pgbart_step_fused": 3 * (tune + draws)})
    lo_hat = np.asarray(idata.posterior["lo"].values).mean(axis=(0, 1))
    acc = float((lo_hat.argmax(axis=0) == Yk).mean())
    majority = float(np.bincount(Yk.astype(int)).max() / len(Yk))
    bayes = float((prob.argmax(1) == Yk).mean())
    if not acc > majority:
        raise AssertionError(f"categorical accuracy {acc} <= majority "
                             f"{majority}")
    runs["categorical"] = dict(
        model="Categorical(softmax(lo.T)), k=3, separate_trees", n=len(Yk),
        m=30, chains=C, tune=tune, draws=draws, routes=routes,
        launches=launches, seconds=seconds,
        chain_draws_per_s=C * draws / timings["draw_seconds_total"],
        train_accuracy=acc, majority_rate=majority,
        bayes_rule_accuracy=bayes)
    del idata

    # -- large_n_50k (bench.py:369-395), without and with rejuvenation -----
    Xb, Yb, fb = friedman(LN["N"], LN["PCOLS"], seed=5)

    def large_regression(pmb):
        mu = pmb.BART("mu", Xb, Yb, m=LN["M"])
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Yb)
        return mu

    for label, flag in (("large_n_without_rejuvenation", False),
                        ("large_n_with_rejuvenation", True)):
        _m, _rv, idata, launches, routes, seconds, timings = counted_sample(
            large_regression, tune=large_tune, draws=large_draws,
            chains=LN["C"], random_seed=0, num_particles=LN["P"],
            num_refinements=0, store_trees=False, ancestor_sampling=flag)
        # (pgbart_route=None: sample() chooses the route itself)
        if routes != [("gauss", "bign")]:
            raise AssertionError(f"{label}: routes {routes}")
        expect_launches(label, launches,
                        {"pgbart_step_bign": large_tune + large_draws})
        post = np.asarray(idata.posterior["mu"].values)
        sig = np.asarray(idata.posterior["sigma"].values)
        if not (np.isfinite(post).all() and np.isfinite(sig).all()):
            raise AssertionError(f"{label}: non-finite draws")
        rmse = float(np.sqrt(np.mean((post.mean(axis=(0, 1)) - fb) ** 2)))
        if not rmse < 0.5 * float(np.std(fb)):
            raise AssertionError(f"{label}: rmse {rmse} >= half of std(f)")
        runs[label] = dict(
            model="friedman n=50,000 (bench.py:369-395)",
            ancestor_sampling=flag, tune=large_tune, draws=large_draws,
            chains=LN["C"], routes=routes, launches=launches,
            seconds=seconds, tune_seconds=timings["tune_seconds"],
            draw_seconds_total=timings["draw_seconds_total"],
            draw_step_ms=1e3 * timings["draw_seconds_total"] / large_draws,
            chain_draws_per_s=LN["C"] * large_draws
            / timings["draw_seconds_total"],
            rmse_vs_true_f=rmse, sigma_mean=float(sig.mean()), true_sigma=1.0)
        del idata

    runs["rejuvenation_card_vs_cpu"] = rejuvenation_on_card_vs_cpu(dev)
    runs["het_step_ms"] = het_step_times(dev)
    emit("models", runs=runs)


def coal_data():
    """``examples/coal_disasters.py``: UK coal-mining disasters 1851-1962
    in 56 bins (bin centres, counts, exposure in years)."""
    disasters = np.array([
        4, 5, 4, 0, 1, 4, 3, 4, 0, 6, 3, 3, 4, 0, 2, 6, 3, 3, 5, 4, 5, 3, 1,
        4, 4, 1, 5, 5, 3, 4, 2, 5, 2, 2, 3, 4, 2, 1, 3, 2, 2, 1, 1, 1, 1, 3,
        0, 0, 1, 0, 1, 1, 0, 0, 3, 1, 0, 3, 2, 2, 0, 1, 1, 1, 0, 1, 0, 1, 0,
        0, 0, 2, 1, 0, 0, 0, 1, 1, 0, 2, 3, 3, 1, 1, 2, 1, 1, 1, 1, 2, 4, 2,
        0, 0, 0, 1, 4, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 1])
    years = np.arange(1851, 1963)
    edges = np.linspace(years[0], years[-1] + 1, 57)
    counts, _ = np.histogram(np.repeat(years, disasters), bins=edges)
    return 0.5 * (edges[:-1] + edges[1:]), counts.astype(float), np.diff(
        edges)


def per_round_launches(m, depth, tune, draws):
    """Launches of the per-round route for a forest of ``m`` trees that
    selects in plain PyTorch: D growth rounds and D-1 resampling steps a
    tree, a batch of trees a step (``PgbartConfig.batch_size``)."""
    from pymc_bart_tpu_torch.config import PgbartConfig

    pg = PgbartConfig()
    trees = (tune * pg.batch_size(m, True) + draws * pg.batch_size(m, False))
    return {"grow_round": trees * depth, "smc_resample": trees * (depth - 1)}


def device_rows(prof):
    """``(ms, count, name)`` of every CUDA kernel and copy ``prof`` saw,
    the longest first (kernels and copies only: an operator's row would
    repeat its kernels')."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0 and e.device_type == DeviceType.CUDA:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return rows


def busy_share(build, steps, warmup=2, top=8, **kw):
    """Device busy share of ``steps`` draw steps of the model ``build``
    makes: ``sample(tune=0, draws=steps)`` under ``torch.profiler`` after a
    warm-up run of ``warmup`` tuning and draw steps; device time of kernels
    and copies over the host's wall time, and the ``top`` longest rows."""
    import warnings

    import pymc_bart_tpu_torch as pmb
    from torch.profiler import ProfilerActivity, profile

    def run(tune, draws):
        with pmb.Model(), warnings.catch_warnings():
            warnings.simplefilter("ignore")       # the per-round route's
            build(pmb)
            pmb.sample(tune=tune, draws=draws, random_seed=1,
                       convergence_checks=False, store_trees=False, **kw)
        torch.cuda.synchronize()

    run(warmup, warmup)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(0, steps)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    return dict(steps=steps, wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / wall_ms,
                device_events_per_step=sum(r[1] for r in rows) / steps,
                top=[dict(ms=r[0], count=r[1], name=r[2][:80])
                     for r in rows[:top]])


def phase_generic(dev):
    """The generic model likelihood with a joint two-output forest and with
    Poisson, through ``sample()`` with ``pgbart_route=None``: the joint
    heteroscedastic model of ``bench.py`` (``config_het_joint``: n=500,
    m=30, shape=(2, n), 4 chains) and the coal-mining model of
    ``examples/coal_disasters.py`` (Poisson(exp(BART) x exposure), 56 bins,
    m=20, 4 chains).  Both must take the per-round route and say so, launch
    ``grow.cu`` D times and ``smc.cu`` D-1 times a tree and no other kernel;
    ``corr_mean_output`` at least 0.8 (``scale_hi_over_lo`` printed) and the
    coal rate before 1890 over the rate after 1900 above 2.  Then each
    model's device busy share of a draw step (``torch.profiler``)."""
    import warnings

    runs = {}
    X, Y, mu_true = het_data(HJ["N"])
    with warnings.catch_warnings(record=True) as said:
        warnings.simplefilter("always")
        _m, rv, idata, launches, routes, seconds, timings = counted_sample(
            het_joint_model(X, Y), tune=HJ["TUNE"], draws=HJ["DRAWS"],
            chains=C, random_seed=0, num_particles=HJ["P"], num_refinements=R)
    warned = any("per-round sampler route" in str(w.message) for w in said)
    if routes != [("generic", "rounds")] or not warned:
        raise AssertionError(f"het_joint: entries {routes}, per-round "
                             f"warning given: {warned}")
    expect_launches("het_joint", launches,
                    per_round_launches(HJ["M"], DEPTH, HJ["TUNE"],
                                       HJ["DRAWS"]))
    w_post = np.asarray(idata.posterior["w"].values)
    if w_post.shape != (C, HJ["DRAWS"], 2, HJ["N"]) or not np.isfinite(
            w_post).all():
        raise AssertionError(f"het_joint posterior {w_post.shape}")
    if not (rv.all_trees.n_outputs == 2 and rv.all_trees.leaf.shape[:3]
            == (C, HJ["DRAWS"], HJ["M"])):
        raise AssertionError("het_joint: all_trees is not one store of two "
                             "outputs")
    # bench.py's quality function of config_het_joint
    corr = float(np.corrcoef(w_post.mean(axis=(0, 1))[0], mu_true)[0, 1])
    s_hat = np.abs(w_post[:, :, 1, :]).mean(axis=(0, 1)) + 0.05
    ratio = float(s_hat[X[:, 1] > 0].mean() / s_hat[X[:, 1] <= 0].mean())
    if not corr >= 0.8:
        raise AssertionError(f"het_joint corr_mean_output {corr} < 0.8")
    runs["het_joint"] = dict(
        model="config_het_joint (bench.py:453): one forest, shape=(2, n), "
              "Normal(w[0], |w[1]| + 0.05)", n=HJ["N"], m=HJ["M"],
        particles=HJ["P"], chains=C, tune=HJ["TUNE"], draws=HJ["DRAWS"],
        routes=routes,
        launches=launches, seconds=seconds,
        tune_seconds=timings["tune_seconds"],
        draw_seconds_total=timings["draw_seconds_total"],
        draw_step_ms=1e3 * timings["draw_seconds_total"] / HJ["DRAWS"],
        chain_draws_per_s=C * HJ["DRAWS"] / timings["draw_seconds_total"],
        corr_mean_output=corr, scale_hi_over_lo=ratio, true_ratio=8.5)
    del idata

    centers, counts, _ = coal_data()
    with warnings.catch_warnings(record=True) as said:
        warnings.simplefilter("always")
        _m, rv, idata, launches, routes, seconds, timings = counted_sample(
            coal_model, tune=COAL["TUNE"], draws=COAL["DRAWS"], chains=C,
            random_seed=0)
    warned = any("per-round sampler route" in str(w.message) for w in said)
    if routes != [("generic", "rounds")] or not warned:
        raise AssertionError(f"coal: entries {routes}, per-round warning "
                             f"given: {warned}")
    expect_launches("coal", launches,
                    per_round_launches(COAL["M"], DEPTH, COAL["TUNE"],
                                       COAL["DRAWS"]))
    post = np.asarray(idata.posterior["mu"].values)
    if post.shape != (C, COAL["DRAWS"], len(counts)) or not np.isfinite(
            post).all():
        raise AssertionError(f"coal posterior {post.shape}")
    rate = np.exp(post).mean(axis=(0, 1))
    early, late = (float(rate[centers < 1890].mean()),
                   float(rate[centers > 1900].mean()))
    if not early / late > 2.0:
        raise AssertionError(f"coal: rate before 1890 {early}, after 1900 "
                             f"{late}: no drop")
    runs["coal"] = dict(
        model="examples/coal_disasters.py: Poisson(exp(BART) x exposure)",
        n=len(counts), m=COAL["M"], particles=COAL["P"], chains=C,
        tune=COAL["TUNE"], draws=COAL["DRAWS"], routes=routes,
        launches=launches, seconds=seconds,
        draw_step_ms=1e3 * timings["draw_seconds_total"] / COAL["DRAWS"],
        chain_draws_per_s=(C * COAL["DRAWS"]
                           / timings["draw_seconds_total"]),
        rate_before_1890=early, rate_after_1900=late,
        rate_ratio=early / late)
    del idata
    runs["het_joint"]["profile"] = busy_share(
        het_joint_model(X, Y), 10, chains=C, num_particles=HJ["P"],
        num_refinements=R)
    runs["coal"]["profile"] = busy_share(coal_model, 10, chains=C)
    emit("generic", runs=runs)


def phase_interpret(dev, fit):
    """The interpretability suite on the Friedman forests of phase
    ``sample`` (n=1000, p=10, m=50, 4 chains): partial dependence of all ten
    covariates (200 draws, quantile grid), ICE of all ten (30 instances,
    100 draws) and variable importance (``method="VI"``, 50 draws), timed
    on the card.  The card's results must equal the CPU port's on the same
    forests and seeds (rtol 1e-5): the PDP of all ten, and on both sides
    the ICE of the first two covariates with 10 instances and 20 draws and
    a VI run on the first 200 rows with 10 draws.
    The five active covariates must rank first, and the full submodel's
    mean R^2 (one posterior draw of the submodel against an independent
    draw of the full model) must be at least 0.9 and within the 94 % band
    of the full model's R^2 against itself.  No matplotlib is needed."""
    import pymc_bart_tpu_torch as pmb
    from pymc_bart_tpu_torch.utils import interpret
    from pymc_bart_tpu_torch.utils.stats import hdi

    idata, X32, _f = fit
    rv = idata._model.bart_rvs[0]
    trees = rv.all_trees
    X = X32.astype(np.float64)
    p = X.shape[1]
    out = dict(n=X.shape[0], p=p, m=trees.config.m, draws_stored=trees.n_total)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def pdp(device):
        return interpret.partial_dependence(
            trees, X, range(p), samples=200, rng=np.random.default_rng(0),
            device=device)

    def ice(device, var_idx, instances=30, samples=100):
        return interpret.ice(trees, X, var_idx, instances=instances,
                             samples=samples, rng=np.random.default_rng(1),
                             device=device)

    def vi(device, rows=None, samples=50):
        return pmb.compute_variable_importance(
            idata, rv, X[:rows], method="VI", samples=samples,
            random_seed=2, device=device)

    pdp(None)                                    # warm-up
    card_pdp, out["pdp_seconds"] = timed(lambda: pdp(None))
    card_ice, out["ice_seconds"] = timed(lambda: ice(None, range(p)))
    card_vi, out["vi_seconds"] = timed(lambda: vi(None))
    errs = {}

    def same(name, got, want):
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape or not np.allclose(got, want, rtol=1e-5,
                                                      atol=1e-5):
            raise AssertionError(f"interpret {name}: card and CPU differ "
                                 f"({got.shape} vs {want.shape})")
        errs[name] = max(errs.get(name, 0.0),
                         float(np.abs(got - want).max()))

    t0 = time.perf_counter()
    for g, w in zip(card_pdp, pdp("cpu")):
        same("pdp", g.curves, w.curves)
    for g, w in zip(ice(None, [0, 1], 10, 20), ice("cpu", [0, 1], 10, 20)):
        same("ice", g.curves, w.curves)
    small_card, small_cpu = vi(None, 200, 10), vi("cpu", 200, 10)
    for key in ("indices", "r2_mean", "preds"):
        same("vi_" + key, small_card[key], small_cpu[key])
    out["card_vs_cpu_seconds"] = time.perf_counter() - t0
    top5 = sorted(int(i) for i in card_vi["indices"][:5])
    full_r2 = float(card_vi["r2_mean"][-1])
    # the most a submodel can score: the R^2 of one posterior draw of the
    # full model against the next (the band plot_variable_importance draws)
    ceiling = interpret.paired_r2(card_vi["preds_all"][:-1],
                                  card_vi["preds_all"][1:])
    band = hdi(ceiling)
    pdp_ranges = [float(np.ptp(b.curves.mean(0))) for b in card_pdp]
    emit("interpret", **out, max_abs_err_card_vs_cpu=errs,
         vi_indices=[int(i) for i in card_vi["indices"]],
         vi_r2_mean=[float(v) for v in card_vi["r2_mean"]],
         full_submodel_r2=full_r2, full_model_self_r2_mean=float(
             ceiling.mean()), full_model_self_r2_hdi=band.tolist(),
         pdp_mean_curve_range=pdp_ranges)
    if top5 != [0, 1, 2, 3, 4]:
        raise AssertionError(f"VI ranks {card_vi['indices']} first")
    if not (full_r2 >= 0.9 and band[0] <= full_r2 <= band[1]):
        raise AssertionError(
            f"VI: the full submodel's mean R^2 {full_r2} is below 0.9 or "
            f"outside the full model's own band {band.tolist()}")
    if "matplotlib" in sys.modules:
        raise AssertionError("the interpretability run imported matplotlib")


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
    linear_calls = main_path_inputs(dev, 0, "linear", warm_impl=None)[0]
    out["grow_round"]["linear"] = grow_levels(linear_calls)

    a = calls["smc"][0]
    outs = smc_resample(*a, impl="kernel")
    b_ms, by = bound(nbytes(*a) + nbytes(*outs), C * P * 12 + C * P * P)
    out["smc_resample"] = dict(
        bound_ms=b_ms, bound_by=by,
        **timed(lambda: smc_resample(*a, impl="kernel"),
                lambda: smc_resample(*a, impl="plain")))

    def select_times(a, kw):
        outs = select_refine(*a, impl="kernel", **kw)
        lin = kw.get("response", "constant") != "constant"
        S = a[0].shape[2]
        # the work this data needs: the winner's node arrays (and slopes)
        # and rows only, not all P particles'; log_w, resid, ll_weight, the
        # noise, u_sel or the Gumbels, the prior scale; one covariate a row;
        # the outputs
        bts = (C * ((5 + lin) * S + 2 * N + lin * N) * 4
               + nbytes(a[7], a[8], a[9], a[10], a[11], a[13],
                        kw["g_sel"] if lin else a[12]) + nbytes(*outs))
        # per sweep and the winner's own prediction: per row the gather
        # (and slope add), difference, square, weight, add; per leaf the
        # proposal, deviation, square, weight, add; the leaf sums
        ops = C * ((R + 1) * ((5 + lin) * N + 6 * S) + 2 * N)
        b_ms, by = bound(bts, ops)
        return dict(bound_ms=b_ms, bound_by=by, bytes=bts,
                    **timed(lambda: select_refine(*a, impl="kernel", **kw),
                            lambda: select_refine(*a, impl="plain", **kw)))

    out["select_refine"] = select_times(*calls["select"][0])
    out["select_refine"]["linear"] = select_times(*linear_calls["select"][0])

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
                            "select_refine": 5,
                            "pgbart_step_bign": 1})
    check_crossover(crossover)
    return out


def linear_step_times(dev, reps=12, profiled=5):
    """One PGBART step of the linear Friedman model at full width as
    ``sample()`` issues it on the per-round route (blocks drawn with a seed,
    the step enqueued, host clock around a synchronisation), and the device
    busy time of a step (``torch.profiler``, kernels and copies), so that
    the host's share is what is left."""
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
    rows = [(ms / profiled, count // profiled, key[:60])
            for ms, count, key in device_rows(prof)]
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
    X, Y, _ = friedman(N, PCOLS)
    Xl, Yl = logistic(N, PCOLS)
    Xb, Yb, _ = friedman(LN["N"], LN["PCOLS"], seed=5)
    Xc, Yc = logistic(LN["N"], LN["PCOLS"], seed=7)

    def regression(X, Y, **bart):
        def build(pmb):
            mu = pmb.BART("mu", X, Y, **bart)
            sigma = pmb.HalfNormal("sigma", 1.0)
            pmb.Normal("y", mu, sigma, observed=Y)
        return build

    def classifier(X, Y, **bart):
        def build(pmb):
            lo = pmb.BART("lo", X, Y, **bart)
            pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=Y)
        return build

    small = dict(chains=C, num_particles=P, num_refinements=R,
                 pgbart_route="fused")
    # sample() takes the large-n route by itself
    large = dict(chains=LN["C"], num_particles=LN["P"], num_refinements=0)
    for name, build, kw in (
            ("friedman", regression(X, Y, m=M, max_depth=DEPTH), small),
            ("logistic", classifier(Xl, Yl, m=M, max_depth=DEPTH), small),
            ("large_n_regression", regression(Xb, Yb, m=LN["M"]), large),
            ("large_n_classifier", classifier(Xc, Yc, m=LN["M"]), large)):
        out = busy_share(build, steps, warmup=5, top=12, **kw)
        emit("profile", model=name, route="bign" if kw is large else "fused",
             device_idle_share=1.0 - out["device_busy_share"], **out)


# ---------------------------------------------------------------------------
# phase aids: checkpoint / resume, posterior_dtype, debug_nans, profile_dir
# ---------------------------------------------------------------------------

# the Friedman main path at full width: 60 tuning and 60 draw steps in
# chunks of 15, interrupted after half the draws (step 90); the n=50,000
# regression on the large-n route at 10/10 in chunks of 5 (step 15)
AIDS = dict(TUNE=60, DRAWS=60, CHUNK=15)
AIDS_LARGE = dict(TUNE=10, DRAWS=10, CHUNK=5)


def smoke_dir(tag):
    """A scratch directory inside the checkout (git-ignored ``_smoke_*``)."""
    import os
    import tempfile

    return tempfile.mkdtemp(prefix=f"_smoke_{tag}_",
                            dir=os.path.dirname(os.path.abspath(__file__)))


def stores_of(rv):
    trees = rv.all_trees
    return trees if isinstance(trees, list) else [trees]


def differing(a, b, groups=("posterior", "sample_stats")):
    """The first quantity in which two runs ``(idata, stores)`` differ in
    any bit (NaNs equal where both hold one), or None; ``groups``: the
    InferenceData groups compared."""
    def same(x, y):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.dtype.kind == "f":
            return np.array_equal(x.view(f"u{x.itemsize}"),
                                  y.view(f"u{y.itemsize}"))
        return np.array_equal(x, y)

    (ia, ta), (ib, tb) = a, b
    for group in groups:
        names = set(ia[group].keys()) | set(ib[group].keys())
        for name in sorted(names):
            if name not in ia[group] or name not in ib[group] or not same(
                    ia[group][name].values, ib[group][name].values):
                return f"{group}.{name}"
    if len(ta) != len(tb):
        return "all_trees (number of stores)"
    for i, (sa, sb) in enumerate(zip(ta, tb)):
        for f in ("split_var", "split_val", "split_set", "leaf", "count",
                  "slope"):
            if not same(getattr(sa, f), getattr(sb, f)):
                return f"all_trees[{i}].{f}"
    return None


def require_same(tag, a, b):
    """Fail unless two runs of ``aids_run`` agree in every bit."""
    what = differing((a["idata"], a["stores"]), (b["idata"], b["stores"]))
    if what is not None:
        raise AssertionError(f"{tag}: the runs differ in {what}")


class Interrupt(Exception):
    pass


def aids_run(build, interrupt_at=None, **kw):
    """``sample(**kw)`` on the card with every launch count set to 0 just
    before and read just after (``counted_sample``); ``interrupt_at``: stop
    the run once its checkpoint of that step is written, as a run killed
    there would.  Returns a dict with ``idata``, ``stores``, ``launches``,
    ``timings`` and ``seconds`` (None for an interrupted run)."""
    from pymc_bart_tpu_torch.utils import checkpoint as ck

    real = ck.save_checkpoint

    def save(directory, state, meta=None, step=0):
        path = real(directory, state, meta, step)
        if step == interrupt_at:
            raise Interrupt(step)
        return path

    if interrupt_at is not None:
        ck.save_checkpoint = save
    try:
        _m, rv, idata, launches, _routes, seconds, timings = counted_sample(
            build, **kw)
    except Interrupt:
        return None
    finally:
        ck.save_checkpoint = real
    if interrupt_at is not None:
        raise AssertionError(f"the run was not interrupted at step "
                             f"{interrupt_at}")
    return dict(idata=idata, stores=stores_of(rv) if kw.get(
        "store_trees", True) else [], launches=launches, timings=timings,
        seconds=seconds)


def rate(run, draws):
    return C * draws / run["timings"]["draw_seconds_total"]


def phase_aids(dev):
    """Checkpoint / resume and the debug aids of ``sample()`` on the card."""
    import glob
    import os
    import shutil

    X, Y, _ = friedman(N, PCOLS)

    def friedman_model(pmb):
        mu = pmb.BART("mu", X, Y, m=M, max_depth=DEPTH)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)
        return mu

    T, D_, CH = AIDS["TUNE"], AIDS["DRAWS"], AIDS["CHUNK"]
    kw = dict(tune=T, draws=D_, chains=C, random_seed=0, num_particles=P,
              num_refinements=R, chunk_size=CH, pgbart_route="fused")
    fused = {"pgbart_step_fused": T + D_}
    out, launches = {}, {}
    root = smoke_dir("aids")
    try:
        plain = aids_run(friedman_model, **kw)
        expect_launches("aids plain", plain["launches"], fused)
        ck1 = aids_run(friedman_model, checkpoint_dir=f"{root}/a", **kw)
        ck2 = aids_run(friedman_model, checkpoint_dir=f"{root}/b", **kw)
        require_same("two checkpointed runs from one seed", ck1, ck2)
        require_same("a checkpointed run and one without", ck1, plain)
        half = T + D_ // 2
        aids_run(friedman_model, interrupt_at=half,
                 checkpoint_dir=f"{root}/c", **kw)
        resumed = aids_run(friedman_model, checkpoint_dir=f"{root}/c",
                           resume=True, **kw)
        expect_launches("aids resumed", resumed["launches"],
                        {"pgbart_step_fused": D_ // 2})
        require_same(f"interrupted at step {half} and resumed", resumed, ck1)
        tm = ck1["timings"]
        out["friedman"] = dict(
            shapes=dict(C=C, P=P, n=N, p=PCOLS, m=M, depth=DEPTH, R=R),
            tune=T, draws=D_, chunk=CH, interrupted_at_step=half,
            resume_bit_for_bit=True, two_runs_bit_for_bit=True,
            checkpoints=len(tm["checkpoint_seconds"]),
            checkpoint_seconds=tm["checkpoint_seconds"],
            checkpoint_bytes=tm["checkpoint_bytes"][-1],
            chain_draws_per_s=rate(plain, D_),
            chain_draws_per_s_checkpointing=rate(ck1, D_),
            launches_resumed=resumed["launches"])
        launches["friedman"] = plain["launches"]

        # the n=50,000 regression on the large-n route
        Xb, Yb, _ = friedman(LN["N"], LN["PCOLS"], seed=5)

        def large_regression(pmb):
            mu = pmb.BART("mu", Xb, Yb, m=LN["M"])
            sigma = pmb.HalfNormal("sigma", 1.0)
            pmb.Normal("y", mu, sigma, observed=Yb)
            return mu

        TL, DL, CL = AIDS_LARGE["TUNE"], AIDS_LARGE["DRAWS"], \
            AIDS_LARGE["CHUNK"]
        lkw = dict(tune=TL, draws=DL, chains=LN["C"], random_seed=0,
                   num_particles=LN["P"], num_refinements=0, chunk_size=CL)
        big_full = aids_run(large_regression, checkpoint_dir=f"{root}/d",
                            **lkw)
        expect_launches("aids large-n", big_full["launches"],
                        {"pgbart_step_bign": TL + DL})
        aids_run(large_regression, interrupt_at=TL + DL // 2,
                 checkpoint_dir=f"{root}/e", **lkw)
        big_resumed = aids_run(large_regression, checkpoint_dir=f"{root}/e",
                               resume=True, **lkw)
        expect_launches("aids large-n resumed", big_resumed["launches"],
                        {"pgbart_step_bign": DL // 2})
        require_same("large-n interrupted and resumed", big_resumed,
                     big_full)
        tl = big_full["timings"]
        out["large_n"] = dict(
            shapes=dict(LN), tune=TL, draws=DL, chunk=CL,
            interrupted_at_step=TL + DL // 2, resume_bit_for_bit=True,
            checkpoint_seconds=tl["checkpoint_seconds"],
            checkpoint_bytes=tl["checkpoint_bytes"][-1])
        launches["large_n"] = big_full["launches"]
        shutil.rmtree(root)
        root = smoke_dir("aids")

        # half-precision storage of the collected values
        lean = dict(kw, store_trees=False)
        f32 = aids_run(friedman_model, **lean)
        dtypes = {"float32": dict(drained_bytes=f32["timings"][
            "drained_bytes"])}
        ref = f32["idata"].posterior["mu"].values
        scale = max(float(np.abs(ref).max()), 1.0)
        for name in ("float16", "bfloat16"):
            half_run = aids_run(friedman_model, posterior_dtype=name, **lean)
            got = half_run["idata"].posterior["mu"].values
            err = float(np.abs(got - ref).max()) / scale
            if got.dtype != np.float32 or not 0 < err < 1e-2:
                raise AssertionError(f"posterior_dtype={name}: {got.dtype}, "
                                     f"relative error {err}")
            what = differing((half_run["idata"], []), (f32["idata"], []),
                             groups=("sample_stats",))
            if what is not None:
                raise AssertionError(f"posterior_dtype={name} changed "
                                     f"{what}, not only the stored values")
            dtypes[name] = dict(
                drained_bytes=half_run["timings"]["drained_bytes"],
                max_rel_err_vs_float32=err)
        out["posterior_dtype"] = dtypes

        # debug_nans: the same bits, and the rate it costs; a second run
        # without any aid after it gives the spread of the rate
        checked = aids_run(friedman_model, debug_nans=True, **kw)
        require_same("debug_nans against the run without it", checked, plain)
        plain2 = aids_run(friedman_model, **kw)
        require_same("two runs without an aid", plain2, plain)
        out["friedman"]["chain_draws_per_s_again"] = rate(plain2, D_)
        Yn = Y.copy()
        Yn[7] = np.nan

        def nan_model(pmb):
            mu = pmb.BART("mu", X, Yn, m=M, max_depth=DEPTH)
            sigma = pmb.HalfNormal("sigma", 1.0)
            pmb.Normal("y", mu, sigma, observed=Yn)
            return mu

        import warnings

        message = None
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")   # the per-round route's
                aids_run(nan_model, tune=2, draws=2, chains=C,
                         random_seed=0, num_particles=P, debug_nans=True)
        except FloatingPointError as e:
            message = str(e)
        if message is None or "is not finite" not in message:
            raise AssertionError("debug_nans: the NaN-target model did not "
                                 "raise FloatingPointError")
        out["debug_nans"] = dict(
            bit_for_bit=True, chain_draws_per_s=rate(checked, D_),
            chain_draws_per_s_without=[rate(plain, D_), rate(plain2, D_)],
            nan_target_raised=message)

        # profile_dir: a Chrome trace that names draw.cu's kernel
        prof_dir = f"{root}/prof"
        aids_run(friedman_model, profile_dir=prof_dir, **dict(
            kw, tune=3, draws=5))
        traces = glob.glob(os.path.join(prof_dir, "*.json"))
        if len(traces) != 1:
            raise AssertionError(f"profile_dir holds {traces}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        kernel_events = [e for e in events
                         if "pgbart_step_kernel" in e.get("name", "")]
        if len(kernel_events) < 5:
            raise AssertionError(f"the trace names draw.cu's kernel "
                                 f"{len(kernel_events)} times in 5 steps")
        out["profile_dir"] = dict(
            trace=os.path.basename(traces[0]),
            trace_bytes=os.path.getsize(traces[0]), events=len(events),
            draw_kernel_events=len(kernel_events),
            draw_kernel_name=kernel_events[0]["name"][:120])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("aids", runs=out, launches=launches)


# ---------------------------------------------------------------------------
# phase linlik: linear / mix forests under the non-Gaussian likelihoods
# ---------------------------------------------------------------------------

COAL_LINEAR = dict(TUNE=200, DRAWS=200)
CAT_NAN = dict(N=1000, TUNE=100, DRAWS=100)


def cat_nan_data(n=CAT_NAN["N"], seed=7):
    """A Subset column of 48 categories (a non-ordinal grouping), a OneHot
    column and a continuous column a tenth NaN (tests/test_categorical.py's
    kind, at n=1000)."""
    rng = np.random.default_rng(seed)
    cats = rng.integers(0, 48, size=n)
    group = (cats % 3 == 0).astype(float)
    onehot = rng.integers(0, 3, size=n).astype(float)
    x = rng.uniform(size=n)
    Y = (5.0 * group + 1.5 * (onehot == 2) + 2.0 * x
         + rng.normal(0, 0.3, n)).astype(np.float32)
    x[rng.permutation(n)[: n // 10]] = np.nan
    return np.stack([cats.astype(float), onehot, x], axis=1), Y, group


def slopes_predict_last_draw(tag, rv, post):
    """Fail unless the stored forests of a linear or mix forest hold slopes
    and, with them, predict the last draw on the card."""
    from pymc_bart_tpu_torch.ops.predict import forest_predict
    from pymc_bart_tpu_torch.ops.trees import Forest

    tr = rv.all_trees
    if not (tr.slope != 0).any():
        raise AssertionError(f"{tag}: the stored forests hold no slope")
    last = Forest(*(torch.as_tensor(np.ascontiguousarray(a[:, -1])).cuda()
                    for a in (tr.split_var, tr.split_val,
                              tr.split_set.view(np.int32), tr.leaf,
                              tr.count, tr.slope)))
    fp = forest_predict(last, torch.as_tensor(rv.X, dtype=torch.float32)
                        .cuda(), torch.as_tensor(rv.rules_array()).cuda(),
                        rv.config.max_depth)[..., 0].cpu().numpy()
    if not np.allclose(fp, post[:, -1], rtol=1e-4, atol=1e-3):
        raise AssertionError(f"{tag}: the stored forests with their slopes "
                             "do not predict the last draw: max abs diff "
                             f"{np.abs(fp - post[:, -1]).max()}")


def phase_linlik(dev, tune, draws):
    """The linear and mix responses under the Bernoulli code and the
    generic likelihood, and the categorical rules with NaN X, through
    ``sample()`` with ``pgbart_route=None``."""
    import warnings

    runs = {}
    Xl, Yl = logistic(N, PCOLS)

    def classifier(response):
        def build(pmb):
            lo = pmb.BART("lo", Xl, Yl, m=M, max_depth=DEPTH,
                          response=response)
            pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=Yl)
            return lo
        return build

    half = max(2, draws // 2)
    idata, post, out = sample_run(classifier("linear"), "rounds", half,
                                  half, choose=True, gaussian=False)
    runs["logistic_linear"] = dict(out, model="logistic, response=linear",
                                   **classifier_quality(post, Yl))
    mix_steps = max(2, draws // 6)
    idata, post, out = sample_run(classifier("mix"), "rounds", mix_steps,
                                  mix_steps, choose=True, gaussian=False)
    runs["logistic_mix"] = dict(out, model="logistic, response=mix",
                                **classifier_quality(post, Yl))
    del idata, post
    runs["logistic_linear"]["profile"] = busy_share(
        classifier("linear"), 10, chains=C, num_particles=P,
        num_refinements=R)

    centers, counts, exposure = coal_data()

    def coal_linear(pmb):
        mu = pmb.BART("mu", centers[:, None], np.log1p(counts), m=COAL["M"],
                      response="linear")
        pmb.Poisson("y", mu=pmb.math.exp(mu) * exposure / exposure.mean(),
                    observed=counts)
        return mu

    TC, DC = COAL_LINEAR["TUNE"], COAL_LINEAR["DRAWS"]
    with warnings.catch_warnings(record=True) as said:
        warnings.simplefilter("always")
        _m, rv, idata, launches, routes, seconds, timings = counted_sample(
            coal_linear, tune=TC, draws=DC, chains=C, random_seed=0)
    warned = any("per-round sampler route" in str(w.message) for w in said)
    if routes != [("generic", "rounds")] or not warned:
        raise AssertionError(f"coal linear: entries {routes}, per-round "
                             f"warning given: {warned}")
    expect_launches("coal linear", launches,
                    per_round_launches(COAL["M"], DEPTH, TC, DC))
    post = np.asarray(idata.posterior["mu"].values)
    if post.shape != (C, DC, len(counts)) or not np.isfinite(post).all():
        raise AssertionError(f"coal linear posterior {post.shape}")
    slopes_predict_last_draw("coal linear", rv, post)
    rate_ = np.exp(post).mean(axis=(0, 1))
    early, late = (float(rate_[centers < 1890].mean()),
                   float(rate_[centers > 1900].mean()))
    if not early / late > 2.0:
        raise AssertionError(f"coal linear: rate before 1890 {early}, after "
                             f"1900 {late}: no drop")
    runs["coal_linear"] = dict(
        model="examples/coal_disasters.py with response='linear'",
        n=len(counts), m=COAL["M"], chains=C, tune=TC, draws=DC,
        routes=routes, launches=launches, seconds=seconds,
        chain_draws_per_s=C * DC / timings["draw_seconds_total"],
        rate_before_1890=early, rate_after_1900=late, rate_ratio=early / late)
    del idata

    Xc, Yc, group = cat_nan_data()
    TK, DK = CAT_NAN["TUNE"], CAT_NAN["DRAWS"]

    def cat_nan_model(pmb):
        mu = pmb.BART("mu", Xc, Yc, m=M, max_depth=DEPTH, split_rules=[
            "SubsetSplit", "OneHotSplit", "ContinuousSplit"])
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Yc)
        return mu

    _m, rv, idata, launches, routes, seconds, timings = counted_sample(
        cat_nan_model, tune=TK, draws=DK, chains=C, random_seed=0,
        num_particles=P, num_refinements=R)
    if routes != [("gauss", "fused")]:
        raise AssertionError(f"categorical / NaN model: entries {routes}")
    expect_launches("categorical / NaN model", launches,
                    {"pgbart_step_fused": TK + DK})
    post = np.asarray(idata.posterior["mu"].values)
    if not np.isfinite(post).all():
        raise AssertionError("categorical / NaN model: non-finite draws")
    fhat = post.mean(axis=(0, 1))
    gap = float(fhat[group == 1].mean() - fhat[group == 0].mean())
    vi = np.asarray(idata["sample_stats"]["variable_inclusion"].values
                    ).sum(axis=(0, 1))[0]
    if not gap > 3.0 or int(np.argmax(vi)) != 0:
        raise AssertionError(f"categorical / NaN model: group gap {gap}, "
                             f"inclusion {vi.tolist()}")
    runs["categorical_nan"] = dict(
        model="Subset (48 categories), OneHot, continuous a tenth NaN",
        n=CAT_NAN["N"], m=M, chains=C, tune=TK, draws=DK, launches=launches,
        seconds=seconds,
        chain_draws_per_s=C * DK / timings["draw_seconds_total"],
        group_gap=gap, variable_inclusion=vi.tolist())
    emit("linlik", runs=runs)


def linear_logistic_inputs(dev, seed):
    """The growth rounds and resampling steps of one tree update of the
    linear logistic forest of phase ``linlik`` (m=50, 20 particles, n=1000,
    p=10, zero row weights, the linear statistics), after 12 steps on the
    plain versions from seed ``seed``."""
    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
    from pymc_bart_tpu_torch.sampler import pgbart

    cfg = BartConfig(m=M, max_depth=DEPTH, response="linear")
    pg = PgbartConfig(num_particles=P, num_refinements=R)
    Xl, Yl = logistic(N, PCOLS)
    X = torch.from_numpy(Xl).to(dev)
    Y = torch.from_numpy(Yl).to(dev)[:, None]
    rules = torch.zeros(PCOLS, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = pgbart.init_state(X, Y, cfg, chains=C, device=dev)

    def rands(B):
        return pgbart.draw_rands(gen, B=B, C=C, P=P, D=DEPTH, n=N, k=1,
                                 S=cfg.n_nodes, num_refinements=R,
                                 device=dev, response="linear")

    for _ in range(12):
        state, _ = pgbart.pgbart_step(state, rands(5), X, Y, rules, cfg, pg,
                                      True, None, impl="plain",
                                      lik="bernoulli", route="rounds")
    return record_tree_update(state, rands(1), X, Y, rules, cfg, pg, None,
                              lik="bernoulli")



# ---------------------------------------------------------------------------
# phase mesh: sample(mesh=...) over two ranks that share the card
# ---------------------------------------------------------------------------

MESH_RANKS = 2
# tuning and draw steps of the mesh runs: (a) the Friedman main path, (b) the
# large-n model on its kernel, (c) the large-n model with rows over the ranks
MESH_STEPS = dict(friedman=(60, 60), large_chains=(20, 20),
                  large_rows=(100, 100))
MESH_NODE_STEPS = 3      # node-space steps held sharded against unsharded


def state_chains(state, part):
    """The chains ``part`` of a ``PgbartState`` (every field, chain axis 0)."""
    from pymc_bart_tpu_torch.ops.trees import Forest
    from pymc_bart_tpu_torch.sampler import pgbart

    f = state.forest
    forest = Forest(*(getattr(f, g.name)[part].clone()
                      for g in dataclasses.fields(f)))
    return pgbart.PgbartState(forest=forest, **{
        g.name: getattr(state, g.name)[part].clone()
        for g in dataclasses.fields(state) if g.name != "forest"})


def check_chain_offset(dev, seed=37):
    """The whole-step and large-n kernels on chains 2 and 3 of 4 (a rank of a
    two-rank mesh: ``StepRands.shard``, the kernels' global chain offset of
    the row-Gumbel streams) equal, bit for bit, the same kernel's chains 2
    and 3 of one launch for all four, and the plain version on the block
    ``gumbel_block`` writes out for those chains; the written-out block of a
    part of the chains and rows is that part of the whole block."""
    from pymc_bart_tpu_torch.ops.bign import gumbel_block

    part = slice(2, 4)
    out = {}
    for kind in ("fused", "bign"):
        case = (fused_case(dev, "gauss_tune") if kind == "fused"
                else bign_case(dev, "gauss_tune"))
        step = fused_step if kind == "fused" else bign_step
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = (grown_state(case, gen, dev) if kind == "fused"
                 else bign_grown_state(case, gen, dev))
        rands = (fused_rands if kind == "fused" else bign_rands)(
            case, gen, True, dev, row_gumbels=False)
        whole, vi_whole = step(case, state.clone(), rands, True, "kernel")
        half_case = dict(case, chains=2)
        for key in ("row", "w_chain", "llw"):
            if half_case.get(key) is not None:
                half_case[key] = half_case[key][part].contiguous()
        sub = rands.shard(part)
        half, vi_half = step(half_case, state_chains(state, part), sub, True,
                             "kernel")
        cfg, pg = case["cfg"], case["pg"]
        block = gumbel_block(sub.seed, B=pg.batch_size(cfg.m, True), C=2,
                             P=pg.num_particles, D=cfg.max_depth,
                             n=case["X"].shape[0], chains=4, chain0=2)
        plain, vi_plain = step(half_case, state_chains(state, part),
                               dataclasses.replace(sub, rg=block), True,
                               "plain")
        torch.cuda.synchronize()
        check_close(f"{kind} chains 2-3 vi", vi_half, vi_whole[part], 0.0, 0.0)
        check_close(f"{kind} chains 2-3 vi plain", vi_plain, vi_half, 0.0,
                    0.0)
        for (name, a), (_, b), (_, c) in zip(
                state_fields(half), state_fields(state_chains(whole, part)),
                state_fields(plain)):
            if not (torch.equal(a, b) and torch.equal(a, c)):
                raise AssertionError(f"{kind} kernel on chains 2-3 of 4: "
                                     f"{name} differs from the launch for all "
                                     "chains or from the plain version")
        out[kind] = dict(bit_for_bit=True, splits=int(
            (half.forest.split_var >= 0).sum()))
    # a part of the chains and rows of the written-out block
    full = gumbel_block(sub.seed, B=2, C=4, P=10, D=6, n=1000)
    piece = gumbel_block(sub.seed, B=2, C=2, P=10, D=6, n=300, chains=4,
                         chain0=1, row0=500)
    if not torch.equal(piece, full[:, :, 1:3, :, 500:800]):
        raise AssertionError("gumbel_block: a part of the chains and rows "
                             "is not that part of the whole block")
    out["gumbel_block_part"] = True
    return out


def mesh_regression(X, Y, m, max_depth=None):
    def build(pmb):
        kw = {} if max_depth is None else dict(max_depth=max_depth)
        mu = pmb.BART("mu", X, Y, m=m, **kw)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)
        return mu
    return build


def mesh_runs():
    """The sample() runs of the phase, by name: ``(model builder,
    sample() arguments)``."""
    X, Y, _ = friedman(N, PCOLS)
    Xb, Yb, _ = friedman(LN["N"], LN["PCOLS"], seed=5)
    big = dict(num_particles=LN["P"], num_refinements=0, chains=LN["C"],
               random_seed=0, chunk_size=10)
    runs = {"friedman": (mesh_regression(X, Y, M, DEPTH), dict(
        num_particles=P, num_refinements=R, chains=C, random_seed=0,
        chunk_size=30)),
            "large_chains": (mesh_regression(Xb, Yb, LN["M"]), big),
            "large_rows": (mesh_regression(Xb, Yb, LN["M"]), dict(
                big, chunk_size=50))}
    for name, (tune, draws) in MESH_STEPS.items():
        runs[name][1].update(tune=tune, draws=draws)
    return runs


def mesh_outputs(model, rv, idata):
    """A run's posterior, sample stats and stored forests, flat."""
    out = {}
    for group in ("posterior", "sample_stats"):
        for name, da in idata[group].items():
            out[f"{group}/{name}"] = np.asarray(da.values)
    for f in ("split_var", "split_val", "split_set", "leaf", "count",
              "slope"):
        out[f"trees/{f}"] = np.asarray(getattr(rv.all_trees, f))
    return out


def node_space_steps(dev, rows=None, part=None):
    """``MESH_NODE_STEPS`` tuning steps of the per-round route in the
    node-space mode on the large-n model (every route's random numbers from
    one generator), unsharded or on the rows ``part`` with ``rows``;
    returns the state's tensors and the seconds of the steps."""
    from pymc_bart_tpu_torch.config import BartConfig, PgbartConfig
    from pymc_bart_tpu_torch.sampler import pgbart

    X_np, Y_np, _ = friedman(LN["N"], LN["PCOLS"], seed=5)
    cfg = BartConfig(m=LN["M"], max_depth=LN["DEPTH"])
    pg = PgbartConfig(num_particles=LN["P"], num_refinements=R)
    n, Cc = LN["N"], LN["C"]
    sl = slice(None) if part is None else part
    X = torch.from_numpy(X_np[sl]).to(dev)
    Y = torch.from_numpy(Y_np[sl]).to(dev)[:, None]
    w = torch.full((Cc, X.shape[0], 1), 1.0, device=dev)
    rules = torch.zeros(LN["PCOLS"], dtype=torch.int32, device=dev)
    state = pgbart.init_state(X, Y, cfg, chains=Cc, device=dev, rows=rows)
    gen = torch.Generator(device=dev).manual_seed(41)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_NODE_STEPS):
        rands = pgbart.draw_rands(
            gen, B=pg.batch_size(cfg.m, True), C=Cc, P=pg.num_particles,
            D=cfg.max_depth, n=n, k=1, S=cfg.n_nodes,
            num_refinements=pg.num_refinements, device=dev,
            row_gumbels=False)
        if rows is not None:
            rands = rands.shard(slice(0, Cc), part)
        state, _ = pgbart.pgbart_step(state, rands, X, Y, rules, cfg, pg,
                                      True, w, route="rounds", w_scalar=True,
                                      rows=rows, suff_stats=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = {f"forest.{g.name}": getattr(state.forest, g.name).cpu().numpy()
           for g in dataclasses.fields(state.forest)}
    out.update({g.name: getattr(state, g.name).cpu().numpy()
                for g in dataclasses.fields(state) if g.name != "forest"})
    return out, seconds


def mesh_rank(rank, init_file, outdir, device):
    """One rank of the phase's world on ``device``: gloo (NCCL refuses two
    ranks on one card), ``cuda:0`` for both ranks on the one card."""
    import json as json_
    import os

    from pymc_bart_tpu_torch.parallel import mesh as pmesh

    pmesh.initialize_distributed(f"file://{init_file}", MESH_RANKS, rank,
                                 backend="gloo", device=device)
    dev = torch.device(device)
    wrappers = kernel_wrappers()
    chains_mesh = pmesh.make_mesh()
    rows_mesh = pmesh.make_mesh(n_data_shards=MESH_RANKS)
    scalars, arrays = {}, {}
    for name, (build, kw) in mesh_runs().items():
        mesh = rows_mesh if name == "large_rows" else chains_mesh
        calls0 = dict(pmesh.collective_calls)
        model, rv, idata, launches, _r, seconds, timings = counted_sample(
            build, mesh=mesh, **kw)
        scalars[name] = dict(
            launches=launches, seconds=seconds,
            draw_seconds_total=timings["draw_seconds_total"],
            tune_seconds=timings["tune_seconds"],
            collectives={k: pmesh.collective_calls[k] - calls0[k]
                         for k in calls0})
        for k, v in mesh_outputs(model, rv, idata).items():
            arrays[f"{name}/{k}"] = v
        del idata
    rows = pmesh.row_shard(rows_mesh, LN["N"])
    part = slice(rows.row0, rows.row0 + rows.n)
    calls0 = dict(pmesh.collective_calls)
    node, seconds = node_space_steps(dev, rows, part)
    scalars["node_steps"] = dict(
        seconds=seconds, rows=[rows.row0, rows.n],
        all_reduces=pmesh.collective_calls["all_reduce"]
        - calls0["all_reduce"])
    for k, v in node.items():
        arrays[f"node/{k}"] = v
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json_.dump(scalars, fh)
    del wrappers
    torch.distributed.destroy_process_group()


def mesh_solo(rank, outdir, device):
    """One of two processes that share the card without a world: the
    Friedman run of (a) on two chains of its own, no collective (what two
    processes on one card cost without the mesh's gathers)."""
    import json as json_
    import os

    build, kw = mesh_runs()["friedman"]
    kw = dict(kw, chains=kw["chains"] // MESH_RANKS, random_seed=rank,
              device=device)
    _m, _rv, idata, launches, _r, _s, timings = counted_sample(build, **kw)
    if not np.isfinite(np.asarray(idata.posterior["mu"].values)).all():
        raise AssertionError("mesh (solo): non-finite draws")
    with open(os.path.join(outdir, f"solo{rank}.json"), "w") as fh:
        json_.dump(dict(draw_seconds_total=timings["draw_seconds_total"],
                        launches=launches), fh)


def phase_mesh(dev):
    """``sample(mesh=...)`` over two ranks on the one card (gloo): (a) the
    Friedman main path with chains over the ranks on ``draw.cu``, bit for bit
    the one-process run; (b) the n=50,000 model with chains over the ranks on
    ``bign.cu``, bit for bit too; (c) the n=50,000 model with rows over the
    ranks: the node-space step equal to the unsharded one in structure and
    counts, and sample() at 100/100 within the large-n rmse bound.  Every
    rank's launches are its own; chain-draws/s one process against two."""
    import json as json_
    import os
    import shutil

    from pymc_bart_tpu_torch.parallel import mesh as pmesh
    from pymc_bart_tpu_torch.sampler import pgbart

    t_phase = time.perf_counter()
    offsets = check_chain_offset(dev)
    work = smoke_dir("mesh")
    try:
        t0 = time.perf_counter()
        pmesh.run_local_world(mesh_rank, MESH_RANKS,
                              args=(os.path.join(work, "init"), work,
                                    str(dev)), timeout=900)
        world_seconds = time.perf_counter() - t0
        ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                 for r in range(MESH_RANKS)]
        info = []
        for r in range(MESH_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as fh:
                info.append(json_.load(fh))
        pmesh.run_local_world(mesh_solo, MESH_RANKS, args=(work, str(dev)),
                              timeout=300)
        solo = []
        for r in range(MESH_RANKS):
            with open(os.path.join(work, f"solo{r}.json")) as fh:
                solo.append(json_.load(fh))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def same_everywhere(tag, want):
        for r, got in enumerate(ranks):
            for k, v in want.items():
                g = got[f"{tag}/{k}"]
                if g.shape != v.shape or g.dtype != v.dtype or not (
                        np.array_equal(g.view(np.uint8), v.view(np.uint8))
                        if v.dtype.kind == "f" else np.array_equal(g, v)):
                    raise AssertionError(f"mesh ({tag}): rank {r}'s {k} "
                                         "differs from the one-process run")

    report = dict(chain_offset=offsets, ranks=MESH_RANKS, backend="gloo",
                  world_seconds=world_seconds)
    for name, (build, kw) in mesh_runs().items():
        if name == "large_rows":
            continue
        model, rv, idata, launches, _r, seconds, timings = counted_sample(
            build, **kw)
        want = mesh_outputs(model, rv, idata)
        del idata
        same_everywhere(name, want)
        kernel = "pgbart_step_fused" if name == "friedman" else \
            "pgbart_step_bign"
        steps = kw["tune"] + kw["draws"]
        for r in range(MESH_RANKS):
            got = info[r][name]["launches"]
            if got[kernel] != steps or sum(got.values()) != steps:
                raise AssertionError(f"mesh ({name}): rank {r} launched "
                                     f"{got}, expected {steps} of {kernel}")
        if launches[kernel] != steps:
            raise AssertionError(f"mesh ({name}): the one-process run "
                                 f"launched {launches}")
        wall = max(i[name]["draw_seconds_total"] for i in info)
        report[name] = dict(
            tune=kw["tune"], draws=kw["draws"], chains=kw["chains"],
            bit_for_bit=True, kernel=kernel,
            launches_per_rank=[i[name]["launches"][kernel] for i in info],
            chain_draws_per_s_one_process=kw["chains"] * kw["draws"]
            / timings["draw_seconds_total"],
            chain_draws_per_s_two_ranks=kw["chains"] * kw["draws"] / wall,
            draw_seconds_per_rank=[i[name]["draw_seconds_total"]
                                   for i in info],
            collectives_per_rank=[i[name]["collectives"] for i in info])
    tune, draws = MESH_STEPS["friedman"]
    report["friedman"]["chain_draws_per_s_two_processes_alone"] = C * draws \
        / max(s_["draw_seconds_total"] for s_ in solo)
    # (c) rows over the ranks: node-space steps, then sample()
    want, seconds = node_space_steps(dev)
    got = {}
    row_axes = pgbart.PgbartState.ROW_AXES
    for k in want:
        if k in row_axes:
            got[k] = np.concatenate([r[f"node/{k}"] for r in ranks],
                                    axis=row_axes[k])
        else:
            for r in ranks[1:]:
                if not np.array_equal(r[f"node/{k}"], ranks[0][f"node/{k}"]):
                    raise AssertionError(f"mesh (node-space): the ranks "
                                         f"disagree on {k}")
            got[k] = ranks[0][f"node/{k}"]
    for k in ("forest.split_var", "forest.count", "iteration",
              "batch_offset"):
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"mesh (node-space): sharded {k} differs "
                                 "from the unsharded step's")
    float_err = {k: float(np.nanmax(np.abs(got[k] - want[k])))
                 for k in ("forest.leaf", "forest.split_val", "sum_trees",
                           "leaf_sd") if got[k].size}
    splits = int((got["forest.split_var"] >= 0).sum())
    if splits == 0:
        raise AssertionError("mesh (node-space): no split after the steps")
    node = [i["node_steps"] for i in info]
    report["node_space_step"] = dict(
        steps=MESH_NODE_STEPS, structure_and_counts_equal=True,
        max_abs_err=float_err, splits=splits,
        unsharded_ms_per_step=1e3 * seconds / MESH_NODE_STEPS,
        sharded_ms_per_step=[1e3 * i["seconds"] / MESH_NODE_STEPS
                             for i in node],
        all_reduces_per_step=[i["all_reduces"] / MESH_NODE_STEPS
                              for i in node],
        rows_per_rank=[i["rows"] for i in node])
    _Xb, _Yb, fb = friedman(LN["N"], LN["PCOLS"], seed=5)
    tune, draws = MESH_STEPS["large_rows"]
    post = ranks[0]["large_rows/posterior/mu"]
    for r in ranks[1:]:
        if not np.array_equal(r["large_rows/posterior/mu"], post):
            raise AssertionError("mesh (rows): the ranks returned different "
                                 "posteriors")
    if post.shape != (LN["C"], draws, LN["N"]) or not np.isfinite(post).all():
        raise AssertionError(f"mesh (rows): posterior {post.shape}, finite "
                             f"{bool(np.isfinite(post).all())}")
    rmse = float(np.sqrt(np.mean((post.mean(axis=(0, 1)) - fb) ** 2)))
    if not rmse < 0.5 * float(np.std(fb)):
        raise AssertionError(f"mesh (rows): rmse vs true f {rmse} >= half "
                             f"of std(f) {float(np.std(fb))}")
    steps = tune + draws
    report["large_rows"] = dict(
        tune=tune, draws=draws, chains=LN["C"], rmse_vs_true_f=rmse,
        std_f=float(np.std(fb)),
        launches_per_rank=[i["large_rows"]["launches"] for i in info],
        step_ms_per_rank=[1e3 * (i["large_rows"]["tune_seconds"]
                                 + i["large_rows"]["draw_seconds_total"])
                          / steps for i in info],
        all_reduces_per_step=[i["large_rows"]["collectives"]["all_reduce"]
                              / steps for i in info],
        chain_draws_per_s=LN["C"] * draws / max(
            i["large_rows"]["draw_seconds_total"] for i in info))
    for i in info:
        la = i["large_rows"]["launches"]
        if la["smc_resample"] == 0 or la["pgbart_step_fused"] or \
                la["pgbart_step_bign"] or la["grow_round"]:
            raise AssertionError(f"mesh (rows): launches {la}: the sharded "
                                 "per-round route resamples on smc.cu and "
                                 "grows in plain PyTorch")
    report["seconds"] = time.perf_counter() - t_phase
    emit("mesh", **report)


# tuning and draw steps of the runs of phase nccl: (a) the Friedman main
# path with chains over the cards, (b) its checkpoint / resume, (c) rows
WORLD_STEPS = dict(chains=(60, 60), resume=(10, 10), rows=(40, 40))
WORLD_SECONDS = 600


def world_runs(steps):
    """Phase nccl's sample() runs by name: ``(model builder, arguments)``."""
    X, Y, _ = friedman(N, PCOLS)
    base = dict(num_particles=P, num_refinements=R, chains=C, random_seed=0,
                chunk_size=30)
    runs = {name: (mesh_regression(X, Y, M, DEPTH), dict(base))
            for name in ("chains", "resume", "rows")}
    runs["resume"][1]["chunk_size"] = 5
    for name, (tune, draws) in steps.items():
        runs[name][1].update(tune=tune, draws=draws)
    return runs


def world_rank(workdir):
    """One rank of phase nccl, started by ``torchrun`` (``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` in the environment): the runs of
    ``world_runs`` on this rank's device, written to ``workdir``.
    ``world.json`` there names the device kind (``"cuda"``: NCCL, one card a
    rank; ``"cpu"``: gloo) and the steps."""
    import json as json_
    import os

    from pymc_bart_tpu_torch.parallel import mesh as pmesh

    with open(os.path.join(workdir, "world.json")) as fh:
        conf = json_.load(fh)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = conf["device"]
    if device == "cpu":
        torch.set_num_threads(1)
    pmesh.initialize_distributed("env://", world, rank, device=device)
    meshes = {"chains": pmesh.make_mesh(),
              "rows": pmesh.make_mesh(n_data_shards=2)}
    scalars = dict(backend=torch.distributed.get_backend(),
                   device=str(torch.empty(0, device=device).device))
    arrays = {}
    for name, (build, kw) in world_runs(conf["steps"]).items():
        kw = dict(kw, mesh=meshes["rows" if name == "rows" else "chains"],
                  device=device)
        if name == "resume":
            # no directory shared by the ranks: rank 0 alone writes and
            # reads its own, the others' stay empty
            kw["checkpoint_dir"] = os.path.join(workdir, f"ckpt_rank{rank}")
            first = mesh_outputs(*counted_sample(build, **kw)[:3])
            for k, v in first.items():
                arrays[f"resume_first/{k}"] = v
            kw["resume"] = True
        calls0 = dict(pmesh.collective_calls)
        _m, rv, idata, launches, _r, seconds, timings = counted_sample(
            build, **kw)
        scalars[name] = dict(
            launches=launches, seconds=seconds,
            draw_seconds_total=timings["draw_seconds_total"],
            collectives={k: pmesh.collective_calls[k] - calls0[k]
                         for k in calls0})
        for k, v in mesh_outputs(_m, rv, idata).items():
            arrays[f"{name}/{k}"] = v
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
        json_.dump(scalars, fh)
    torch.distributed.destroy_process_group()


def run_world(workdir, ranks, device, steps, timeout=WORLD_SECONDS):
    """Start ``ranks`` ranks of ``world_rank`` with ``torchrun`` on one host
    (static rendezvous on a free port of 127.0.0.1) and wait for them; on a
    non-zero exit or past ``timeout`` seconds the whole process group is
    killed and the phase fails."""
    import json as json_
    import os
    import signal
    import socket

    with open(os.path.join(workdir, "world.json"), "w") as fh:
        json_.dump(dict(device=device, steps=steps), fh)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes=1",
         f"--nproc_per_node={ranks}", "--master_addr=127.0.0.1",
         f"--master_port={port}", os.path.abspath(__file__),
         "--world-rank", workdir], start_new_session=True,
        stdout=sys.stderr)
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    if rc != 0:
        raise AssertionError(f"nccl: torchrun exited with {rc}")


def check_world(workdir, ranks, dev, steps):
    """Phase nccl's checks of the ranks' files in ``workdir`` against one
    process's runs on ``dev``; returns the phase's report."""
    import json as json_
    import os

    out = [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
           for r in range(ranks)]
    info = []
    for r in range(ranks):
        with open(os.path.join(workdir, f"rank{r}.json")) as fh:
            info.append(json_.load(fh))

    def same(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and (
            np.array_equal(a.view(np.uint8), b.view(np.uint8))
            if a.dtype.kind == "f" else np.array_equal(a, b))

    runs = world_runs(steps)
    build, kw = runs["chains"]
    _m, rv, idata, launches, _r, _s, timings = counted_sample(
        build, device=str(dev), **kw)
    want = mesh_outputs(_m, rv, idata)
    tune, draws = steps["chains"]
    for r in range(ranks):
        for k, v in want.items():
            if not same(out[r][f"chains/{k}"], v):
                raise AssertionError(f"nccl (chains): rank {r}'s {k} "
                                     "differs from the one-process run")
        for k in want:
            if not same(out[r][f"resume/{k}"], out[r][f"resume_first/{k}"]):
                raise AssertionError(f"nccl (resume): rank {r}'s resumed {k} "
                                     "differs from the first run's")
        if r > 0 and os.path.exists(os.path.join(workdir, f"ckpt_rank{r}")):
            raise AssertionError(f"nccl (resume): rank {r} wrote files")
        for k in want:
            if not same(out[r][f"rows/{k}"], out[0][f"rows/{k}"]):
                raise AssertionError(f"nccl (rows): rank {r}'s {k} differs "
                                     "from rank 0's")
    if dev.type == "cuda":
        for r in range(ranks):
            got = info[r]["chains"]["launches"]
            if got["pgbart_step_fused"] != tune + draws:
                raise AssertionError(f"nccl (chains): rank {r} launched "
                                     f"{got}")
    _X, _Y, f = friedman(N, PCOLS)
    post = out[0]["rows/posterior/mu"]
    rmse = float(np.sqrt(np.mean((post.mean(axis=(0, 1)) - f) ** 2)))
    if post.shape != (C, steps["rows"][1], N) or not np.isfinite(post).all() \
            or not rmse < 0.5 * float(np.std(f)):
        raise AssertionError(f"nccl (rows): posterior {post.shape}, rmse "
                             f"{rmse} against half of std(f) "
                             f"{0.5 * float(np.std(f))}")
    rows_steps = sum(steps["rows"])
    return dict(
        ranks=ranks, backend=info[0]["backend"],
        devices=[i["device"] for i in info], chains=C,
        chains_bit_for_bit=True, resume_bit_for_bit=True,
        launches_per_rank=[i["chains"]["launches"] for i in info],
        chain_draws_per_s_one_process=C * draws
        / timings["draw_seconds_total"],
        chain_draws_per_s_ranks=C * draws / max(
            i["chains"]["draw_seconds_total"] for i in info),
        rows=dict(rmse_vs_true_f=rmse, std_f=float(np.std(f)),
                  step_ms_per_rank=[1e3 * i["rows"]["seconds"] / rows_steps
                                    for i in info],
                  all_reduces_per_step=[
                      i["rows"]["collectives"]["all_reduce"] / rows_steps
                      for i in info]))


def phase_nccl(dev):
    """``torchrun`` over every card with NCCL (see the module docstring)."""
    import shutil

    cards = torch.cuda.device_count()
    if cards < 2:
        raise AssertionError(f"phase nccl needs two cards or more, this "
                             f"machine has {cards}")
    t0 = time.perf_counter()
    work = smoke_dir("nccl")
    try:
        run_world(work, cards, "cuda", WORLD_STEPS)
        world_seconds = time.perf_counter() - t0
        report = check_world(work, cards, dev, WORLD_STEPS)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("nccl", world_seconds=world_seconds,
         seconds=time.perf_counter() - t0, **report)


# -- phase examples: the six examples of examples/port/ on the card ---------
# entry: (route, BART forests of its model, what its check asks, the check
# on the dict it returns)
PORT_EXAMPLES = {
    "coal_disasters.main": (
        "rounds", 1, "early / late > 2",
        lambda r: r["early"] / r["late"] > 2),
    "friedman_regression.main": (
        "fused", 1, f"rmse < {RMSE_BOUND}", lambda r: r["rmse"] < RMSE_BOUND),
    "classification.binary": (
        "fused", 1, "accuracy > majority_rate",
        lambda r: r["accuracy"] > r["majority_rate"]),
    "classification.categorical": (
        "fused", 3, "accuracy > majority_rate",
        lambda r: r["accuracy"] > r["majority_rate"]),
    "heteroscedastic.main": (
        "fused", 2, "corr_mean_output >= 0.8",
        lambda r: r["corr_mean_output"] >= 0.8),
    "high_dim_selection.main": (
        "fused", 1, "top5 == [0, 1, 2, 3, 4]",
        lambda r: r["top5"] == [0, 1, 2, 3, 4]),
    "out_of_sample.main": (
        "fused", 1, "rmse < std_f_test / 2",
        lambda r: r["rmse"] < 0.5 * r["std_f_test"]),
}
# the plain versions of the kernels, by every module attribute the sampler
# calls them through, with the kernel each stands in for
PLAIN_VERSIONS = (
    ("pymc_bart_tpu_torch.ops.draw", "pgbart_step_fused_plain",
     "pgbart_step_fused"),
    ("pymc_bart_tpu_torch.ops.bign", "pgbart_step_bign_plain",
     "pgbart_step_bign"),
    ("pymc_bart_tpu_torch.ops.grow", "grow_round_plain", "grow_round"),
    ("pymc_bart_tpu_torch.sampler.pgbart", "grow_round_plain", "grow_round"),
    ("pymc_bart_tpu_torch.ops.smc", "smc_resample_plain", "smc_resample"),
    ("pymc_bart_tpu_torch.ops.bign", "smc_resample_plain", "smc_resample"),
    ("pymc_bart_tpu_torch.ops.select", "select_refine_plain",
     "select_refine"),
    # the XLA-shaped linear selection, which only the tests use
    ("pymc_bart_tpu_torch.ops.select", "select_refine_linear",
     "select_refine"),
    # the winner and refinement of a non-Gaussian or joint forest: plain
    # PyTorch by design, as the JAX package runs them in XLA
    ("pymc_bart_tpu_torch.sampler.pgbart", "select_refine_plain",
     "plain_selection"),
)


def load_port_example(name):
    """The module of ``examples/port/<name>.py``, under a name of its own."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "examples" / "port" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"pymc_bart_tpu_torch_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def plain_calls():
    """Count the calls of every plain version (``PLAIN_VERSIONS``) while
    the block runs: a dict of counts by the kernel each stands in for."""
    import importlib

    counts = {}
    saved = []

    def spy(key, fn):
        def counted(*a, **k):
            counts[key] = counts.get(key, 0) + 1
            return fn(*a, **k)
        return counted

    for mod_name, attr, key in PLAIN_VERSIONS:
        mod = importlib.import_module(mod_name)
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, spy(key, getattr(mod, attr)))
    try:
        yield counts
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def instrumented(fn, *args, **kw):
    """Run ``fn(*args, **kw)`` with every launch count set to 0 just before
    and read just after and the plain versions counted; each
    ``pmb.sample`` call gets a ``timings`` dict, and each PDP / ICE
    computation (``utils.interpret.partial_dependence`` / ``ice``, from a
    plot or called alone) is timed; the callee's printing goes to stderr.
    Returns ``(result, seconds, launches, plain calls, samples, curves)``."""
    import pymc_bart_tpu_torch as pmb
    from pymc_bart_tpu_torch.utils import interpret, plots

    wrappers = kernel_wrappers()
    samples, curves = [], []
    real_sample = pmb.sample
    saved = [(m, k, getattr(m, k)) for m in (interpret, plots)
             for k in ("partial_dependence", "ice")]

    def sample(*a, **k):
        timings = {}
        idata = real_sample(*a, timings=timings, **k)
        samples.append(dict(chains=k["chains"], tune=k["tune"],
                            draws=k["draws"], timings=timings))
        return idata

    def timed(name, fn):
        def computed(trees, X, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(trees, X, *a, **k)
            torch.cuda.synchronize()
            curves.append(dict(name=name, seconds=time.perf_counter() - t0,
                               trees=trees, X=X))
            return res
        return computed

    for w in wrappers.values():
        w.launches = 0
    try:
        pmb.sample = sample
        for m, k, f in saved:
            setattr(m, k, timed(k, f))
        with plain_calls() as plain, contextlib.redirect_stdout(sys.stderr):
            t0 = time.perf_counter()
            result = fn(*args, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        pmb.sample = real_sample
        for m, k, f in saved:
            setattr(m, k, f)
    launches = {k: int(w.launches) for k, w in wrappers.items()}
    return result, seconds, launches, dict(plain), samples, curves


def descent_rule_seconds(trees, X):
    """The high-dim example's plot computations on the card: PDP of the five
    active columns (200 draws) and ICE of columns 0 and 3 (30 instances,
    100 draws), through the shared continuous-only descent rule and through
    the full ``decide_left`` (``utils.posterior``'s ``rules_all_continuous``
    answering False), in turns (full, shared, shared, full) after a warm-up.
    Seconds of each; the two rules' curves must be equal bit for bit."""
    from pymc_bart_tpu_torch.utils import interpret, posterior

    shared_rule = posterior.rules_all_continuous

    def run(rule):
        posterior.rules_all_continuous = rule
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pdp = interpret.partial_dependence(
                trees, X, range(5), samples=200,
                rng=np.random.default_rng(0), device=None)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ice = interpret.ice(trees, X, [0, 3], instances=30, samples=100,
                                rng=np.random.default_rng(1), device=None)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        finally:
            posterior.rules_all_continuous = shared_rule
        return [b.curves for b in pdp + ice], t1 - t0, t2 - t1

    rules = {"shared": shared_rule, "full": lambda rules: False}
    run(shared_rule)
    out = {k: dict(pdp_seconds=[], ice_seconds=[]) for k in rules}
    curves = {}
    for label in ("full", "shared", "shared", "full"):
        curves[label], pdp_s, ice_s = run(rules[label])
        out[label]["pdp_seconds"].append(pdp_s)
        out[label]["ice_seconds"].append(ice_s)
    for a, b in zip(curves["full"], curves["shared"]):
        if not np.array_equal(a, b):
            raise AssertionError("PDP / ICE curves differ between the shared "
                                 "continuous-only rule and decide_left")
    return out


def expect_no_plain(tag, plain, allowed=()):
    """Fail if a plain version other than ``allowed`` was called."""
    if set(plain) - set(allowed):
        raise AssertionError(f"{tag}: plain versions called on the card: "
                             f"{plain}")


def expect_route(tag, launches, kernels):
    """Fail unless every kernel of ``kernels`` launched and no other did."""
    missing = [k for k in kernels if launches[k] == 0]
    others = [k for k, v in launches.items() if v and k not in kernels]
    if missing or others:
        raise AssertionError(f"{tag}: not launched {missing}, launched off "
                             f"the route {others}")


def phase_examples(dev):
    """The six examples of ``examples/port/`` (seven entries) at their own
    budgets on the card, each through its entry with ``device=None``: the
    kernels of its route launched exactly as often as its steps ask
    (``draw.cu`` once a step and forest; coal ``grow.cu`` D and ``smc.cu``
    D-1 times a tree) and nothing else, no plain version of a kernel called
    (coal's winner and refinement are plain PyTorch by design), finite
    returned numbers and each example's quality check.  Prints one line an
    entry (chain-draws/s, seconds, launches; the high-dim example's PDP / ICE
    seconds, and its plot computations with the shared continuous-only
    descent rule against the full ``decide_left``), then the summary."""
    failed = []
    summary = {}
    for key, (route, forests, what, check) in PORT_EXAMPLES.items():
        name, entry = key.split(".")
        mod = load_port_example(name)
        res, seconds, launches, plain, samples, curves = instrumented(
            getattr(mod, entry), device=None)
        (s,) = samples
        steps = s["tune"] + s["draws"]
        if route == "fused":
            want = {"pgbart_step_fused": steps * forests}
            allowed_plain = ()
        else:
            want = per_round_launches(20, DEPTH, s["tune"], s["draws"])
            allowed_plain = ("plain_selection",)
        expect_launches(key, launches, want)
        expect_no_plain(key, plain, allowed_plain)
        numbers = [v for v in res.values() if not isinstance(v, list)]
        numbers += [x for v in res.values() if isinstance(v, list)
                    for x in v if not isinstance(x, str)]
        if not np.isfinite(np.asarray(numbers, float)).all():
            raise AssertionError(f"{key}: non-finite result {res}")
        ok = bool(check(res))
        line = dict(example=key, route=route, forests=forests,
                    chains=s["chains"], tune=s["tune"], draws=s["draws"],
                    seconds=seconds,
                    tune_seconds=s["timings"]["tune_seconds"],
                    draw_seconds_total=s["timings"]["draw_seconds_total"],
                    chain_draws_per_s=s["chains"] * s["draws"]
                    / s["timings"]["draw_seconds_total"],
                    launches=launches, plain_calls=plain, result=res,
                    check=what, check_passed=ok)
        if curves:
            line["curve_seconds"] = {c["name"]: c["seconds"] for c in curves}
            line["matplotlib"] = "matplotlib" in sys.modules
            line["descent_rule"] = descent_rule_seconds(
                curves[0]["trees"], np.asarray(curves[0]["X"], np.float64))
        emit("examples", **line)
        summary[key] = dict(chain_draws_per_s=line["chain_draws_per_s"],
                            seconds=seconds, check_passed=ok)
        if not ok:
            failed.append((key, what, res))
    emit("examples", summary=summary)
    if failed:
        raise AssertionError(f"examples failing their checks: {failed}")


# -- phase parity: the nine models of bench.py at its budgets ---------------
def bikes_like(n, seed=1):
    """``bench.py``'s synthetic hourly rental counts: daily cycle x
    temperature (a copy: this script imports nothing of the JAX side)."""
    rng = np.random.default_rng(seed)
    hour = rng.uniform(0, 24, n)
    temp = rng.uniform(-5, 35, n)
    hum = rng.uniform(20, 100, n)
    wind = rng.uniform(0, 40, n)
    work = rng.integers(0, 2, n).astype(np.float32)
    lam = (60 * np.exp(-0.5 * ((hour - 8) / 2.0) ** 2)
           + 80 * np.exp(-0.5 * ((hour - 17.5) / 2.5) ** 2)
           + 2.0 * np.clip(temp, 0, 30) - 0.3 * (hum - 60) - 0.5 * wind)
    lam = np.maximum(lam, 2.0)
    Y = rng.poisson(lam).astype(np.float32)
    X = np.stack([hour, temp, hum, wind, work], axis=1).astype(np.float32)
    return X, Y, lam


def regression(X, Y, m, sigma=1.0, **bart):
    def build(pmb):
        mu = pmb.BART("mu", X, Y, m=m, **bart)
        s = pmb.HalfNormal("sigma", sigma)
        pmb.Normal("y", mu, s, observed=Y)
        return mu
    return build


def classifier(X, Y, m):
    def build(pmb):
        lo = pmb.BART("lo", X, Y, m=m)
        pmb.Bernoulli("y", p=pmb.math.sigmoid(lo), observed=Y)
        return lo
    return build


def two_output(X, Y, m, separate_trees):
    def build(pmb):
        w = pmb.BART("w", X, Y, m=m, shape=(2, len(Y)),
                     separate_trees=separate_trees)
        pmb.Normal("y", w[0], pmb.math.abs(w[1]) + 0.05, observed=Y)
        return w
    return build


def fit_quality(idata, f_true):
    mu_hat = idata.posterior["mu"].values.mean(axis=(0, 1))
    return {"rmse_vs_true_f": float(np.sqrt(np.mean((mu_hat - f_true) ** 2))),
            "sigma_mean": float(idata.posterior["sigma"].values.mean())}


def classifier_quality_of(idata, Y, p_true):
    lo_hat = idata.posterior["lo"].values.mean(axis=(0, 1))
    ph = np.clip(1 / (1 + np.exp(-lo_hat)), 1e-6, 1 - 1e-6)
    return {"train_accuracy": float(((lo_hat > 0) == (Y > 0.5)).mean()),
            "bayes_accuracy": float(np.maximum(p_true, 1 - p_true).mean()),
            "mean_loglik": float(np.mean(Y * np.log(ph)
                                         + (1 - Y) * np.log(1 - ph)))}


def scale_quality(idata, X, mu_true):
    w = idata.posterior["w"].values
    corr = float(np.corrcoef(w.mean(axis=(0, 1))[0], mu_true)[0, 1])
    s_hat = np.abs(w[:, :, 1, :]).mean(axis=(0, 1)) + 0.05
    return {"corr_mean_output": corr,
            "scale_hi_over_lo": float(s_hat[X[:, 1] > 0].mean()
                                      / max(s_hat[X[:, 1] <= 0].mean(),
                                            1e-9)),
            "true_ratio": 8.5}


def parity_rows():
    """The nine models of ``bench.py`` (``config_*``, ``:224-483``) with its
    data, budgets and ``sample()`` settings: ``(name, build, sample
    arguments, quality(idata), band(quality) -> list of failures, the
    JAX package's record in BENCH_FULL.json, kernels the route launches)``.
    Every row: 4 chains, ``posterior_dtype="float16"`` and ``chunk_size`` a
    quarter of the draws, as ``bench.py::run_config``.  ``build(pmb)`` takes
    either package."""
    rows = []
    X, Y, f = friedman(1000, 10)
    rows.append((
        "friedman", regression(X, Y, 50),
        dict(tune=200, draws=600, num_particles=20),
        lambda i, f=f: {**fit_quality(i, f), "vi_top5_is_signal": set(
            np.argsort(i["sample_stats"]["variable_inclusion"].values.sum(
                axis=(0, 1))[0])[::-1][:5].tolist()) == {0, 1, 2, 3, 4}},
        lambda q: ([] if q["rmse_vs_true_f"] <= 0.685 else ["rmse > 0.685"])
        + ([] if q["vi_top5_is_signal"] else ["vi_top5_is_signal false"]),
        {"rmse_vs_true_f": 0.571, "sigma_mean": 1.273,
         "vi_top5_is_signal": True}, ("pgbart_step_fused",)))
    Xb, Yb, lam = bikes_like(1000)

    def bikes_quality(i, lam=lam):
        mu_hat = i.posterior["mu"].values.mean(axis=(0, 1))
        rmse = float(np.sqrt(np.mean((mu_hat - lam) ** 2)))
        return {"rmse_vs_lambda": rmse, "rel_rmse": rmse / float(lam.std())}

    rows.append((
        "bikes", regression(Xb, Yb, 50, sigma=2.0),
        dict(tune=200, draws=400, num_particles=20), bikes_quality,
        lambda q: [] if q["rel_rmse"] <= 0.119 else ["rel_rmse > 0.119"],
        {"rmse_vs_lambda": 3.201, "rel_rmse": 0.099}, ("pgbart_step_fused",)))
    Xl, Yl = logistic(1000, 10, seed=2)
    pl = 1 / (1 + np.exp(-(4 * np.sin(np.pi * Xl[:, 0] * Xl[:, 1])
                           + 4 * Xl[:, 3] - 2)))
    rows.append((
        "logistic", classifier(Xl, Yl, 50),
        dict(tune=200, draws=400, num_particles=20),
        lambda i: classifier_quality_of(i, Yl, pl),
        lambda q: ([] if q["train_accuracy"] >= 0.808 else ["accuracy < 0.808"])
        + ([] if q["mean_loglik"] >= -0.407 else ["mean_loglik < -0.407"]),
        {"train_accuracy": 0.828, "bayes_accuracy": 0.837,
         "mean_loglik": -0.387}, ("pgbart_step_fused",)))
    Xh, Yh, mu_h = het_data(500, seed=3)
    rows.append((
        "heteroscedastic", two_output(Xh, Yh, 30, True),
        dict(tune=400, draws=400, ancestor_sampling=True),
        lambda i: scale_quality(i, Xh, mu_h),
        lambda q: ([] if q["corr_mean_output"] >= 0.99 else ["corr < 0.99"])
        + ([] if q["scale_hi_over_lo"] >= 4.73 else ["scale ratio < 4.73"]),
        {"corr_mean_output": 0.998, "scale_hi_over_lo": 5.91},
        ("pgbart_step_fused",)))
    rng = np.random.default_rng(4)
    Xd = rng.normal(size=(200, 1000)).astype(np.float32)
    Yd = (3 * Xd[:, 0] + 2 * Xd[:, 1] - 2 * Xd[:, 2]
          + rng.normal(0, 0.5, 200)).astype(np.float32)

    def highdim_quality(i):
        counts = i["sample_stats"]["variable_inclusion"].values.sum(
            axis=(0, 1))[0].astype(float)
        order = np.argsort(counts)[::-1]
        return {"vi_top3_is_signal": set(order[:3].tolist()) == {0, 1, 2},
                "signal_mass": float(counts[:3].sum() / counts.sum())}

    rows.append((
        "highdim_p1000", regression(Xd, Yd, 50, split_prior=np.ones(1000)),
        dict(tune=200, draws=400, num_particles=40, batch=(0.5, 0.5),
             split_prior_decay=0.999), highdim_quality,
        lambda q: ([] if q["vi_top3_is_signal"] else ["vi_top3 false"])
        + ([] if q["signal_mass"] >= 0.867 else ["signal_mass < 0.867"]),
        {"vi_top3_is_signal": True, "signal_mass": 0.917},
        ("pgbart_step_fused",)))
    large = dict(tune=200, draws=600, num_particles=10, num_refinements=0,
                 store_trees=False, ancestor_sampling=True)
    Xn, Yn, fn = friedman(50_000, 10, seed=5)
    rows.append((
        "large_n_50k", regression(Xn, Yn, 20), dict(large),
        lambda i: fit_quality(i, fn),
        lambda q: ([] if q["rmse_vs_true_f"] <= 0.98 else ["rmse > 0.98"])
        + ([] if q["sigma_mean"] <= 1.40 else ["sigma > 1.40"]),
        {"rmse_vs_true_f": 0.891}, ("pgbart_step_bign",)))
    Xc, Yc = logistic(50_000, 10, seed=7)
    pc = 1 / (1 + np.exp(-(4 * np.sin(np.pi * Xc[:, 0] * Xc[:, 1])
                           + 4 * Xc[:, 3] - 2)))
    rows.append((
        "large_n_logistic_50k", classifier(Xc, Yc, 20), dict(large),
        lambda i: classifier_quality_of(i, Yc, pc),
        lambda q: [] if q["train_accuracy"] >= 0.831 else ["accuracy < 0.831"],
        {"train_accuracy": 0.841, "bayes_accuracy": 0.842},
        ("pgbart_step_bign",)))
    Xr, Yr, fr = friedman(1000, 10, seed=6)
    rows.append((
        "friedman_linear", regression(Xr, Yr, 50, response="linear"),
        dict(tune=200, draws=400, num_particles=20),
        lambda i: fit_quality(i, fr),
        lambda q: [] if q["rmse_vs_true_f"] <= 0.654 else ["rmse > 0.654"],
        {"rmse_vs_true_f": 0.545, "sigma_mean": 1.276},
        ("grow_round", "smc_resample", "select_refine")))
    rows.append((
        "het_joint", two_output(Xh, Yh, 30, False), dict(tune=200, draws=400),
        lambda i: scale_quality(i, Xh, mu_h),
        lambda q: ([] if q["corr_mean_output"] >= 0.985 else ["corr < 0.985"])
        + ([] if q["scale_hi_over_lo"] >= 2.26 else ["scale ratio < 2.26"]),
        {"corr_mean_output": 0.995, "scale_hi_over_lo": 2.83},
        ("grow_round", "smc_resample")))
    return rows


def max_rhat(idata, name):
    """``bench.py::_ess_block``'s R-hat: the first, middle and last row of
    the BART variable, and sigma where the model has it."""
    from pymc_bart_tpu_torch.utils.diagnostics import rhat

    v = np.asarray(idata.posterior[name].values, np.float64)
    v = v.reshape(v.shape[0], v.shape[1], -1)
    r = [float(rhat(v[..., j])) for j in (0, v.shape[-1] // 2,
                                          v.shape[-1] - 1)]
    if "sigma" in idata.posterior:
        r.append(float(rhat(np.asarray(idata.posterior["sigma"].values,
                                       np.float64))))
    return max(r)


def parity_run(name, build, kw, quality, kernels, seed):
    """One row at one seed through ``sample()`` on the card: its quality,
    rate, launches; the route's kernels must have launched and no plain
    version of a kernel run."""
    import warnings

    draws = kw["draws"]
    with warnings.catch_warnings(), plain_calls() as plain:
        warnings.simplefilter("ignore")     # the per-round route's, R-hat's
        (_model, rv, idata, launches, _routes, seconds,
         timings) = counted_sample(
            build, chains=4, random_seed=seed, chunk_size=max(draws // 4, 1),
            posterior_dtype="float16", **kw)
    expect_route(f"parity {name}", launches, kernels)
    expect_no_plain(f"parity {name}", plain, ("plain_selection",))
    q = quality(idata)
    return dict(seed=seed, quality=q, max_rhat=max_rhat(idata, rv.name),
                seconds=seconds, tune_seconds=timings["tune_seconds"],
                draw_seconds_total=timings["draw_seconds_total"],
                chain_draws_per_s=4 * draws / timings["draw_seconds_total"],
                launches=launches, plain_calls=plain)


def phase_parity(dev):
    """The nine models of ``bench.py`` through the port's ``sample()`` at the
    bench's budgets and settings on the card, each row's quality computed as
    the bench's ``quality`` functions do, against a band around the JAX
    package's record (``BENCH_FULL.json``; one run on another chip, so the
    bands leave room for Monte-Carlo error).  Seed 0 first; seed 1 only for
    a row outside its band; a row outside at both seeds is a fault of the
    port and fails the phase after every row has run.  One line a row."""
    faults = []
    for name, build, kw, quality, band, jax_record, kernels in parity_rows():
        runs = []
        for seed in (0, 1):
            run = parity_run(name, build, kw, quality, kernels, seed)
            run["outside_band"] = band(run["quality"])
            runs.append(run)
            if not run["outside_band"]:
                break
        emit("parity", row=name, settings={
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in kw.items()}, chains=4, posterior_dtype="float16",
            jax_bench_full=jax_record, runs=runs,
            in_band=not runs[-1]["outside_band"])
        if runs[-1]["outside_band"]:
            faults.append((name, [r["outside_band"] for r in runs]))
    if faults:
        raise AssertionError(f"parity rows outside their bands at seeds 0 "
                             f"and 1: {faults}")


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
    ap.add_argument("--model-tune", type=int, default=200,
                    help="tuning steps of the heteroscedastic and "
                         "Categorical models (phase models)")
    ap.add_argument("--model-draws", type=int, default=200)
    ap.add_argument("--world-rank", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.world_rank:
        world_rank(args.world_rank)
        return 0
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
    errs = launches = times = runs = fit = None
    if "kernels" in phases:
        errs = phase_kernels(dev, calls, cfg)
    if "step" in phases:
        phase_step(dev)
    if "sample" in phases:
        launches, runs, fit = phase_sample(dev, args.tune, args.draws,
                                           args.large_tune, args.large_draws)
    if "models" in phases:
        phase_models(dev, args.model_tune, args.model_draws, args.large_tune,
                     args.large_draws)
    if "generic" in phases:
        phase_generic(dev)
    if "interpret" in phases:
        if fit is None:     # without phase sample: its Friedman run alone
            X, Y, f_true = friedman(N, PCOLS)

            def friedman_model(pmb):
                mu = pmb.BART("mu", X, Y, m=M, max_depth=DEPTH)
                sigma = pmb.HalfNormal("sigma", 1.0)
                pmb.Normal("y", mu, sigma, observed=Y)
                return mu

            fit = (sample_run(friedman_model, "fused", args.tune,
                              args.draws)[0], X, f_true)
        phase_interpret(dev, fit)
    if "aids" in phases:
        phase_aids(dev)
    if "linlik" in phases:
        phase_linlik(dev, args.tune, args.draws)
    if "mesh" in phases:
        phase_mesh(dev)
    if "examples" in phases:     # after interpret: it imports matplotlib
        phase_examples(dev)
    if "parity" in phases:
        phase_parity(dev)
    if "timing" in phases:
        times = phase_timing(dev, calls, cfg, smi, runs)
    if "profile" in phases:
        phase_profile(dev)
    if "nccl" in phases:
        phase_nccl(dev)

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
