"""One of the nine ``bench.py`` models through the ``sample()`` of either
package at a chosen budget: the port's parity rows against the JAX package's
own sampler at a matched budget, seed and size.

    python3 scripts/parity_matched.py --package {jax,port} --row NAME
        [--tune T] [--draws D] [--chains C] [--seed S]
        [--ancestor-sampling {0,1}] [--posterior-dtype float16|float32]

``NAME`` is a row of ``chip_smoke.parity_rows`` (friedman, bikes, logistic,
heteroscedastic, highdim_p1000, large_n_50k, large_n_logistic_50k,
friedman_linear, het_joint); the budget defaults to the bench's.  The model,
data, quality and settings are the row's (``posterior_dtype="float16"``,
``chunk_size`` a quarter of the draws).  ``--package jax`` runs the JAX
package on the CPU (without a TPU it takes its XLA route); ``--package port``
runs ``pymc_bart_tpu_torch`` on the CUDA device.
``--ancestor-sampling`` and ``--posterior-dtype`` (``float32``: no
half-precision storage) override the row's settings.  Prints one
JSON line: the row's quality, and for a regression row the posterior mean of
sigma beside the root-mean-square residual of the draws themselves (what
sigma's conditional posterior sees), the posterior spread of the BART
values, the largest R-hat of ``bench.py``'s rows, seconds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--row", required=True)
    ap.add_argument("--tune", type=int)
    ap.add_argument("--draws", type=int)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ancestor-sampling", type=int, choices=(0, 1))
    ap.add_argument("--posterior-dtype", default="float16",
                    choices=("float16", "float32"))
    args = ap.parse_args(argv)

    import chip_smoke as cs

    rows = {r[0]: r for r in cs.parity_rows()}
    name, build, kw, quality, _band, jax_record, _kernels = rows[args.row]
    kw = dict(kw)
    kw["tune"] = kw["tune"] if args.tune is None else args.tune
    kw["draws"] = kw["draws"] if args.draws is None else args.draws
    if args.ancestor_sampling is not None:
        kw["ancestor_sampling"] = bool(args.ancestor_sampling)
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import pymc_bart_tpu as pmb
        device = "cpu"
    else:
        import pymc_bart_tpu_torch as pmb
        device = "cuda"
    t0 = time.perf_counter()
    with pmb.Model():
        rv = build(pmb)
        idata = pmb.sample(chains=args.chains, random_seed=args.seed,
                           chunk_size=max(kw["draws"] // 4, 1),
                           posterior_dtype=(None if args.posterior_dtype
                                            == "float32" else "float16"),
                           convergence_checks=False, **kw)
    seconds = time.perf_counter() - t0
    out = dict(package=args.package, device=device, row=name,
               chains=args.chains, seed=args.seed,
               posterior_dtype=args.posterior_dtype,
               settings={k: (list(v) if isinstance(v, tuple) else v)
                         for k, v in kw.items()},
               quality=quality(idata), max_rhat=cs.max_rhat(idata, rv.name),
               jax_bench_full=jax_record, seconds=seconds)
    post = np.asarray(idata.posterior[rv.name].values, np.float64)
    if "sigma" in idata.posterior:
        out["draw_residual_rms"] = float(np.sqrt(np.mean(
            (post - np.asarray(rv.Y, np.float64)) ** 2)))
        out["sigma_mean"] = float(np.asarray(idata.posterior["sigma"].values,
                                             np.float64).mean())
    out["posterior_spread_rms"] = float(np.sqrt(np.mean(
        post.var(axis=(0, 1)))))
    if args.package == "port":
        import torch

        out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
