#!/usr/bin/env python3
"""Run one cell of the benchmark of ``pymc_bart_tpu_torch`` on the card(s)
of this machine and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run it from the root of a checkout.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from the same loop
with spans around the port's layers and one profiled slice.  The run exits
with another code than 0, and prints no result, where this machine has no
CUDA card or fewer than the cell asks for, or where a process of the run
holds ``jax``, ``jaxlib``, ``flax`` or the JAX package ``pymc_bart_tpu``."""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# import the benchmark as a package from the root, never its folder's
# modules by their bare names
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# one thread for each of the host's math libraries, set before any of them
# loads: the run's load is this one process issuing work to the card
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
# every compiler cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _sub)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import cell as cellmod
    from benchmark.harness import registry

    chips = registry.Registry(ROOT).cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {args.workload!r} needs {chips} CUDA "
              f"card(s); this machine has {n}", file=sys.stderr)
        return 2
    result = cellmod.run(args.workload, args.seed, args.seconds, args.trace,
                         root=ROOT, t_start=T0)
    lines = result.pop("_lines")
    notes = result.pop("_notes")
    bad = sorted(set(result.pop("_forbidden")) | set(
        cellmod.forbidden_modules()))
    if bad:
        print(f"benchmark: the run loaded {bad}; the port may not",
              file=sys.stderr)
        return 3
    print(json.dumps({"notes": notes}), file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
