"""Where a step of the whole-step PGBART kernel spends its cycles.

    python3 scripts/draw_phase_clocks.py [--steps 20]

Needs one NVIDIA GPU and ``nvcc``.  Compiles
``pymc_bart_tpu_torch/csrc/draw.cu`` with ``-DDRAW_PHASE_CLOCKS`` (the
``STAMP`` points of the kernel then add ``clock64()`` differences into a
device array) into the package's git-ignored build directory, hands that
library to ``ops/draw.py`` in place of the production build, and runs the
gauss and bernoulli cases of ``chip_smoke.py`` at the main shapes with
generated Gumbels.  Prints the card's name and power limit, then one JSON line
per case: cycles per step of thread 0 of the middle block of chain 0's
cluster, by phase, their shares, and the device time of the stamped build.
The two probe entries (16 bare cluster barriers, 16 bare block barriers after
the step) price a barrier nobody waits at.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pymc_bart_tpu_torch.ops import _build  # noqa: E402

PHASES = (
    "prepare tree", "particle set-up", "ancestor copy + node decisions",
    "gumbel arg-max + split value", "child sums", "commit level",
    "routing + log-likelihood", "cluster barrier", "smc bookkeeping",
    "leaf sums + current ll", "refinement sweeps", "commit tree", "finish",
    "ancestor copy alone", "16 cluster barriers", "16 block barriers")
PROBES = PHASES[-2:]


def build_with_clocks() -> ctypes.CDLL:
    """``draw.cu`` with phase clocks, as the production build but for the
    preprocessor symbol."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "libdraw-phase-clocks.so"
    cmd = _build._command("draw", out, verbose=False)
    cmd.insert(1, "-DDRAW_PHASE_CLOCKS")
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(out))
    lib.pgbart_step_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pgbart_step_clocks.restype = ctypes.c_int
    return lib


def clocks(lib, reset_for_rank=None):
    out = (ctypes.c_longlong * 16)()
    reset = 0 if reset_for_rank is None else 1 + int(reset_for_rank)
    _build.check_launch(lib.pgbart_step_clocks(out, reset), "phase clocks")
    return dict(zip(PHASES, out))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    steps = ap.parse_args(argv).steps
    if not torch.cuda.is_available():
        print("draw_phase_clocks: no CUDA device is present", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    lib = build_with_clocks()
    _build._libs["draw"] = lib          # ops/draw.py now loads this build
    for name in ("gauss_draw", "bernoulli"):
        case = cs.fused_case(dev, name)
        gen = torch.Generator(device=dev).manual_seed(5)
        state = cs.grown_state(case, gen, dev)
        rands = cs.fused_rands(case, gen, False, dev, row_gumbels=False)
        plan = cs.fused_plan(case)
        rank = plan.cluster // 2
        for _ in range(3):
            cs.fused_step(case, state, rands, False, "kernel")
        torch.cuda.synchronize()
        clocks(lib, reset_for_rank=rank)
        for _ in range(steps):
            cs.fused_step(case, state, rands, False, "kernel")
        torch.cuda.synchronize()
        cycles = {k: v / steps for k, v in clocks(lib).items()}
        total = sum(v for k, v in cycles.items() if k not in PROBES)
        print(json.dumps(dict(
            case=name, steps=steps, rank=rank, cluster=plan.cluster,
            cycles_per_step=cycles, cycles_per_step_total=total,
            share={k: v / total for k, v in cycles.items()
                   if k not in PROBES},
            stamped_ms=cs.cuda_ms(lambda: cs.fused_step(
                case, state, rands, False, "kernel"))[0])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
