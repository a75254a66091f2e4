"""The selection kernel and the linear model's per-round step of two
checkouts, in turns on one card.

    python3 scripts/select_turns.py --parent DIR [--turns 1]

Needs one NVIDIA GPU and ``nvcc``.  ``DIR`` is another checkout of the repo,
for example the parent commit's unpacked by ``git archive``.  Each run is a
subprocess in its checkout (which builds and loads its own kernels), in the
order parent, this, this, parent (``--turns`` repeats it), and measures:

* ``select_ms`` / ``select_call_ms``: the selection kernel on the main
  path's selection call (``chip_smoke.main_path_inputs``: C=4, P=20,
  n=1000, p=10, S=127, constant response), device time with the queue kept
  full and the time of a call issued to an idle card (``chip_smoke.cuda_ms``);
* ``linear_step``: one PGBART step of the linear Friedman model at full width
  as ``sample()`` issues it (``chip_smoke.linear_step_times``: host clock,
  device busy time and device events a step by ``torch.profiler``).

Prints one JSON line per run, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

RUN = """
import json, torch
import chip_smoke as cs
from pymc_bart_tpu_torch.ops import _build
from pymc_bart_tpu_torch.ops.select import select_refine
_build.build_all()
dev = torch.device("cuda")
calls, _cfg = cs.main_path_inputs(dev)
a, kw = calls["select"][0]
ms, call_ms = cs.cuda_ms(lambda: select_refine(*a, impl="kernel", **kw))
step = cs.linear_step_times(dev)
print(json.dumps(dict(select_ms=ms, select_call_ms=call_ms,
                      linear_step=step)))
"""


def run(root: Path) -> dict:
    res = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                         capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, PYTHONPATH=str(root)))
    if res.returncode != 0:
        raise RuntimeError(f"{root}: exit {res.returncode}\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args(argv)
    parent = args.parent.resolve()
    for _ in range(args.turns):
        for name, root in (("parent", parent), ("this", ROOT),
                           ("this", ROOT), ("parent", parent)):
            print(json.dumps(dict(run=name, **run(root))), flush=True)
    print(cs.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
