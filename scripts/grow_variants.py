"""Device time of the growth-round kernel's design alternatives, in turns on
the same main-path inputs.

    python3 scripts/grow_variants.py [--parent DIR]

Needs one NVIDIA GPU and ``nvcc``.  Copies ``pymc_bart_tpu_torch`` into a
temporary directory once per variant, each with one text edit of
``csrc/grow.cu``, and builds and loads each under a package name of its own:

* ``source``: the kernel as committed (1024 threads a block);
* ``threads_512``, ``threads_256``: fewer threads a block;
* ``cas_atomics``: each warp group's sum added by a 64-bit shared
  ``atomicAdd`` (a compare-and-swap loop on this card) instead of ``add64``;
* ``lane_atomics``: no grouping by warp: every row adds its own values by
  64-bit shared atomics;
* ``parent`` (with ``--parent DIR``): the package in ``DIR``, for example the
  parent commit's unpacked by ``git archive``.

Every variant of this source must return the same bits (its sums are
integers, which have no order); the script checks that.  Prints one JSON line
per response (constant, linear): per variant the mean device ms
(``chip_smoke.cuda_ms``: the queue kept full) over the six levels of one tree
update at C=4, P=20, n=1000, p=10 (``chip_smoke.main_path_inputs``), the call
ms (an idle card, the wrapper's host cost included) and the device us by
level; then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PASS_B = "    if (frozen) continue;  // (uniform over the block)"
PHASE_D = "  __syncthreads();\n\n  // ---- phase d"
LANE_ATOMICS = '''    if (frozen || key < 0) continue;
    atomicAdd(&s.cnt[key], 1);
    for (int kk = 0; kk < k; ++kk) {
      const float r = kk == 0 ? r0 : resid[(size_t)kk * n + i];
      atomicAdd((unsigned long long*)&s.acc[kk * G2 + key],
                (unsigned long long)to_fixed(r, r_scale));
    }
    if (lin) {
      const double xd = isnan(x) ? 0.0 : (double)x;
      atomicAdd((unsigned long long*)&s.acc[k * G2 + key],
                (unsigned long long)to_fixed(xd, s.scl[g]));
      atomicAdd((unsigned long long*)&s.acc[(k + 1) * G2 + key],
                (unsigned long long)to_fixed(xd * xd, s.scl[G + g]));
      for (int kk = 0; kk < k; ++kk) {
        const float r = kk == 0 ? r0 : resid[(size_t)kk * n + i];
        atomicAdd((unsigned long long*)&s.acc[(k + 2 + kk) * G2 + key],
                  (unsigned long long)to_fixed((double)r * xd,
                                               s.scl[2 * G + g]));
      }
    }
  }
'''


def threads(n):
    def edit(src):
        out, count = re.subn(r"constexpr int kThreads = \d+;",
                             f"constexpr int kThreads = {n};", src)
        assert count == 1
        return out
    return edit


def cas_atomics(src):
    out, count = re.subn(
        r"add64\(&s\.acc\[([^\]]+)\], sum\)",
        r"atomicAdd((unsigned long long*)&s.acc[\1], (unsigned long long)sum)",
        src)
    assert count == 4
    return out


def lane_atomics(src):
    i0, i1 = src.index(PASS_B), src.index(PHASE_D)
    return src[:i0] + LANE_ATOMICS + src[i1:]


VARIANTS = {"source": None, "threads_512": threads(512),
            "threads_256": threads(256), "cas_atomics": cas_atomics,
            "lane_atomics": lane_atomics}


def load_variant(name, package: Path, edit, tmp: Path):
    root = tmp / name
    dst = root / f"grow_{name}"
    shutil.copytree(package, dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if edit is not None:
        path = dst / "csrc" / "grow.cu"
        path.write_text(edit(path.read_text()))
    sys.path.insert(0, str(root))
    mod = importlib.import_module(f"grow_{name}.ops.grow")
    importlib.import_module(f"grow_{name}.ops._build").build_all(["grow"])
    mod._lib()
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout's pymc_bart_tpu_torch to time too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grow_variants: no CUDA device is present", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    tmp = Path(tempfile.mkdtemp(prefix="grow_variants_"))
    mods = {name: load_variant(name, ROOT / "pymc_bart_tpu_torch", edit, tmp)
            for name, edit in VARIANTS.items()}
    if args.parent is not None:
        mods["parent"] = load_variant("parent", args.parent.resolve(), None,
                                      tmp)
    names = list(mods)
    print(cs.nvidia_smi_line(), flush=True)
    for response in ("constant", "linear"):
        calls = cs.main_path_inputs(dev, 0, response, warm_impl=None)[0]
        dev_ms = {n: [] for n in names}
        call_ms = {n: [] for n in names}
        for a, kw in calls["grow"]:
            ref = mods["source"].grow_round_kernel(*a, **kw)
            for n in names:
                got = mods[n].grow_round_kernel(*a, **kw)
                torch.cuda.synchronize()
                if n != "parent" and not all(
                        torch.equal(torch.nan_to_num(g, nan=7.0),
                                    torch.nan_to_num(w, nan=7.0))
                        for g, w in zip(got, ref)):
                    raise AssertionError(f"{n} ({response}, d={kw['d']}) "
                                         "differs from the source")
            for n in names + names[::-1]:     # in turns, both ways
                d_ms, c_ms = cs.cuda_ms(
                    lambda: mods[n].grow_round_kernel(*a, **kw))
                dev_ms[n].append(d_ms)
                call_ms[n].append(c_ms)
        print(json.dumps({response: {
            n: dict(ms=float(np.mean(dev_ms[n])),
                    call_ms=float(np.mean(call_ms[n])),
                    by_level_us=[round(1e3 * float(np.mean(
                        dev_ms[n][2 * i:2 * i + 2])), 3)
                        for i in range(len(dev_ms[n]) // 2)])
            for n in names}}), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
