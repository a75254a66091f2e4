"""Device time of the selection kernel with other block sizes, in turns on
the same main-path inputs.

    python3 scripts/select_variants.py [--parent DIR]

Needs one NVIDIA GPU and ``nvcc``.  Copies ``pymc_bart_tpu_torch`` into a
temporary directory once per variant, each with one text edit of
``csrc/select.cu``, and builds and loads each under a package name of its
own:

* ``source``: the kernel as committed (512 threads a block);
* ``threads_1024``, ``threads_256``: other block sizes (fewer or more rows a
  thread, more or fewer warps in every reduction);
* ``parent`` (with ``--parent DIR``): the package in ``DIR``, for example the
  parent commit's unpacked by ``git archive`` (constant response only when
  its kernel takes no other).

Every variant of this source must return the same bits; the script checks
that.  Prints the card's name and power limit, then one JSON line per
response (constant, linear): per variant the device ms (``chip_smoke.cuda_ms``:
the queue kept full) and the call ms (an idle card, the wrapper's host cost
included) of the selection call of one tree update at C=4, P=20, n=1000,
p=10, S=127, R=5 (``chip_smoke.main_path_inputs``), in turns both ways.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
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


def threads(n):
    def edit(src):
        out, count = re.subn(r"constexpr int kThreads = \d+;",
                             f"constexpr int kThreads = {n};", src)
        assert count == 1
        return out
    return edit


VARIANTS = {"source": None, "threads_1024": threads(1024),
            "threads_256": threads(256)}


def load_variant(name, package: Path, edit, tmp: Path):
    root = tmp / name
    dst = root / f"select_{name}"
    shutil.copytree(package, dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if edit is not None:
        path = dst / "csrc" / "select.cu"
        path.write_text(edit(path.read_text()))
    sys.path.insert(0, str(root))
    mod = importlib.import_module(f"select_{name}.ops.select")
    importlib.import_module(f"select_{name}.ops._build").build_all(["select"])
    mod._lib()
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout's pymc_bart_tpu_torch to time too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("select_variants: no CUDA device is present", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    tmp = Path(tempfile.mkdtemp(prefix="select_variants_"))
    mods = {name: load_variant(name, ROOT / "pymc_bart_tpu_torch", edit, tmp)
            for name, edit in VARIANTS.items()}
    if args.parent is not None:
        mods["parent"] = load_variant(
            "parent", args.parent.resolve() / "pymc_bart_tpu_torch", None, tmp)
    print(cs.nvidia_smi_line(), flush=True)
    for response in ("constant", "linear"):
        a, kw = cs.main_path_inputs(dev, 0, response,
                                    warm_impl=None)[0]["select"][0]
        names = [n for n in mods if n != "parent" or response == "constant"
                 or "response" in inspect.signature(
                     mods[n].select_refine_kernel).parameters]
        ref = mods["source"].select_refine_kernel(*a, **kw)
        for n in names:
            got = mods[n].select_refine_kernel(*a, **kw)
            torch.cuda.synchronize()
            if n != "parent" and not all(
                    torch.equal(g.view(torch.int32) if g.is_floating_point()
                                else g,
                                w.view(torch.int32) if w.is_floating_point()
                                else w)
                    for g, w in zip(got, ref)):
                raise AssertionError(f"{n} ({response}) differs from the "
                                     "source")
        dev_ms = {n: [] for n in names}
        call_ms = {n: [] for n in names}
        for n in names + names[::-1]:     # in turns, both ways
            d_ms, c_ms = cs.cuda_ms(
                lambda: mods[n].select_refine_kernel(*a, **kw))
            dev_ms[n].append(d_ms)
            call_ms[n].append(c_ms)
        print(json.dumps({response: {
            n: dict(ms=float(np.mean(dev_ms[n])),
                    call_ms=float(np.mean(call_ms[n])),
                    ms_each=dev_ms[n]) for n in names}}), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
