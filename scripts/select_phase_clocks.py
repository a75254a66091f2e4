"""Where a block of the selection kernel spends its cycles.

    python3 scripts/select_phase_clocks.py [--threads N] [--detail]

Needs one NVIDIA GPU and ``nvcc``.  Copies ``pymc_bart_tpu_torch`` into a
temporary directory, adds to its ``csrc/select.cu`` a ``clock64()`` stamp by
thread 0 at the kernel's start, after each of its barriers and at its end,
and the ``%globaltimer`` at start and end (with ``--threads`` also another
block size), then builds and loads that copy and runs the selection call of
one tree update at the main shapes (C=4, P=20, n=1000, p=10, S=127, R=5;
``chip_smoke.main_path_inputs``) for the constant and the linear response.
Prints the card's name, power limit and SM clock, then one JSON line per
response: the cycles of each phase (A: the winner and the rows' loads; B:
the winner's rows, log-likelihood, first proposal and leaf sums; per sweep
its row pass (sweep 0's with the centres and the priors) and its decision;
the outputs) as the mean
over the blocks, the launch's spread of block starts and its last block's
end in ns, and the device time of the stamped build.  ``--detail`` adds
stamps inside phases A and B (thread 0's own progress): A after the winner
(warp 0 stages no rows); B after the slot loads are issued, the row loop,
the row log-likelihood's reduction, the slot loop and the keyed leaf sums.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SLOTS = 32  # stamps per block; the last two hold %globaltimer
HEAD = '''
__device__ long long g_clk[65536 * 32];
__device__ __forceinline__ long long gtimer() {
  long long v; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v)); return v; }
#define STAMP(j) do { if (threadIdx.x == 0) g_clk[blockIdx.x * 32 + (j)] = clock64(); } while (0)
'''
TAIL = '''
extern "C" int select_read_clocks(long long* out, int count) {
  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(long long) * count);
}
'''
# the stamp after each barrier in the order of the source: the phases A and
# B, then the two barriers of sweep r
AFTER = ("1", "2", "3 + 2 * r", "4 + 2 * r")
END = "    pred_o[i] = v;\n  }\n"
# --detail: (anchor in the source, stamp inserted before it, its name)
DETAIL = (
    ("    if (lane == 0) {\n      s_widx = w;", 20, "A winner"),
    ("  int e_r = 0;\n", 22, "B slot loads issued"),
    ("    acc = bart::warp_sum_d(acc);\n    if (lane == 0) s.part[kLikC",
     23, "B row loop"),
    ("  for (int q = t; q < S; q += kThreads) {\n    const int v = one_slot",
     24, "B row reduction"),
    ("  {\n    const double r_scale", 25, "B slot loop"),
)


def detailed(src: str) -> str:
    for anchor, j, _name in DETAIL:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, f"  STAMP({j});\n" + anchor)
    return src


def stamped(src: str, threads=None, detail=False) -> str:
    if detail:
        src = detailed(src)
    if threads is not None:
        src, count = re.subn(r"constexpr int kThreads = \d+;",
                             f"constexpr int kThreads = {threads};", src)
        assert count == 1
    src = src.replace("namespace {\n", "namespace {\n" + HEAD, 1)
    i0 = src.index("select_refine_kernel(const SelectArgs a) {")
    i1 = src.index("}  // namespace")
    parts = src[i0:i1].split("__syncthreads();")
    assert len(parts) - 1 == len(AFTER)
    body = parts[0] + "".join(f"__syncthreads();\n  STAMP({j});" + part
                              for j, part in zip(AFTER, parts[1:]))
    body = body.replace(
        "  Smem s;\n",
        "  if (threadIdx.x == 0) g_clk[blockIdx.x * 32 + 30] = gtimer();\n"
        "  STAMP(0);\n  Smem s;\n", 1)
    assert body.count(END) == 1
    body = body.replace(END, END + "  STAMP(3 + 2 * R);\n"
                        "  if (threadIdx.x == 0) g_clk[blockIdx.x * 32 + 31]"
                        " = gtimer();\n")
    return src[:i0] + body + src[i1:] + TAIL


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=None,
                    help="another block size than the source's")
    ap.add_argument("--detail", action="store_true",
                    help="stamps inside phases A and B")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("select_phase_clocks: no CUDA device is present",
              file=sys.stderr)
        return 1
    tmp = Path(tempfile.mkdtemp(prefix="select_clocks_"))
    dst = tmp / "select_clocks"
    shutil.copytree(ROOT / "pymc_bart_tpu_torch", dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = dst / "csrc" / "select.cu"
    path.write_text(stamped(path.read_text(), args.threads, args.detail))
    sys.path.insert(0, str(tmp))
    select = importlib.import_module("select_clocks.ops.select")
    lib = importlib.import_module("select_clocks.ops._build").load("select")
    lib.select_read_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.select_read_clocks.restype = ctypes.c_int
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    for response in ("constant", "linear"):
        a, kw = cs.main_path_inputs(dev, 0, response,
                                    warm_impl=None)[0]["select"][0]
        R = kw["num_refinements"]
        names = (["A", "B"]
                 + [f"sweep {r} {what}" for r in range(R)
                    for what in ("rows", "decide")] + ["outputs"])
        for _ in range(3):                 # the last of warm launches
            select.select_refine_kernel(*a, **kw)
        torch.cuda.synchronize()
        blocks = cs.C
        buf = (ctypes.c_longlong * (blocks * SLOTS))()
        if lib.select_read_clocks(buf, blocks * SLOTS) != 0:
            raise RuntimeError("could not read the clocks")
        arr = np.frombuffer(buf, dtype=np.int64).reshape(blocks, SLOTS)
        cyc = np.diff(arr[:, :len(names) + 1], axis=1)
        t0 = arr[:, 30].min()
        extra = {}
        if args.detail:  # each stamp against the one before it
            order = [(0, "start")] + [(j, name) for _a, j, name in DETAIL[:1]] \
                + [(1, "A end")] + [(j, name) for _a, j, name in DETAIL[1:]] \
                + [(2, "B end")]
            extra["detail_cycles_mean"] = {
                name: int((arr[:, j] - arr[:, jp]).mean())
                for (jp, _n), (j, name) in zip(order, order[1:])}
        print(json.dumps({**extra,
            "response": response, "threads": args.threads or "source",
            "cycles_mean": {p: int(v) for p, v in
                            zip(names, cyc.mean(axis=0))},
            "block_cycles_mean": int(cyc.sum(axis=1).mean()),
            "block_cycles_max": int(cyc.sum(axis=1).max()),
            "start_spread_ns": int(arr[:, 30].max() - t0),
            "last_end_ns": int(arr[:, 31].max() - t0),
            "stamped_ms": cs.cuda_ms(
                lambda: select.select_refine_kernel(*a, **kw))[0]}),
            flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
