"""Where a block of the growth-round kernel spends its cycles.

    python3 scripts/grow_phase_clocks.py

Needs one NVIDIA GPU and ``nvcc``.  Copies ``pymc_bart_tpu_torch`` into a
temporary directory, adds to its ``csrc/grow.cu`` a ``clock64()`` stamp by
thread 0 at the kernel's start, after each of its barriers and at its end,
and the ``%globaltimer`` at start and end, then builds and loads that copy
and runs the growth rounds of one tree update at the main shapes (C=4, P=20,
n=1000, p=10; ``chip_smoke.main_path_inputs``) for the constant and the
linear response.  Prints the card's name, power limit and SM clock, then one
JSON line per (response, level) for d = 0, 3, 5: the cycles of each phase
(node decisions; pass A, the staged rows and the arg-max; the split values;
pass B, routing and the keyed sums; the children; pass C up to the final
barrier; the tail) as the mean and the maximum over the blocks, the
launch's spread of block starts and its last block's end in ns, and the
device time of the stamped build.
"""

from __future__ import annotations

import ctypes
import importlib
import json
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

PHASES = ("node decisions", "pass A", "split values", "pass B", "children",
          "pass C", "tail")
SLOTS = 16  # stamps per block; the last two hold %globaltimer
HEAD = '''
__device__ long long g_clk[65536 * 16];
__device__ __forceinline__ long long gtimer() {
  long long v; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v)); return v; }
#define STAMP(j) do { if (threadIdx.x == 0) g_clk[blockIdx.x * 16 + (j)] = clock64(); } while (0)
'''
TAIL = '''
extern "C" int grow_read_clocks(long long* out, int count) {
  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(long long) * count);
}
'''


def stamped(src: str) -> str:
    src = src.replace("namespace {\n", "namespace {\n" + HEAD, 1)
    i0 = src.index("grow_round_kernel(const GrowArgs a) {")
    i1 = src.index("}  // namespace")
    parts = src[i0:i1].split("__syncthreads();")
    count = len(parts) - 1
    assert count == len(PHASES) - 1
    body = parts[0] + "".join(f"__syncthreads();\n  STAMP({j});" + part
                              for j, part in enumerate(parts[1:], start=1))
    body = body.replace(
        "  Smem s;\n",
        "  if (threadIdx.x == 0) g_clk[blockIdx.x * 16 + 14] = gtimer();\n"
        "  STAMP(0);\n  Smem s;\n", 1)
    end = "    a.ll_o[c * P + pi] = -0.5f * (float)tot;\n"
    assert end in body
    body = body.replace(end, end + f"    STAMP({count + 1});\n"
                        "    g_clk[blockIdx.x * 16 + 15] = gtimer();\n")
    return src[:i0] + body + src[i1:] + TAIL


def main():
    if not torch.cuda.is_available():
        print("grow_phase_clocks: no CUDA device is present", file=sys.stderr)
        return 1
    tmp = Path(tempfile.mkdtemp(prefix="grow_clocks_"))
    dst = tmp / "grow_clocks"
    shutil.copytree(ROOT / "pymc_bart_tpu_torch", dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = dst / "csrc" / "grow.cu"
    path.write_text(stamped(path.read_text()))
    sys.path.insert(0, str(tmp))
    grow = importlib.import_module("grow_clocks.ops.grow")
    lib = importlib.import_module("grow_clocks.ops._build").load("grow")
    lib.grow_read_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.grow_read_clocks.restype = ctypes.c_int
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    blocks = cs.C * cs.P
    for response in ("constant", "linear"):
        calls = cs.main_path_inputs(dev, 0, response, warm_impl=None)[0]
        for a, kw in calls["grow"]:
            if kw["d"] not in (0, 3, 5):
                continue
            for _ in range(3):                 # the last of warm launches
                grow.grow_round_kernel(*a, **kw)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (blocks * SLOTS))()
            if lib.grow_read_clocks(buf, blocks * SLOTS) != 0:
                raise RuntimeError("could not read the clocks")
            arr = np.frombuffer(buf, dtype=np.int64).reshape(blocks, SLOTS)
            cyc = np.diff(arr[:, :len(PHASES) + 1], axis=1)
            t0 = arr[:, 14].min()
            print(json.dumps({
                "response": response, "d": kw["d"],
                "cycles_mean": {p: int(v) for p, v in
                                zip(PHASES, cyc.mean(axis=0))},
                "cycles_max": {p: int(v) for p, v in
                               zip(PHASES, cyc.max(axis=0))},
                "block_cycles_mean": int(cyc.sum(axis=1).mean()),
                "block_cycles_max": int(cyc.sum(axis=1).max()),
                "start_spread_ns": int(arr[:, 14].max() - t0),
                "last_end_ns": int(arr[:, 15].max() - t0),
                "stamped_ms": cs.cuda_ms(
                    lambda: grow.grow_round_kernel(*a, **kw))[0]}),
                flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
