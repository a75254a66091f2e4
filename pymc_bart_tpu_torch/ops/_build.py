"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), is
compiled by ``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` at
first use, and is loaded with ``ctypes``.  Pointers come from
``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``.  Nothing here runs when the
module is imported; a build or load failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNEL_SOURCES = ("grow", "smc", "select", "draw", "bign")
# these kernels round their float32 arithmetic where their plain PyTorch
# versions do (one rounding per operation), so they are compiled without
# fused multiply-add
EXTRA_FLAGS = {"bign": ("-fmad=false",), "draw": ("-fmad=false",),
               "grow": ("-fmad=false",)}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the kernels under csrc/")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(EXTRA_FLAGS.get(name, ())).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path, verbose: bool):
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC_DIR),
           *EXTRA_FLAGS.get(name, ()), "-o", str(out),
           str(CSRC_DIR / f"{name}.cu")]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    return cmd


def build_all(names: Iterable[str] = KERNEL_SOURCES, verbose: bool = False):
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together.  Returns {name: compiler output}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (subprocess.Popen(
            _command(name, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                build_all([name])
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
        return lib


def check_launch(err: int, what: str):
    """Raise if a kernel launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def current_stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
