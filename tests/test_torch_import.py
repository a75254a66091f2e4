"""The port stands alone: importing it loads neither JAX nor the JAX package,
and without a CUDA device its entry points raise rather than run on the CPU."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

MODULES = [
    "pymc_bart_tpu_torch", "pymc_bart_tpu_torch.config",
    "pymc_bart_tpu_torch.convert", "pymc_bart_tpu_torch.ops.trees",
    "pymc_bart_tpu_torch.ops.predict", "pymc_bart_tpu_torch.ops.resample",
    "pymc_bart_tpu_torch.ops.grow", "pymc_bart_tpu_torch.ops.smc",
    "pymc_bart_tpu_torch.ops.select", "pymc_bart_tpu_torch.ops.draw",
    "pymc_bart_tpu_torch.ops._build",
    "pymc_bart_tpu_torch.sampler.pgbart", "pymc_bart_tpu_torch.sampler.hmc",
    "pymc_bart_tpu_torch.sampler.nuts", "pymc_bart_tpu_torch.sampler.compound",
    "pymc_bart_tpu_torch.models.expr",
    "pymc_bart_tpu_torch.models.distributions",
    "pymc_bart_tpu_torch.models.model",
    "pymc_bart_tpu_torch.models.inference_data",
    "pymc_bart_tpu_torch.utils.posterior",
    "pymc_bart_tpu_torch.utils.diagnostics",
]


def _run(code):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)


def test_import_loads_neither_jax_nor_the_jax_package():
    res = _run(f"""
        import importlib, sys
        for name in {MODULES!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "pymc_bart_tpu"))
        assert not bad, bad
        assert "torch" in sys.modules
        print("clean")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_sources_import_only_torch_and_numpy():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|pymc_bart_tpu)\b", re.M)
    files = list((ROOT / "pymc_bart_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        assert not pat.search(path.read_text()), path


def test_sample_without_device_raises_where_there_is_no_gpu():
    import torch

    import pymc_bart_tpu_torch as pmb

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pmb.Model():
        mu = pmb.BART("mu", [[0.0], [1.0], [2.0]], [0.0, 1.0, 2.0], m=2)
        pmb.Normal("y", mu, 1.0, observed=[0.0, 1.0, 2.0])
        with pytest.raises(RuntimeError, match="CUDA"):
            pmb.sample(tune=1, draws=1, chains=1)
        with pytest.raises(RuntimeError, match="CUDA"):
            pmb.sample(tune=1, draws=1, chains=1, device="cuda")


def test_chip_smoke_fails_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
