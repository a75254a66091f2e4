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
    "pymc_bart_tpu_torch.ops.bign", "pymc_bart_tpu_torch.ops._build",
    "pymc_bart_tpu_torch.ops.sums",
    "pymc_bart_tpu_torch.sampler.pgbart", "pymc_bart_tpu_torch.sampler.hmc",
    "pymc_bart_tpu_torch.sampler.nuts", "pymc_bart_tpu_torch.sampler.compound",
    "pymc_bart_tpu_torch.sampler.rejuvenate",
    "pymc_bart_tpu_torch.models.expr",
    "pymc_bart_tpu_torch.models.distributions",
    "pymc_bart_tpu_torch.models.model",
    "pymc_bart_tpu_torch.models.inference_data",
    "pymc_bart_tpu_torch.models.predictive",
    "pymc_bart_tpu_torch.utils.posterior",
    "pymc_bart_tpu_torch.utils.diagnostics",
    "pymc_bart_tpu_torch.utils.stats", "pymc_bart_tpu_torch.utils.codec",
    "pymc_bart_tpu_torch.utils.interpret",
    "pymc_bart_tpu_torch.utils.importance",
    "pymc_bart_tpu_torch.utils.plots",
    "pymc_bart_tpu_torch.utils.checkpoint",
    "pymc_bart_tpu_torch.parallel.mesh",
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
                     if m.split(".")[0] in ("jax", "jaxlib", "pymc_bart_tpu",
                                            "matplotlib", "scipy"))
        assert not bad, bad
        assert "torch" in sys.modules
        print("clean")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_module_list_covers_every_port_module():
    """A module added to the port must be added to ``MODULES`` (packages'
    ``__init__`` files are imported with their modules)."""
    found = {".".join(path.relative_to(ROOT).with_suffix("").parts)
             for path in (ROOT / "pymc_bart_tpu_torch").rglob("*.py")
             if path.name != "__init__.py"}
    assert found <= set(MODULES), sorted(found - set(MODULES))
    assert "pymc_bart_tpu_torch.ops.bign" in found


def test_sources_import_only_torch_and_numpy():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|pymc_bart_tpu|scipy)\b",
                     re.M)
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


# the JAX package's public names that the port does not export yet: none
# since the interpretability functions came over
NOT_PORTED = set()


def test_port_exports_the_public_names_of_the_jax_package():
    import pymc_bart_tpu
    import pymc_bart_tpu_torch

    port = set(pymc_bart_tpu_torch.__all__)
    assert set(pymc_bart_tpu.__all__) - NOT_PORTED <= port, sorted(
        set(pymc_bart_tpu.__all__) - NOT_PORTED - port)
    assert not NOT_PORTED & port, sorted(NOT_PORTED & port)
    for name in port:
        assert hasattr(pymc_bart_tpu_torch, name), name
