"""Tests of the benchmark.  Those that need a CUDA card carry the marker
``card``; they skip elsewhere, decided inside the ``card`` fixture.

    python -m pytest benchmark/tests -q            # here: the CPU tests
    python -m pytest benchmark/tests -q -m card    # on the card
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a cell small enough for the CPU: the n=1000 configuration's model at a
# fifth of its rows, a fifth of its trees and a tenth of its steps
TINY_CONFIG = dict(n=200, m=10, num_particles=10, num_refinements=2,
                   tune=20, draws=40)
TINY_LIMITS = {"structure_errors": 0, "mu_gap": 1e-4, "sigma_gap": 0.1,
               "rmse_f": 3.5}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (runs the cells at their sizes)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


def copy_benchmark(dst):
    """A checkout at ``dst`` holding ``BENCHMARK.json`` and the benchmark's
    folder (the port is imported from the repository)."""
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def add_cell(root, name, config, traffic, chips=1, limits=None,
             trace_steps=10):
    """Add a tiny configuration and a cell on it to the checkout at
    ``root``, as a later change would: new files and new entries only."""
    bench = root / "benchmark"
    base = json.loads((bench / "configs" / "friedman1_n1000.json").read_text())
    base.update(TINY_CONFIG)
    (bench / "configs" / f"{config}.json").write_text(json.dumps(base))
    cell = {"config": config, "traffic": traffic, "chips": chips,
            "why": "a tiny cell for the CPU tests",
            "warmup": {"tune": 2, "draws": 4}, "trace_steps": trace_steps,
            "check": {"draws_per_fit": 8, "rows_per_fit": 16},
            "limits": dict(TINY_LIMITS, **(limits or {}))}
    (bench / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": config, "source": "test",
                            "file": f"benchmark/configs/{config}.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": traffic, "chips": chips,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return name


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with the cell ``tiny.fit`` added."""
    root = copy_benchmark(tmp_path)
    add_cell(root, "tiny.fit", "tiny", "refit")
    return root
