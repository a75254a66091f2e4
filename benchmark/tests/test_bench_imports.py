"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port."""

import ast
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pymc_bart_tpu"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not (_imports(path) & FORBIDDEN), path


def test_reference_imports_only_numpy():
    for path in sorted((ROOT / "benchmark" / "reference").glob("*.py")):
        assert _imports(path) <= {"numpy"}, path


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "friedman1_n1000.fit", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA card" in proc.stderr
