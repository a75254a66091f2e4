"""A model the benchmark has never run is added as files alone: a tiny
two-output BART without ``sigma`` (joint trees, ``shape=(2, n)``, the mean
and the scale of a heteroscedastic Normal), with its check, generator,
configuration and cell, runs through the harness's whole run on the CPU,
passes its check, and fails it under a planted fault."""

import json
import sys
import time

import pytest

from conftest import copy_benchmark

from benchmark.harness import cell as cellmod
from benchmark.harness.faults import FAULTS

MODEL = '''
"""Joint two-output BART: Normal(w[0], |w[1]| + 0.05)."""

CHECK = "het_joint_check"
DRAWS = ("w",)


def build(pmb, config, X, Y):
    with pmb.Model() as model:
        w = pmb.BART("w", X, Y, m=config["m"],
                     max_depth=config["max_depth"], shape=(2, len(Y)))
        pmb.Normal("y", w[0], pmb.math.abs(w[1]) + config["scale_floor"],
                   observed=Y)
    return model, w
'''

GENERATOR = '''
import numpy as np


def true_f(X):
    X = np.asarray(X, np.float64)
    return np.stack([3 * np.sin(2 * X[:, 0]), 0.2 + 1.5 * (X[:, 1] > 0)])


def generate(n, p, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, p)).astype(np.float32)
    f = true_f(X)
    Y = rng.normal(f[0], scale * f[1]).astype(np.float32)
    return X, Y, f
'''

CHECK = '''
import numpy as np

from . import forest

NUMBERS = ("structure_errors", "w_gap", "rmse_mean")


def numbers(out, data, kw, sizes, rng):
    X, Y, f = data
    C, D = kw["chains"], kw["draws"]
    w, leaf = out["w"], out["leaf"]
    if w.shape != (C, D, 2, len(Y)) or leaf.shape[:2] != (C, D) \\
            or leaf.shape[-1] != 2:
        return {"structure_errors": 1}
    rows = rng.choice(len(Y), size=min(sizes["rows_per_fit"], len(Y)),
                      replace=False)
    ref = forest.predict(out["split_var"], out["split_val"], leaf, X[rows])
    gap = np.max(np.abs(w[..., rows] - ref)) / np.std(Y)
    rmse = np.sqrt(np.mean((w[:, :, 0].mean(axis=(0, 1)) - f[0]) ** 2))
    return {"structure_errors": int(not np.isfinite(w).all()),
            "w_gap": float(gap), "rmse_mean": float(rmse)}
'''

CONFIG = {"generator": "het_joint_data", "n": 120, "p": 2,
          "data_args": {"scale": 1.0}, "seed_offset": 3,
          "model": "het_joint", "m": 8, "max_depth": 6, "scale_floor": 0.05,
          "num_particles": 10, "num_refinements": 2, "batch": [0.1, 0.1],
          "chains": 2, "tune": 20, "draws": 40}
CELL = {"config": "tiny_het", "traffic": "refit", "chips": 1,
        "why": "a tiny two-output cell for the CPU tests",
        "warmup": {"tune": 2, "draws": 4}, "trace_steps": 10,
        "check": {"rows_per_fit": 16},
        "limits": {"structure_errors": 0, "w_gap": 1e-4, "rmse_mean": 3.0}}


@pytest.fixture
def het_root(tmp_path):
    """A copy of the benchmark with the model's five files and its entries
    in ``BENCHMARK.json`` added; no file that was there is edited but
    ``BENCHMARK.json``, which gains entries only."""
    root = copy_benchmark(tmp_path)
    bench = root / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "models" / "het_joint.py").write_text(MODEL)
    (bench / "reference" / "het_joint_data.py").write_text(GENERATOR)
    (bench / "reference" / "het_joint_check.py").write_text(CHECK)
    (bench / "configs" / "tiny_het.json").write_text(json.dumps(CONFIG))
    (bench / "workloads" / "tiny_het.fit.json").write_text(json.dumps(CELL))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_het", "source": "test",
                            "file": "benchmark/configs/tiny_het.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny_het.fit", "config": "tiny_het",
                              "traffic": "refit", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert all(p.read_bytes() == b for p, b in before.items())
    return root


def _run(root, hook=None, trace=0):
    return cellmod.run("tiny_het.fit", 4000000777, 0.0, trace, root=root,
                       t_start=time.time(), device="cpu", hook=hook)


def test_a_two_output_model_added_as_files_passes_its_check(het_root):
    r = _run(het_root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 1, r
    assert list(r["checks"]) == ["structure_errors", "w_gap", "rmse_mean"]
    assert r["checks"]["w_gap"]["value"] < 1e-5
    assert set(r["metrics"]) == {"fit_s", "setup_s"}


@pytest.mark.parametrize("fault", ["answer_altered", "half_rows"])
def test_a_two_output_model_fails_its_check_under_a_fault(het_root, restored,
                                                          fault):
    r = _run(het_root, hook=FAULTS[fault])
    assert not r["correct"] and r["failed"] == r["attempted"]
    assert r["checks"]["w_gap"]["value"] > 1e-4


@pytest.mark.parametrize("limits", [
    {"structure_errors": 0, "w_gap": 1e-4},
    {"structure_errors": 0, "w_gap": 1e-4, "rmse_mean": 3.0, "extra": 1.0}])
def test_limits_that_differ_from_the_check_s_numbers_are_refused(het_root,
                                                                 limits):
    path = het_root / "benchmark" / "workloads" / "tiny_het.fit.json"
    path.write_text(json.dumps(dict(CELL, limits=limits)))
    with pytest.raises(ValueError, match="its model's check reads"):
        _run(het_root)


def test_a_forbidden_module_the_check_loads_while_it_judges_is_seen(
        het_root):
    """A check that loads a forbidden module only when it judges (where no
    scan of its source sees it) shows in the result's ``_forbidden``."""
    path = het_root / "benchmark" / "reference" / "het_joint_check.py"
    path.write_text(CHECK.replace(
        "    X, Y, f = data\n",
        "    import sys, types\n"
        "    sys.modules.setdefault('flax.linen', types.ModuleType('x'))\n"
        "    X, Y, f = data\n", 1))
    assert "flax.linen" not in sys.modules
    try:
        r = _run(het_root)
    finally:
        sys.modules.pop("flax.linen", None)
    assert "flax" in r["_forbidden"]


@pytest.fixture
def restored(monkeypatch):
    """Every callable a fault replaces is put back after the test."""
    from pymc_bart_tpu_torch.sampler import compound, pgbart

    monkeypatch.setattr(pgbart, "pgbart_step", pgbart.pgbart_step)
    monkeypatch.setattr(compound._HostDrain, "finish",
                        compound._HostDrain.__dict__["finish"])
