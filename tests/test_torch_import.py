"""The port stands alone: importing it loads neither JAX nor the JAX package,
and without a CUDA device its entry points raise rather than run on the CPU."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
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


@pytest.mark.parametrize("sub", ["ops", "models", "sampler", "utils"])
def test_port_subpackage_exports_the_names_of_the_jax_subpackage(sub):
    import importlib

    jax_names = set(importlib.import_module(f"pymc_bart_tpu.{sub}").__all__)
    port = importlib.import_module(f"pymc_bart_tpu_torch.{sub}")
    assert jax_names <= set(port.__all__), sorted(jax_names
                                                  - set(port.__all__))
    for name in port.__all__:
        assert hasattr(port, name), name


def test_depth_of_slot_matches_jax():
    from pymc_bart_tpu.ops.trees import depth_of_slot as jax_depth

    from pymc_bart_tpu_torch.ops import depth_of_slot

    got = [depth_of_slot(s) for s in range(2**12 + 1)]
    assert got == [jax_depth(s) for s in range(2**12 + 1)]
    assert got[0] == 0 and got[2**12 - 2] == 11 and got[2**12 - 1] == 12


def _forest_and_rows(rng, rules, m=6, depth=4, n=80):
    """A random forest over ``rules`` (int32[p]) and rows with NaNs; the
    categorical columns hold small integer categories."""
    import torch

    p = len(rules)
    S = 2 ** (depth + 1) - 1
    sv = np.full((m, S), -1, np.int32)
    for j in range(m):
        for s in range(2**depth - 1):
            if (s == 0 or sv[j, (s - 1) // 2] >= 0) and rng.random() < 0.75:
                sv[j, s] = rng.integers(0, p)
    cont = rules[np.clip(sv, 0, p - 1)] == 0
    sl = np.where(cont, rng.normal(size=(m, S)),
                  rng.integers(0, 4, size=(m, S))).astype(np.float32)
    X = rng.normal(size=(n, p)).astype(np.float32)
    cat = rules > 0
    X[:, cat] = rng.integers(0, 4, size=(n, int(cat.sum())))
    X[rng.random((n, p)) < 0.1] = np.nan
    t = torch.from_numpy
    return (t(sv), t(sl), t(rng.integers(-2**31, 2**31, size=(m, S),
                                         dtype=np.int64).astype(np.int32)),
            t(rng.normal(size=(m, S, 1)).astype(np.float32)),
            t(rng.integers(0, 9, size=(m, S)).astype(np.float32)),
            t(X), t(rules))


def test_descent_through_the_shared_continuous_only_rule_is_bit_for_bit():
    """``ops/predict.py``'s descents (the leaf index and the excluded
    prediction) give the same results through ``decide_left``'s
    continuous-only rule (``all_cont=True``) as through the full rule
    (``False``) on a forest of continuous rules alone; a forest with one-hot
    and subset rules keeps the full rule (the shortcut would route it
    otherwise), and ``all_cont=None`` reads the right one from the rules.
    Rejuvenation decides rows by the same function."""
    import torch

    from pymc_bart_tpu_torch.ops import predict, trees
    from pymc_bart_tpu_torch.sampler import rejuvenate

    assert rejuvenate.decide_left is trees.decide_left
    rng = np.random.default_rng(11)
    mask = torch.tensor([False, True, False, False])

    def descents(sv, sl, st, leaf, count, X, r, all_cont):
        return (predict.tree_leaf_index(sv, sl, st, X, r, 4,
                                        all_cont=all_cont),
                predict.tree_predict_excluded(sv, sl, st, leaf, count,
                                              torch.zeros_like(leaf), X, r,
                                              mask, 4, all_cont=all_cont))

    for rules, shared in ((np.zeros(4, np.int32), True),
                          (np.array([0, 1, 2, 2], np.int32), False)):
        args = _forest_and_rows(rng, rules)
        assert trees.rules_all_continuous(rules) is shared
        assert trees.rules_all_continuous(args[-1]) is shared
        full = descents(*args, False)
        auto = descents(*args, None)
        forced = descents(*args, True)
        for a, b, c in zip(auto, full, forced):
            assert torch.equal(a, b)
            assert torch.equal(c, b) is shared
