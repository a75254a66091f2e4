"""Run the examples of the PyTorch/CUDA port (``examples/port/``) end to end
on the CPU with a tiny sampling budget: coal, Friedman and the two
classifiers here, the other three in ``test_torch_examples_more.py`` (two
files, so that ``--dist loadfile`` gives them two workers).

The budget is clamped as ``tests/test_examples.py`` clamps the JAX
package's examples (tune and draws at most 15, chains at most 2, no progress
bar), and the interpretability plots as well (``plot_ice`` at most 5
instances and 20 draws, ``plot_pdp`` at most 20 draws): on one CPU thread
the plots would otherwise be this file's long pole.  The card runs the
examples at their own budgets (``chip_smoke.py``, phase ``examples``).

Each example is loaded from its file under a module name of its own: under
``--dist loadfile`` one worker may run this file and ``test_examples.py``,
and ``import coal_disasters`` would hand back the JAX package's example.
"""

import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

PORT_EXAMPLES = Path(__file__).resolve().parent.parent / "examples" / "port"

EXAMPLES = [
    ("coal_disasters", "main"),
    ("friedman_regression", "main"),
    ("classification", "binary"),
    ("classification", "categorical"),
]


def load_example(name):
    """The module of ``examples/port/<name>.py``, freshly executed."""
    spec = importlib.util.spec_from_file_location(
        f"pymc_bart_tpu_torch_example_{name}", PORT_EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def tiny_budget(monkeypatch, one_thread):
    """Clamp ``sample`` and the plots of ``pymc_bart_tpu_torch`` so the
    examples run in seconds on the CPU."""
    import matplotlib

    import pymc_bart_tpu_torch as pmb

    matplotlib.use("Agg")
    real_sample, real_pdp, real_ice = pmb.sample, pmb.plot_pdp, pmb.plot_ice

    def sample(*args, **kwargs):
        kwargs["tune"] = min(int(kwargs.get("tune", 100)), 15)
        kwargs["draws"] = min(int(kwargs.get("draws", 100)), 15)
        kwargs["chains"] = min(int(kwargs.get("chains", 1)), 2)
        kwargs["progressbar"] = False
        return real_sample(*args, **kwargs)

    def plot_pdp(*args, **kwargs):
        kwargs["samples"] = min(int(kwargs.get("samples", 200)), 20)
        return real_pdp(*args, **kwargs)

    def plot_ice(*args, **kwargs):
        kwargs["samples"] = min(int(kwargs.get("samples", 100)), 20)
        kwargs["instances"] = min(int(kwargs.get("instances", 30)), 5)
        return real_ice(*args, **kwargs)

    # the examples call pmb.<name> through the package attribute
    monkeypatch.setattr(pmb, "sample", sample)
    monkeypatch.setattr(pmb, "plot_pdp", plot_pdp)
    monkeypatch.setattr(pmb, "plot_ice", plot_ice)
    yield
    plt = sys.modules.get("matplotlib.pyplot")
    if plt is not None:
        plt.close("all")


def _numbers(out):
    """Every number in an example's returned dict (labels left out)."""
    vals = []
    for v in out.values():
        vals.extend(v if isinstance(v, list) else [v])
    return np.asarray([float(x) for x in vals if not isinstance(x, str)])


@pytest.mark.parametrize("module_name,entry", EXAMPLES,
                         ids=[f"{m}.{e}" for m, e in EXAMPLES])
def test_port_example_runs(module_name, entry, tiny_budget):
    out = getattr(load_example(module_name), entry)(device="cpu")
    assert isinstance(out, dict) and out, out
    assert np.isfinite(_numbers(out)).all(), out
    if module_name == "classification":
        # above a coin for two classes, above chance for three
        chance = 0.5 if entry == "binary" else 1.0 / 3.0
        assert out["accuracy"] > chance, out
        assert 0.0 < out["majority_rate"] <= 1.0, out
    if module_name == "coal_disasters":
        assert out["early"] > 0 and out["late"] > 0, out
    if module_name == "friedman_regression":
        assert len(out["inclusion"]) == 5 and out["sigma"] > 0, out


def test_port_example_needs_a_cuda_device_by_default(one_thread):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_example("out_of_sample").main()


@pytest.mark.slow
def test_coal_rate_drop_full_budget(one_thread):
    """Statistical oracle: the known sharp rate drop ~1890 is recovered."""
    out = load_example("coal_disasters").main(n_bins=40, device="cpu")
    assert math.isfinite(out["early"]) and math.isfinite(out["late"])
    assert out["early"] > 1.5 * out["late"], out
