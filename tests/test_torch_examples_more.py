"""Run the other three examples of the PyTorch/CUDA port
(``examples/port/``) end to end on the CPU, with the budget and plot clamps
of ``test_torch_examples.py`` (a second file, so that ``--dist loadfile``
gives the examples two workers).

The high-dim example runs as on a host without matplotlib (its curves
computed with ``utils.interpret`` on its device, nothing drawn): the branch
the card's machine takes, so the p=1000 model is sampled once here.  The
plot functions of its other branch are tested in ``test_torch_interpret.py``.
"""

import sys

import numpy as np
import pytest
from test_torch_examples import (_numbers, load_example, one_thread,  # noqa: F401
                                 tiny_budget)

EXAMPLES = [
    ("heteroscedastic", "main"),
    ("high_dim_selection", "main"),
    ("out_of_sample", "main"),
]


@pytest.fixture
def curves_without_matplotlib(monkeypatch):
    """Hide matplotlib, and clamp and record the ``utils.interpret`` calls
    that take the plots' place as ``tiny_budget`` clamps the plots."""
    from pymc_bart_tpu_torch.utils import interpret

    calls = []

    def clamped(name):
        real = getattr(interpret, name)

        def fn(*args, **kwargs):
            calls.append((name, kwargs["device"]))
            kwargs["samples"] = min(int(kwargs["samples"]), 20)
            if "instances" in kwargs:
                kwargs["instances"] = min(int(kwargs["instances"]), 5)
            return real(*args, **kwargs)
        return fn

    for name in ("partial_dependence", "ice"):
        monkeypatch.setattr(interpret, name, clamped(name))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    return calls


@pytest.mark.parametrize("module_name,entry", EXAMPLES,
                         ids=[f"{m}.{e}" for m, e in EXAMPLES])
def test_port_example_runs(module_name, entry, tiny_budget, request):
    calls = (request.getfixturevalue("curves_without_matplotlib")
             if module_name == "high_dim_selection" else None)
    out = getattr(load_example(module_name), entry)(device="cpu")
    assert isinstance(out, dict) and out, out
    assert np.isfinite(_numbers(out)).all(), out
    if module_name == "high_dim_selection":
        assert len(out["top5"]) == 5, out
        assert min(out["top5"]) < 5, out       # an active column among them
        assert 0.0 < out["inclusion_mass"] <= 1.0 + 1e-6, out
        assert calls == [("partial_dependence", "cpu"), ("ice", "cpu")]
    if module_name == "out_of_sample":
        assert out["std_f_test"] > 0, out
