"""A tiny cell through the harness's whole run on the CPU (its look for a
card skipped): the sound program passes the reference check, and the
control and each planted fault come out not correct."""

import time

import pytest

from conftest import add_cell, copy_benchmark

from benchmark.harness import cell as cellmod
from benchmark.harness.faults import FAULTS
from benchmark.harness.registry import Registry
from benchmark.readings import CONTROLS


def _run(root, name="tiny.fit", seed=4000000123, seconds=0.0, trace=0,
         control=None, hook=None):
    return cellmod.run(name, seed, seconds, trace, root=root,
                       t_start=time.time(), device="cpu",
                       control=CONTROLS[control] if control else None,
                       hook=hook)


def _value(result, name):
    return result["checks"][name]["value"]


def test_tiny_fit_passes_the_reference_check(tiny_root):
    r = _run(tiny_root, seconds=1.0)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"fit_s", "setup_s"}    # no card: no memory
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                           "memory_peak_bytes": 0}
    assert list(r)[-4:] == ["checks", "_lines", "_forbidden", "_notes"]
    assert r["_forbidden"] == []
    assert _value(r, "mu_gap") < 1e-5


def test_tiny_traced_run_reports_the_layers(tiny_root):
    r = _run(tiny_root, trace=1)
    m = r["metrics"]
    assert r["correct"]
    for name in ("draw_ms_per_step", "fit_overhead_s", "nuts_host_ms_per_step",
                 "pgbart_host_ms_per_step", "drained_mb_per_draw"):
        assert m[name]["value"] > 0, name
    # device readings exist only on the card
    assert "device_idle_pct" not in m and "step_mfu_pct" not in m
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_the_float16_control_fails_the_check(tiny_root):
    r = _run(tiny_root, control="float16")
    assert not r["correct"]
    assert _value(r, "mu_gap") > 10 * 1e-4


@pytest.mark.parametrize("fault, number", [
    ("state_unchanged", "rmse_f"), ("nuts_unchanged", "sigma_gap"),
    ("half_rows", "mu_gap"), ("answer_altered", "mu_gap")])
def test_a_planted_fault_is_not_correct(tiny_root, restored, fault, number):
    r = _run(tiny_root, hook=FAULTS[fault])
    assert not r["correct"] and r["failed"] == r["attempted"]
    limit = Registry(tiny_root).cell("tiny.fit")["limits"][number]
    assert _value(r, number) > limit


@pytest.fixture
def restored(monkeypatch):
    """Every callable a fault replaces is put back after the test."""
    from pymc_bart_tpu_torch.parallel import mesh as pmesh
    from pymc_bart_tpu_torch.sampler import compound, nuts, pgbart

    for obj, attr in ((pgbart, "pgbart_step"), (nuts, "nuts_step"),
                      (pmesh, "gather_outputs")):
        monkeypatch.setattr(obj, attr, getattr(obj, attr))
    monkeypatch.setattr(compound._HostDrain, "finish",
                        compound._HostDrain.__dict__["finish"])


@pytest.fixture
def mesh_root(tmp_path):
    """A copy of the benchmark with a tiny cell on the four-card cell's
    chain mesh (``traffic/refit_chains16_mesh4.json``), read by
    ``metrics/collectives_per_step.py``."""
    root = copy_benchmark(tmp_path)
    add_cell(root, "tiny.mesh", "tiny", "refit_chains16_mesh4", chips=4)
    return root


def test_chains_over_ranks_pass_and_fail_without_the_exchange(mesh_root):
    r = _run(mesh_root, "tiny.mesh", trace=1)
    assert r["correct"] and r["device"]["count"] == 4
    assert r["metrics"]["collectives_per_step"]["value"] >= 1.0
    r = _run(mesh_root, "tiny.mesh", hook=FAULTS["no_exchange"])
    assert not r["correct"] and _value(r, "structure_errors") > 0
