"""The classifier's added files: a tiny copy of ``logistic_n50k.fit``
(its model, check, generator and configuration at n = 400, m = 10) through
the harness's whole run on the CPU passes its check and fails it under a
planted fault; the row-log-likelihood work count on a shape counted by hand;
the large-n readers on a traced run of the large-n route, and None where
the program records nothing; the check's descent of the forests against
the shared reference's."""

import json
import time

import numpy as np
import pytest

from conftest import ROOT, copy_benchmark

from benchmark.counts import pgbart, pgbart_rowll
from benchmark.harness import cell as cellmod
from benchmark.harness.cell import Run
from benchmark.harness.faults import FAULTS
from benchmark.harness.peaks import peak_of
from benchmark.harness.registry import Registry
from benchmark.reference import check_bernoulli, forest

TINY = dict(n=400, m=10, tune=30, draws=60)
LIMITS = {"structure_errors": 0, "lo_gap": 1e-4, "rate_gap": 0.2,
          "rmse_p": 0.4}
READERS = ("bign_rowll_roofline_pct", "bign_host_ms_per_step",
           "bign_launches_per_step")


@pytest.fixture
def logit_root(tmp_path):
    """A copy of the benchmark with a tiny copy of the classifier's cell,
    ``tiny_logit.fit``, and one on the large-n route, ``tiny_logit.bign``
    (its mix forces the route, which ``sample()`` takes by itself from
    some ten thousand rows)."""
    root = copy_benchmark(tmp_path)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "logistic_n50k.json").read_text())
    (bench / "configs" / "tiny_logit.json").write_text(
        json.dumps(dict(cfg, **TINY)))
    (bench / "traffic" / "refit_bign.json").write_text(json.dumps(
        {"sample": {"pgbart_route": "bign"}, "datasets": 2}))
    cell = json.loads(
        (bench / "workloads" / "logistic_n50k.fit.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for name, traffic in (("tiny_logit.fit", "refit"),
                          ("tiny_logit.bign", "refit_bign")):
        (bench / "workloads" / f"{name}.json").write_text(json.dumps(
            dict(cell, config="tiny_logit", traffic=traffic, trace_steps=10,
                 limits=LIMITS)))
        spec["workloads"].append({"name": name, "config": "tiny_logit",
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
    spec["configs"].append({"name": "tiny_logit", "source": "test",
                            "file": "benchmark/configs/tiny_logit.json",
                            "reduced": [], "why": "test"})
    for m in spec["per_layer"]:
        if m["name"] in READERS:
            m["workloads"].append("tiny_logit.bign")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(root, name="tiny_logit.fit", hook=None, trace=0):
    return cellmod.run(name, 4000000123, 0.0, trace, root=root,
                       t_start=time.time(), device="cpu", hook=hook)


def test_tiny_classifier_passes_its_check(logit_root):
    r = _run(logit_root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 1, r
    assert list(r["checks"]) == ["structure_errors", "lo_gap", "rate_gap",
                                 "rmse_p"]
    assert r["checks"]["lo_gap"]["value"] < 1e-5
    assert set(r["metrics"]) == {"fit_s", "setup_s"}


@pytest.mark.parametrize("fault", ["half_rows", "answer_altered"])
def test_tiny_classifier_fails_under_a_fault(logit_root, restored, fault):
    r = _run(logit_root, hook=FAULTS[fault])
    assert not r["correct"] and r["failed"] == r["attempted"]
    assert r["checks"]["lo_gap"]["value"] > LIMITS["lo_gap"]


def test_traced_large_n_run_reads_the_large_n_readers(logit_root):
    r = _run(logit_root, "tiny_logit.bign", trace=1)
    assert r["correct"]
    m = r["metrics"]
    assert m["bign_host_ms_per_step"]["value"] > 0
    assert m["bign_launches_per_step"]["value"] == 0.0     # no card: plain
    assert "bign_rowll_roofline_pct" not in m               # no card: none


def test_rowll_counts_on_hand_shapes():
    # C=1, P=2, n=10, p=1, D=1 (S=3, G=1): two log-likelihoods of 9 a row
    # and particle, one level of 3, 3 a row for the residual and the commit
    flops, nbytes = pgbart_rowll.tree_update(1, 2, 10, 1, 1)
    assert flops == 2 * 10 * (9 * 2 + 3) + 3 * 10 == 450
    # four node arrays read and written, the prediction row read and
    # written, 4 numbers for each particle's inner slot, D uniforms
    assert nbytes == 4 * (2 * 4 * 3 + 2 * 10 + 2 * 1 * 4 + 1)
    assert pgbart_rowll.step_shared_bytes(2, 8, 4, 10, 2) == 4 * (
        32 + 8 + 32 + 2 * 10 * 7 + 16)
    f1, b1 = pgbart_rowll.tree_update(2, 3, 8, 4, 2)
    flops, nbytes = pgbart_rowll.rowll_tree_updates(2, 3, 8, 4, 10, 2, 0.2)
    assert pgbart.batch_trees(10, 0.2) == 2
    assert (flops, nbytes) == (2 * f1, 2 * b1 + pgbart_rowll.step_shared_bytes(
        2, 8, 4, 10, 2))
    # at the cell's shapes the floor is the float operations'
    peak = peak_of("NVIDIA H100 80GB HBM3")
    flops, nbytes = pgbart_rowll.rowll_tree_updates(4, 10, 50_000, 10, 50,
                                                    6, 0.1)
    assert flops / peak["fp32_flops"] > nbytes / peak["hbm_bytes_per_s"]


def test_new_readers_read_nothing_where_the_program_records_nothing():
    reg = Registry(ROOT)
    kw = {"tune": 2, "draws": 4, "num_particles": 10, "batch": (0.1, 0.1)}
    fits = [{"index": 0, "wall": 1.0, "seed": 1,
             "timings": {"tune_seconds": 0.2, "draw_seconds_total": 0.5,
                         "spans": {"draw/pgbart_step": [0.1, 4]},
                         "counters": {"draw/host_syncs": 1}}}]
    no_slice = Run(kw=kw, fits=fits, steady=fits, slices=[None],
                   peak=peak_of("NVIDIA H100 80GB HBM3"), chains_local=4,
                   config=reg.cell("logistic_n50k.fit")["config"])
    for name in READERS:
        assert reg.metric_reader(name)(no_slice) is None, name


def test_descend_equals_the_forest_reference():
    """The check's all-trees-at-once descent gives ``forest.predict``'s sum
    on forests that repeat trees from draw to draw, split on the last level
    of slots and meet rows on a split value."""
    rng = np.random.default_rng(5)
    C, D, m, S, n, p = 2, 6, 4, 15, 300, 3
    sv = np.where(rng.uniform(size=(C, D, m, S)) < 0.6,
                  rng.integers(0, p, (C, D, m, S)), -1).astype(np.int32)
    sl = rng.uniform(size=(C, D, m, S)).astype(np.float32)
    for d in range(1, D):
        keep = rng.uniform(size=(C, m)) < 0.7
        sv[:, d][keep], sl[:, d][keep] = sv[:, d - 1][keep], sl[:, d - 1][keep]
    leaf = rng.normal(size=(C, D, m, S, 1)).astype(np.float32)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    sv[0, 0, 0, 0] = 0
    X[:20, 0] = sl[0, 0, 0, 0]
    assert (sv[..., S // 2:] >= 0).any()
    want = forest.predict(sv, sl, leaf, X)
    np.testing.assert_allclose(check_bernoulli.descend(sv, sl, leaf, X, 64),
                               want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        check_bernoulli.descend(sv[1, 3], sl[1, 3], leaf[1, 3], X),
        want[1, 3], rtol=0, atol=1e-12)
    idx = check_bernoulli.rate_draws(rng, C, D, 4)
    assert idx.shape == (C, 4) and (np.diff(idx, axis=1) > 0).all()


@pytest.fixture
def restored(monkeypatch):
    """Every callable a fault replaces is put back after the test."""
    from pymc_bart_tpu_torch.sampler import compound, pgbart

    monkeypatch.setattr(pgbart, "pgbart_step", pgbart.pgbart_step)
    monkeypatch.setattr(compound._HostDrain, "finish",
                        compound._HostDrain.__dict__["finish"])
