"""The port's own spans and counters (``pymc_bart_tpu_torch/tracing.py``)
through ``sample()`` on the CPU: the paths and counts a fit writes into its
``timings``, the leapfrog count against the tree depths NUTS reports, draws
bit for bit the same with and without recording and under a profiler, no
``record_function`` entered without one, a clean tracer after a span that
raised, the checkpoint span and counter, and ``chip_smoke.py``'s readers of
them.  The collective span is checked
in the worlds of ``tests/test_torch_parallel.py``.

The test marked ``card`` holds the counter ``host_syncs`` to what
``torch.cuda.set_sync_debug_mode("warn")`` reports over a fit's draw steps
on a CUDA device; it skips elsewhere.  This file imports no JAX: on the card
run it with ``python -m pytest --noconftest tests/test_torch_tracing.py -m
card -s``.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import pymc_bart_tpu_torch as pmb
from pymc_bart_tpu_torch import tracing
from pymc_bart_tpu_torch.sampler import nuts

KW = dict(tune=6, draws=10, chains=3, random_seed=11, device="cpu",
          num_particles=5, chunk_size=4, convergence_checks=False)
CHUNKS = [4, 3, 3]                  # 10 draws in chunks of at most 4
MAX_TREE_DEPTH = 8                  # nuts_step's default, which sample() uses
STEP_SPANS = ("draw_rands", "pgbart_step", "nuts_step",
              "nuts_step/nuts_leapfrog")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n=60, p=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, p)).astype(np.float32)
    f = 2 * np.sin(3 * X[:, 0]) + X[:, 1]
    return X, (f + 0.3 * rng.normal(size=n)).astype(np.float32)


def _fit(timings=None, n=60, p=3, m=5, **kw):
    """A fit of ``Normal(BART, HalfNormal(1))``: its posterior, stats and
    stored forests as one flat dict of arrays."""
    X, Y = _data(n, p)
    with pmb.Model() as model:
        mu = pmb.BART("mu", X, Y, m=m, max_depth=3)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)
        idata = pmb.sample(**{**KW, **kw}, timings=timings)
    out = {}
    for group in ("posterior", "sample_stats"):
        for name, da in idata[group].items():
            out[f"{group}/{name}"] = np.asarray(da.values)
    trees = model.bart_rvs[0].all_trees
    for f in ("split_var", "split_val", "leaf", "count"):
        out[f"trees/{f}"] = np.asarray(getattr(trees, f))
    return out


def _doublings_and_checks(out):
    """Per draw: the doublings of the longest chain, the leapfrogs run for
    all chains (``2^D - 1``) and NUTS's host checks (one a doubling entered,
    one more where the loop stopped before the largest depth)."""
    D = out["sample_stats/tree_depth"].max(axis=0).astype(np.int64)
    return D, (2 ** D - 1), D + (D < MAX_TREE_DEPTH)


# ---------------------------------------------------------------------------
# the tracer alone
# ---------------------------------------------------------------------------

def test_without_timings_nothing_is_recorded_or_timed(monkeypatch):
    def no_clock():
        raise AssertionError("the tracer read the clock")

    monkeypatch.setattr(tracing, "_perf_counter", no_clock)
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("a") as sp:
        tracing.count("x")
    assert sp.seconds is None
    out = _fit(None, tune=2, draws=3)      # no span reads the clock
    assert out["posterior/mu"].shape == (3, 3, 60)


def test_paths_join_the_open_spans_and_a_raise_leaves_them_clean():
    d = {}
    with tracing.recording(d):
        tracing.count("top")
        with pytest.raises(KeyError):
            with tracing.span("a"):
                with tracing.span("b"):
                    tracing.count("x", 3)
                    raise KeyError("inside")
        with tracing.span("a"):
            tracing.count("x")
        started = tracing.span("c").start()     # left open: closed at the end
        with tracing.span("d"):
            pass
        assert started is tracing.span("c")
    assert tracing._TRACER.get() is None
    assert {k: v[1] for k, v in d["spans"].items()} == {"a": 2, "a/b": 1,
                                                      "c/d": 1}
    assert d["counters"] == {"top": 1, "a/b/x": 3, "a/x": 1}
    with tracing.recording(d):                  # a second block adds to it
        with tracing.span("a"):
            pass
    assert d["spans"]["a"][1] == 3


# ---------------------------------------------------------------------------
# through sample()
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def traced():
    timings = {}
    return _fit(timings), timings


def test_sample_writes_the_span_paths_and_counters(traced):
    out, t = traced
    tune, draws = KW["tune"], KW["draws"]
    want = {"prepare": 1, "tune": 1, "draw": 1, "assemble": 1,
            "draw/collect": draws, "draw/drain_wait": len(CHUNKS)}
    for phase, steps in (("tune", tune), ("draw", draws)):
        for name in STEP_SPANS[:3]:
            want[f"{phase}/{name}"] = steps
    calls = {k: v[1] for k, v in t["spans"].items()}
    leapfrogs = {k: calls.pop(f"{k}/nuts_step/nuts_leapfrog")
                 for k in ("tune", "draw")}
    assert calls == want
    assert min(leapfrogs.values()) >= 1
    assert all(v[0] > 0 for v in t["spans"].values())
    # the phases' seconds are their spans'; a child's lie inside its parent's
    assert t["tune_seconds"] == t["spans"]["tune"][0]
    assert t["draw_seconds_total"] == t["spans"]["draw"][0]
    assert t["spans"]["draw/nuts_step/nuts_leapfrog"][0] < \
        t["spans"]["draw/nuts_step"][0] < t["spans"]["draw"][0]
    assert t["draw_chunk_sizes"] == CHUNKS and t["drained_bytes"] > 0
    assert set(t["counters"]) == {
        f"{p}/{c}" for p in ("tune", "draw") for c in (
            "host_syncs", "nuts_step/host_syncs", "nuts_step/nuts_leapfrogs",
            "nuts_step/nuts_eager_doublings")} | {
        "draw/drain_wait/host_syncs"}
    # the phases' ends and each chunk's drain
    assert t["counters"]["tune/host_syncs"] == 1
    assert t["counters"]["draw/host_syncs"] == 1
    assert t["counters"]["draw/drain_wait/host_syncs"] == len(CHUNKS)


def test_removed_timings_keys_are_absent(traced, tmp_path):
    _out, t = traced
    t2 = {}
    _fit(t2, checkpoint_dir=str(tmp_path))
    for got in (t, t2):
        assert not {"draw_chunk_seconds", "checkpoint_seconds",
                    "checkpoint_bytes"} & set(got)
        assert {"tune_seconds", "draw_seconds_total", "drained_bytes",
                "draw_chunk_sizes", "spans", "counters"} <= set(got)


@pytest.mark.parametrize("tune", [0, 5])
def test_leapfrog_count_equals_the_tree_depths_nuts_reports(tune):
    timings = {}
    out = _fit(timings, tune=tune)
    D, leapfrogs, checks = _doublings_and_checks(out)
    c = timings["counters"]
    assert c["draw/nuts_step/nuts_leapfrogs"] == int(leapfrogs.sum())
    assert timings["spans"]["draw/nuts_step/nuts_leapfrog"][1] == \
        int(leapfrogs.sum())
    # a host check a doubling; no evaluation of the log-density copies a
    # scalar to the device (HalfNormal's scale is a tensor made once)
    assert c["draw/nuts_step/host_syncs"] == int(checks.sum())
    assert "draw/nuts_step/nuts_leapfrog/host_syncs" not in c
    # on the CPU every doubling runs eagerly
    assert c["draw/nuts_step/nuts_eager_doublings"] == int(D.sum())
    if tune:
        assert c["tune/nuts_step/nuts_leapfrogs"] == \
            timings["spans"]["tune/nuts_step/nuts_leapfrog"][1] >= tune
    else:
        assert timings["spans"]["tune"][1] == 1
        assert not any(k.startswith("tune/") and k != "tune/host_syncs"
                       for k in c)


def test_draws_bit_for_bit_with_and_without_recording_and_profiler(
        traced, monkeypatch):
    want, timings = traced
    entered = []
    real = tracing._record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(tracing, "_record_function", counting)
    for got in (_fit(None), _fit({})):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    assert entered == []                # no profiler: no record_function
    t = {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = _fit(t)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    names = {e.name for e in prof.events()}
    assert {"bart/prepare", "bart/draw", "bart/nuts_step",
            "bart/nuts_leapfrog", "bart/collect"} <= names
    assert not any(n.startswith("bench/") for n in names)
    # every span entry entered one range, and the same entries as without
    assert len(entered) == sum(v[1] for v in t["spans"].values())
    assert {k: v[1] for k, v in t["spans"].items()} == {
        k: v[1] for k, v in timings["spans"].items()}


def test_profile_dir_trace_shows_the_program_spans(tmp_path):
    _fit(None, tune=2, draws=3, profile_dir=str(tmp_path))
    with open(tmp_path / "draws.pt.trace.json") as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    assert {"bart/draw", "bart/pgbart_step", "bart/nuts_step",
            "bart/nuts_leapfrog", "bart/collect",
            "bart/drain_wait"} <= names


class _Boom(Exception):
    pass


def test_a_span_that_raises_leaves_the_next_fit_clean(traced, monkeypatch):
    _out, clean = traced
    real = nuts.value_and_grad
    seen = []

    def raising(logp_fn, theta):
        stack = tracing._TRACER.get().stack
        seen.append(stack[-1].path)
        if len(seen) > 20 and stack[-1].path.endswith("nuts_leapfrog"):
            raise _Boom()
        return real(logp_fn, theta)

    monkeypatch.setattr(nuts, "value_and_grad", raising)
    broken = {}
    with pytest.raises(_Boom):
        _fit(broken)
    assert tracing._TRACER.get() is None
    assert broken["spans"]["prepare"][1] == 1
    assert "assemble" not in broken["spans"]
    monkeypatch.setattr(nuts, "value_and_grad", real)
    again = {}
    _fit(again)
    assert {k: v[1] for k, v in again["spans"].items()} == {
        k: v[1] for k, v in clean["spans"].items()}
    assert again["counters"] == clean["counters"]


def test_the_smoke_scripts_readers_read_what_sample_writes(traced,
                                                           tmp_path):
    """``chip_smoke.py`` reads the spans and counters on the card (phase
    ``aids`` its checkpoints, phases ``sample`` / ``models`` a breakdown a
    step); held here to what a fit on the CPU writes."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_smoke_readers", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    timings = {}
    _fit(timings, checkpoint_dir=str(tmp_path))
    got = smoke.checkpoints_of("cpu", {"timings": timings}, KW["tune"],
                               KW["draws"], KW["chunk_size"])
    ckpt = sorted(f for f in os.listdir(tmp_path) if f.startswith("ckpt_"))
    assert got["checkpoints"] == 2 + len(CHUNKS) == len(ckpt)
    assert got["checkpoint_bytes"] == os.path.getsize(tmp_path / ckpt[-1])
    assert got["checkpoint_seconds"] == timings["spans"]["tune/checkpoint"][
        0] + timings["spans"]["draw/checkpoint"][0]
    _out, t = traced
    steps = KW["tune"] + KW["draws"]
    got = smoke.program_breakdown(t, steps)
    assert set(got["span_ms_per_step"]) == {
        "prepare", "tune", "draw", "assemble", "collect", "drain_wait",
        "draw_rands", "pgbart_step", "nuts_step", "nuts_leapfrog"}
    assert got["span_ms_per_step"]["nuts_step"] == pytest.approx(
        1e3 * (t["spans"]["tune/nuts_step"][0]
               + t["spans"]["draw/nuts_step"][0]) / steps)
    assert got["counters_per_step"]["host_syncs"] == pytest.approx(
        sum(v for k, v in t["counters"].items()
            if k.endswith("host_syncs")) / steps)


def test_checkpoint_span_and_bytes(tmp_path):
    timings = {}
    _fit(timings, checkpoint_dir=str(tmp_path))
    spans, c = timings["spans"], timings["counters"]
    assert spans["tune/checkpoint"][1] == 2          # tuning chunks 3 + 3
    assert spans["draw/checkpoint"][1] == len(CHUNKS)
    on_disk = sum(os.path.getsize(tmp_path / f) for f in os.listdir(tmp_path)
                  if f.startswith("ckpt_"))
    assert c["tune/checkpoint/checkpoint_bytes"] + \
        c["draw/checkpoint/checkpoint_bytes"] == on_disk
    # every tensor of the carry but the generator's state is copied out
    per = c["draw/checkpoint/host_syncs"] // len(CHUNKS)
    assert per > 10 and c["tune/checkpoint/host_syncs"] == 2 * per
    # the drains are serial with a checkpoint_dir: one wait a chunk
    assert c["draw/drain_wait/host_syncs"] == len(CHUNKS)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.card
def test_host_syncs_agree_with_the_sync_debug_mode(card):
    """Over one fit's draw steps (n=1000, p=10, m=50, 4 chains, 10
    particles: the benchmark's small cell), the synchronising operations the
    sync debug mode warns of, by the span path open at each, against the
    counter ``host_syncs`` on the same paths.  The mode does not see an
    event's or the device's synchronize: those paths may count more."""
    kw = dict(device="cuda", chains=4, num_particles=10, tune=10, draws=30,
              chunk_size=10, random_seed=5)
    _fit({}, n=1000, p=10, m=50, **dict(kw, tune=2, draws=2))  # builds
    warned = {}
    timings = {}
    real = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return real(message, category, filename, lineno, file, line)
        tracer = tracing._TRACER.get()
        path = tracer.stack[-1].path if tracer is not None else "<none>"
        site = f"{os.path.relpath(filename)}:{lineno}"
        warned.setdefault(path, {}).setdefault(site, 0)
        warned[path][site] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _fit(timings, n=1000, p=10, m=50, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counted = {k[: -len("/host_syncs")] if k != "host_syncs" else "": v
               for k, v in timings["counters"].items()
               if k.split("/")[-1] == "host_syncs"}
    rows = {p: {"counted": counted.get(p, 0),
                "warned": sum(warned.get(p, {}).values()),
                "sites": warned.get(p, {})}
            for p in sorted(set(counted) | set(warned))
            if p.startswith("draw")}
    print(json.dumps({"sync_check": rows, "card": card}))
    unseen = {"draw", "draw/drain_wait"}    # device / event synchronize
    for p, r in rows.items():
        if p in unseen:
            assert r["warned"] <= r["counted"], (p, r)
        else:
            assert r["warned"] == r["counted"], (p, r)
