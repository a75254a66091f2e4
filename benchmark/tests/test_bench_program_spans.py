"""The readers of the program's own spans and counters: a tiny traced run
on the CPU reports all seven, and a program that records none (an older
version) leaves them out without an error."""

import time

from benchmark.harness import cell as cellmod
from benchmark.harness.cell import Run
from benchmark.harness.registry import Registry

from conftest import ROOT

PROGRAM_METRICS = ("nuts_leapfrogs_per_step", "nuts_leapfrog_ms",
                   "host_syncs_per_step", "collect_ms_per_draw",
                   "drain_wait_ms_per_draw", "prepare_s", "assemble_s")


def test_tiny_traced_run_reports_the_programs_spans(tiny_root):
    r = cellmod.run("tiny.fit", 4000000321, 0.0, 1, root=tiny_root,
                    t_start=time.time(), device="cpu")
    assert r["correct"]
    m = r["metrics"]
    for name in PROGRAM_METRICS:
        assert m[name]["value"] > 0, name
    # a NUTS transition runs 2^D - 1 leapfrogs for D >= 1 doublings
    assert m["nuts_leapfrogs_per_step"]["value"] >= 1
    assert m["host_syncs_per_step"]["value"] >= 2


def test_readers_read_nothing_where_the_program_records_nothing():
    reg = Registry(ROOT)
    kw = {"tune": 2, "draws": 4}
    fits = [{"index": 0, "wall": 1.0, "seed": 1,
             "timings": {"tune_seconds": 0.2, "draw_seconds_total": 0.5,
                         "draw_chunk_sizes": [4], "drained_bytes": 10}}]
    run = Run(kw=kw, fits=fits, steady=fits)
    for name in PROGRAM_METRICS:
        assert reg.metric_reader(name)(run) is None, name
