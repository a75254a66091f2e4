"""The reader of nuts_graph_share_pct on made-up counters: the replays over
all doublings, summed over paths and fits, and None where the program counts
neither (an older version)."""

from benchmark.harness.cell import Run
from benchmark.harness.registry import Registry

from conftest import ROOT


def test_nuts_graph_share_reads_the_replays_over_all_doublings():
    read = Registry(ROOT).metric_reader("nuts_graph_share_pct")

    def run(*counters):
        fits = [{"index": i, "wall": 1.0, "seed": i,
                 "timings": {"counters": c}} for i, c in enumerate(counters)]
        return Run(kw={"tune": 2, "draws": 4}, fits=fits, steady=fits)

    # summed over the paths that end in each name and over the fits
    got = read(run({"tune/nuts_step/nuts_graph_replays": 30,
                    "tune/nuts_step/nuts_eager_doublings": 4,
                    "draw/nuts_step/nuts_graph_replays": 60},
                   {"draw/nuts_step/nuts_graph_replays": 4,
                    "draw/nuts_step/nuts_eager_doublings": 2}))
    assert got == 100.0 * 94 / 100
    # the CPU: every doubling eager
    assert read(run({"draw/nuts_step/nuts_eager_doublings": 7})) == 0.0
    # a program that counts neither (the parent's), or no doubling at all
    assert read(run({"draw/nuts_step/nuts_leapfrogs": 7})) is None
    assert read(run({})) is None
