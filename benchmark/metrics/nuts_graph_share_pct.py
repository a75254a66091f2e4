"""nuts_graph_share_pct: the share of NUTS doublings replayed from a
captured CUDA graph, the program's counters ``nuts_graph_replays`` over
``nuts_graph_replays`` + ``nuts_eager_doublings`` (``sampler/nuts.py``: a
doubling runs eagerly the first time a fit reaches its depth, on the CPU
and where a capture failed) over the window's fits.  None where the program
counts neither (a version without the graphs)."""

from benchmark.harness import program


def read(run):
    replays = program.counter(run.steady, "nuts_graph_replays")
    eager = program.counter(run.steady, "nuts_eager_doublings")
    if replays is None and eager is None:
        return None
    total = (replays or 0) + (eager or 0)
    return 100.0 * (replays or 0) / total if total else None
