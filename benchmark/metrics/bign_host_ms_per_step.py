"""bign_host_ms_per_step: host milliseconds inside the program's span
``bign_step`` (``ops/bign.py``: the large-n step's wrapper, which enqueues
the step's kernels) over the tuning and draw steps of the window's fits."""

from benchmark.harness import program


def read(run):
    got = program.span(run.steady, "bign_step")
    return None if got is None else got[0] / run.steps(run.steady) * 1e3
