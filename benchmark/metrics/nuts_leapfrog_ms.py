"""nuts_leapfrog_ms: host milliseconds of one batched leapfrog, the
program's span ``nuts_leapfrog`` (``sampler/nuts.py``: a half step of the
momentum, the position, the model's log-density and its gradient, the other
half step) over its calls in the window's fits."""

from benchmark.harness import program


def read(run):
    got = program.span(run.steady, "nuts_leapfrog")
    return None if got is None or not got[1] else got[0] / got[1] * 1e3
