"""prepare_s: seconds of the program's span ``prepare`` (``sample()``'s
entry to its first tuning step: the model compiled, the data on the card,
the routes resolved, the states made) a fit of the window."""

from benchmark.harness import program


def read(run):
    got = program.span(run.steady, "prepare")
    return None if got is None else got[0] / len(run.steady)
