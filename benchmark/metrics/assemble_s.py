"""assemble_s: seconds of the program's span ``assemble`` (``sample()``
after its draw phase: the drained chunks joined, the forests rebuilt, the
``InferenceData`` built, the convergence checks) a fit of the window."""

from benchmark.harness import program


def read(run):
    got = program.span(run.steady, "assemble")
    return None if got is None else got[0] / len(run.steady)
