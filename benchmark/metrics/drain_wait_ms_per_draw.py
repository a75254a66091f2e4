"""drain_wait_ms_per_draw: host milliseconds of the program's span
``drain_wait`` (``compound._HostDrain.finish``: the wait for a chunk's copy
to the host and its conversion to NumPy) a draw of the window's fits."""

from benchmark.harness import program


def read(run):
    got = program.span(run.steady, "drain_wait")
    if got is None:
        return None
    return got[0] / (len(run.steady) * run.kw["draws"]) * 1e3
