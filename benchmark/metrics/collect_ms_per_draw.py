"""collect_ms_per_draw: host milliseconds of the program's span ``collect``
(``sampler/compound.py``: a draw's values, statistics and updated trees
into the chunk's buffers on the card) a draw of the window's fits."""

from benchmark.harness import program


def read(run):
    got = program.span(run.steady, "collect")
    if got is None:
        return None
    return got[0] / (len(run.steady) * run.kw["draws"]) * 1e3
