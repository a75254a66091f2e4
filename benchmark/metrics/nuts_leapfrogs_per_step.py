"""nuts_leapfrogs_per_step: the program's counter ``nuts_leapfrogs``
(``sampler/nuts.py``: leapfrogs run for all chains at once, ``2^D - 1`` a
transition of D doublings) over the tuning and draw steps of the window's
fits."""

from benchmark.harness import program


def read(run):
    n = program.counter(run.steady, "nuts_leapfrogs")
    return None if n is None else n / run.steps(run.steady)
