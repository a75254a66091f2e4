"""host_syncs_per_step: the program's counter ``host_syncs`` (each point
on the path of ``sample()`` that blocks the host on the card: NUTS's check
a doubling, a scalar copied to the card, the drain's wait, the phases' end)
over the tuning and draw steps of the window's fits."""

from benchmark.harness import program


def read(run):
    n = program.counter(run.steady, "host_syncs")
    return None if n is None else n / run.steps(run.steady)
