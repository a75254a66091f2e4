"""bign_launches_per_step: the program's counter ``bign_launches``
(``ops/bign.py``: the CUDA kernels that ``csrc/bign.cu``'s launcher reports
it enqueued for the large-n step; 0 on its plain version) over the tuning
and draw steps of the window's fits."""

from benchmark.harness import program


def read(run):
    n = program.counter(run.steady, "bign_launches")
    return None if n is None else n / run.steps(run.steady)
