"""collectives_per_step: the program's calls to a collective
(``parallel/mesh.py``'s ``collective_calls``: all-reduce, all-gather and
the gathering of the outputs) on rank 0 over the tuning and draw steps of
the window's fits.  None on one card, where no collective runs."""


def read(run):
    if run.chips == 1:
        return None
    return run.collectives / run.steps(run.fits)
