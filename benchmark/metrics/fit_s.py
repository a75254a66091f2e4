"""fit_s: the window's wall seconds over the fits completed in it (host
clock; each fit from the call to ``sample()`` to its ``InferenceData``)."""


def read(run):
    return run.window_s / len(run.fits)
