"""setup_s: from the start of ``run.py`` to the start of the window:
imports, CUDA initialisation, building or loading the kernels, the data,
the model, the warm-up fit (and, on several cards, the ranks' start and the
process group)."""


def read(run):
    return run.setup_s
