"""The benchmark of the PyTorch and CUDA port ``pymc_bart_tpu_torch``.

``run.py`` runs one cell; see ``README.md``."""
