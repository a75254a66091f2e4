"""Plain PyTorch references of the models the port runs.

Each module is one model in plain ``torch`` operations and float32, with no
kernel, cache or batching of ``pymc_bart_tpu_torch``, written from the
published description; tests hold the port to it.  Nothing here imports
JAX or the JAX package ``pymc_bart_tpu``."""
