"""Plain NumPy references of the benchmark.

Nothing here imports ``torch``, the port ``pymc_bart_tpu_torch`` or the JAX
package: the data generators, the sum-of-trees descent and the numbers that
decide whether a run is correct are worked out from the inputs and the
program's outputs alone."""
