"""Faults planted in the port underneath a run, to show that the check
catches them.  Each is a function of the rank, called first in each rank's
process (``cell.run(hook=...)``), that replaces one callable of the port
where its caller looks it up.  No benchmark run plants one: the tests and
``readings.py --fault`` do."""

import numpy as np


def _replace(mod_name, attr, make):
    import importlib

    mod = importlib.import_module(mod_name)
    setattr(mod, attr, make(getattr(mod, attr)))


def state_unchanged(rank):
    """Every PGBART step returns the forest it was given."""
    def make(orig):
        def step(state, rands, X, *a, **kw):
            return state, state.sum_trees.new_zeros(
                (state.sum_trees.shape[0], X.shape[1]))
        return step
    _replace("pymc_bart_tpu_torch.sampler.pgbart", "pgbart_step", make)


def nuts_unchanged(rank):
    """Every NUTS step returns sigma's state unchanged."""
    def make(orig):
        def step(gen, h, *a, **kw):
            _h, stats = orig(gen, h, *a, **kw)
            return h, stats
        return step
    _replace("pymc_bart_tpu_torch.sampler.nuts", "nuts_step", make)


def half_rows(rank):
    """Each PGBART step leaves the sum of trees of half of the rows as it
    was: the step's update is taken over the other half only."""
    def make(orig):
        def step(state, *a, **kw):
            n = state.sum_trees.shape[1]
            keep = state.sum_trees[:, n // 2:].clone()
            state, vi = orig(state, *a, **kw)
            state.sum_trees[:, n // 2:] = keep
            return state, vi
        return step
    _replace("pymc_bart_tpu_torch.sampler.pgbart", "pgbart_step", make)


def answer_altered(rank):
    """The first draw of chain 0 of every variable the program stores,
    altered by one in every chunk where it reaches the host."""
    from pymc_bart_tpu_torch.sampler import compound

    orig = compound._HostDrain.finish

    def finish(handle):
        out = orig(handle)
        for key, values in out.items():
            if key.startswith("values/"):
                values[0, 0] += 1
        return out
    compound._HostDrain.finish = staticmethod(finish)


def no_exchange(rank):
    """Every rank keeps its own chains where the outputs are gathered."""
    from pymc_bart_tpu_torch.parallel import mesh as pmesh

    def gather(outs, mesh, row_axes, whole=()):
        world = pmesh.mesh_shape(mesh)[0]
        return {k: v if k in whole else np.concatenate([v] * world, axis=0)
                for k, v in outs.items()}
    pmesh.gather_outputs = gather


FAULTS = {f.__name__: f for f in (state_unchanged, nuts_unchanged, half_rows,
                                  answer_altered, no_exchange)}
