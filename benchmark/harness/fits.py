"""The traffic's generator: data from the seed, the models, and whole
``sample()`` fits with the defaults users get.

A configuration (``configs/<name>.json``) gives the data (``generator``,
``n``, ``p``, ``seed_offset``, and the generator's keyword arguments
``data_args``), the model (``model``, which names
``models/<model>.py``, and the sizes it reads, such as ``m``,
``max_depth``) and the sampler's settings and budget (``num_particles``,
``num_refinements``, ``batch``, ``chains``, ``tune``, ``draws``).  A traffic
mix (``traffic/<name>.json``) gives how the fits come: ``datasets``, the
number of data sets drawn from the seed in set-up that the fits take in
turn (the work of a fit depends on its data, so a run averages over them),
the ``sample`` options such as ``ancestor_sampling`` or the number of
chains, and the mesh the chains are spread over."""

import warnings

import numpy as np

# what a fit keeps for the check besides its model's draws: the arrays of
# its stored forests, as the program returned them
KEPT_TREES = ("split_var", "split_val", "leaf")


def derive(seed, *words):
    """A seed in [0, 2^31 - 1) derived from the run's ``--seed`` and
    ``words`` (small whole numbers); any whole ``seed`` is taken."""
    ss = np.random.SeedSequence([int(seed) % 2**64] + [int(w) for w in words])
    return int(ss.generate_state(1, np.uint64)[0] % (2**31 - 1))


def make_data(reg, config, seed, index=0):
    """``(X, Y, f)``: data set ``index`` of the configuration's data, drawn
    from ``seed`` by its generator in ``reg`` (a ``registry.Registry``)."""
    gen = reg.reference(config["generator"])
    return gen.generate(config["n"], config["p"],
                        derive(seed, 0, config["seed_offset"], index),
                        **config["data_args"])


def sample_kwargs(config, traffic):
    """``sample()``'s arguments of every fit but the seed: the
    configuration's sampler settings and budget, then the traffic's."""
    kw = {k: config[k] for k in ("num_particles", "num_refinements",
                                  "chains", "tune", "draws")}
    kw["batch"] = tuple(config["batch"])
    kw.update(traffic.get("sample", {}))
    return kw


def fit(pmb, model, rv, kw, random_seed, keep, device=None, mesh=None):
    """One whole fit: ``sample()`` from the call to the returned
    ``InferenceData``.  Returns ``(wall seconds, timings, outputs,
    warnings)``; ``outputs`` holds the draws of the variables named in
    ``keep``, the fit's seed and the stored forests' arrays, as the program
    returned them."""
    import time

    timings = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        idata = pmb.sample(model=model, random_seed=random_seed,
                           timings=timings, device=device, mesh=mesh, **kw)
        wall = time.perf_counter() - t0
    trees = rv.all_trees
    out = {name: idata.posterior[name].values for name in keep}
    out["random_seed"] = random_seed
    for key in KEPT_TREES:
        out[key] = getattr(trees, key)
    return wall, timings, out, [str(w.message) for w in caught]
