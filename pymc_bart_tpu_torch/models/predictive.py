"""Prior and posterior predictive sampling, including out-of-sample
prediction (PyTorch).

Counterpart of ``pymc_bart_tpu/models/predictive.py``.  Out-of-sample
prediction works by changing a ``Data`` container (``set_data``): a BART
variable whose covariates changed since sampling gets its posterior values
recomputed draw for draw from the stored forests (``utils/posterior.py``,
on the card); the observation nodes are then drawn for every draw at once
from the port's distributions with one ``torch.Generator``.  Expressions are
evaluated per draw with ``torch.func.vmap``, the random draws are taken
outside it, batched over the draws.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..utils.posterior import predict_draw_indices
from .distributions import CategoricalDist
from .expr import evaluate
from .inference_data import DataArray, Dataset, InferenceData
from .model import Model


def _device_and_gen(device, random_seed):
    from ..sampler.compound import resolve_device

    device = resolve_device(device)
    if random_seed is None:
        random_seed = int(np.random.default_rng().integers(0, 2**31 - 1))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(random_seed))
    return device, gen


def _data_env(model: Model, device) -> Dict[str, torch.Tensor]:
    return {name: torch.as_tensor(np.asarray(d.get_value(), np.float32),
                                  device=device)
            for name, d in model.data_vars.items()}


def _params(exprs, env_of_draw, per_draw_env, data_env, draws, device):
    """Each expression of ``exprs`` evaluated for every draw: (draws, ...)."""
    names = list(per_draw_env)

    def one(*vals):
        env = dict(data_env)
        env.update(zip(names, vals))
        env = env_of_draw(env)
        return tuple(torch.as_tensor(evaluate(e, env), dtype=torch.float32,
                                     device=device) for e in exprs)

    if not exprs:
        return ()
    if not names:       # nothing varies from draw to draw
        return tuple(v.expand((draws,) + v.shape) for v in one())
    return torch.func.vmap(one)(*(per_draw_env[nm] for nm in names))


def _with_deterministics(model: Model):
    """env -> env with the model's deterministics evaluated, in order."""
    def with_dets(env):
        for det in model.deterministics:
            env[det.name] = evaluate(det.expr, env)
        return env
    return with_dets


def _observe(dist, gen, draws, params, shape):
    """``draws`` draws of an observation node: the parameters (draws, ...)
    broadcast to ``shape`` per draw (a Categorical takes its shape from its
    probabilities' leading axes)."""
    if dist is CategoricalDist:
        return dist.random(gen, params[0].shape[:-1], *params)
    full = (draws,) + tuple(shape)
    bc = []
    for p_ in params:
        p_ = p_.reshape((draws,) + (1,) * (len(full) - p_.dim())
                        + tuple(p_.shape[1:]))
        bc.append(torch.broadcast_to(p_, full))
    return dist.random(gen, full, *bc)


def _obs_shape(orv, params):
    shapes = [tuple(p_.shape[1:]) for p_ in params]
    try:
        return np.broadcast_shapes(*shapes, orv.observed.shape)
    except ValueError:
        return np.broadcast_shapes(*shapes)


def _group(values: Dict[str, np.ndarray], lead, var_names=None) -> Dataset:
    out = {}
    for name, v in values.items():
        if var_names is not None and name not in var_names:
            continue
        v = np.asarray(v).reshape(tuple(lead) + np.asarray(v).shape[1:])
        dims = ["chain", "draw"] + [f"{name}_dim_{i}"
                                    for i in range(v.ndim - 2)]
        out[name] = DataArray(v, dims, name=name)
    return Dataset(out)


def sample_prior_predictive(
    samples: int = 500,
    model: Optional[Model] = None,
    var_names=None,
    random_seed: Optional[int] = None,
    device=None,
) -> InferenceData:
    """Sample free RVs from their priors and the observation nodes given
    those draws (the ``pm.sample_prior_predictive`` surface).

    A BART variable contributes its pre-sampling support value, the constant
    ``Y.mean()``, as the reference's ``rng_fn`` does before any trees exist.
    Returns ``prior`` (free RVs, BART values, deterministics) and
    ``prior_predictive`` (observed nodes) groups, each (chain=1,
    draw=samples, ...).  ``device=None`` runs on the GPU; ``"cpu"`` on the
    CPU.
    """
    model = Model.get_context(model)
    device, gen = _device_and_gen(device, random_seed)
    data_env = _data_env(model, device)
    prior: Dict[str, torch.Tensor] = {
        brv.name: torch.full((samples,) + tuple(brv.shape),
                             float(np.mean(brv.Y)), device=device)
        for brv in model.bart_rvs}
    for rv in model.free_rvs:           # declaration order = dependency order
        params = _params(rv.params, lambda env: env, prior, data_env, samples,
                         device)
        prior[rv.name] = _observe(rv.dist, gen, samples, params,
                                  rv.shape or ())
    with_dets = _with_deterministics(model)
    dets = _params([det.expr for det in model.deterministics], with_dets,
                   prior, data_env, samples, device)
    for det, v in zip(model.deterministics, dets):
        prior[det.name] = v
    predictive = {}
    for orv in model.observed_rvs:
        params = _params(orv.params, with_dets, prior, data_env, samples,
                         device)
        shape = (np.shape(orv.observed) if orv.dist is CategoricalDist
                 else orv.observed.shape)
        predictive[orv.name] = _observe(orv.dist, gen, samples, params, shape)

    def host(d):
        return {k_: v.cpu().numpy() for k_, v in d.items()}

    out = InferenceData()
    out.add_group("prior", _group(host(prior), (1, samples), var_names))
    out.add_group("prior_predictive", _group(host(predictive), (1, samples),
                                             var_names))
    out._model = model
    return out


def sample_posterior_predictive(
    idata: InferenceData,
    model: Optional[Model] = None,
    var_names=None,
    sample_vars=None,
    predictions: bool = False,
    extend_inferencedata: bool = True,
    random_seed: Optional[int] = None,
    device=None,
) -> InferenceData:
    """Sample the observation nodes given posterior draws.

    ``sample_vars`` may include BART variable names to also return their
    (possibly recomputed out-of-sample) values.  ``predictions=True`` names
    the group ``predictions`` instead of ``posterior_predictive``;
    ``extend_inferencedata`` adds it to ``idata`` (else a new
    ``InferenceData`` holds it).  ``device=None`` runs on the GPU; ``"cpu"``
    on the CPU.
    """
    if model is None:
        model = getattr(idata, "_model", None)
    model = Model.get_context(model)
    device, gen = _device_and_gen(device, random_seed)
    requested = sample_vars or var_names

    post = idata.posterior
    some = next(iter(post.keys()))
    chains, draws = post[some].values.shape[:2]
    total = chains * draws
    env_flat: Dict[str, np.ndarray] = {}
    for name in post.keys():
        v = np.asarray(post[name].values)
        env_flat[name] = v.reshape((total,) + v.shape[2:])

    # recompute BART values where the covariates changed (out-of-sample)
    for brv in model.bart_rvs:
        pf = brv.all_trees
        if pf is None:
            continue
        X_cur = np.asarray(brv.current_X(), np.float32)
        ref = pf[0] if isinstance(pf, list) else pf
        # NaN-aware: a NaN covariate is not the value 0.0
        same = (X_cur.shape == ref.X_train.shape and np.array_equal(
            X_cur, np.asarray(ref.X_train, np.float32), equal_nan=True))
        if same:
            continue
        idx = np.arange(ref.n_total)
        if isinstance(pf, list):        # separate trees: a store per output
            pred = np.concatenate([predict_draw_indices(p_, X_cur, idx,
                                                        device=device)
                                   for p_ in pf], axis=-1)
        else:
            pred = predict_draw_indices(pf, X_cur, idx, device=device)
        env_flat[brv.name] = (pred[..., 0] if len(brv.shape) == 1
                              else np.swapaxes(pred, -1, -2))

    data_env = _data_env(model, device)
    per_draw = {k_: torch.as_tensor(np.asarray(v, np.float32), device=device)
                for k_, v in env_flat.items()}

    with_dets = _with_deterministics(model)
    sampled = {}
    for orv in model.observed_rvs:
        if requested is not None and orv.name not in requested:
            continue
        params = _params(orv.params, with_dets, per_draw, data_env, total,
                         device)
        shape = (() if orv.dist is CategoricalDist
                 else _obs_shape(orv, params))
        sampled[orv.name] = _observe(orv.dist, gen, total, params,
                                     shape).cpu().numpy()
    # requested non-observed variables (e.g. recomputed BART values)
    for name in requested or ():
        if name not in sampled and name in env_flat:
            sampled[name] = env_flat[name]

    group_name = "predictions" if predictions else "posterior_predictive"
    ds = _group(sampled, (chains, draws))
    if extend_inferencedata:
        idata.add_group(group_name, ds)
        return idata
    out = InferenceData()
    out.add_group(group_name, ds)
    return out
