"""Model container and random-variable surface (PyTorch port).

Counterpart of ``pymc_bart_tpu/models/model.py``; only ``initial_point``
touches tensors, the rest is the same host-side bookkeeping.

The reference outsources the model container, step assignment, and draw
storage to PyMC (SURVEY section 1, "architectural consequence for the
rebuild") — so this module supplies that part natively: a ``with
Model():`` context, free/observed RV registration, mutable ``Data``
containers for out-of-sample prediction (reference
tests/test_bart.py:84-104), and the ``BART`` distribution itself with the
reference's constructor surface (reference ``pymc_bart/bart.py:112-124``).
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import BartConfig, rule_code
from .distributions import FAMILIES, Dist
from .expr import Expr

_MODEL_STACK: List["Model"] = []


class Model:
    """Collects the RVs declared inside its context.

    ``coords=...`` named dimensions and ``dims=`` on RVs are supported the
    way the reference exercises them (reference tests/test_bart.py:244-256).
    """

    def __init__(self, coords: Optional[Dict[str, Any]] = None):
        self.coords: Dict[str, np.ndarray] = {
            k: np.asarray(v) for k, v in (coords or {}).items()
        }
        self.free_rvs: List[FreeRV] = []
        self.bart_rvs: List[BARTRV] = []
        self.observed_rvs: List[ObservedRV] = []
        self.deterministics: List[Deterministic] = []
        self.data_vars: Dict[str, Data] = {}
        self.named_vars: Dict[str, Any] = {}

    # -- context management -------------------------------------------------
    def __enter__(self):
        _MODEL_STACK.append(self)
        return self

    def __exit__(self, *exc):
        _MODEL_STACK.pop()
        return False

    @staticmethod
    def get_context(model: Optional["Model"] = None) -> "Model":
        if model is not None:
            return model
        if not _MODEL_STACK:
            raise RuntimeError(
                "No model on context stack. Declare variables inside "
                "`with pymc_bart_tpu_torch.Model():` or pass model=..."
            )
        return _MODEL_STACK[-1]

    def _register(self, name: str, var):
        if name in self.named_vars:
            raise ValueError(f"variable name {name!r} already in model")
        self.named_vars[name] = var

    def __getitem__(self, name):
        return self.named_vars[name]

    def set_data(self, new_data: Dict[str, Any]):
        for name, value in new_data.items():
            if name not in self.data_vars:
                raise KeyError(f"no Data container named {name!r}")
            self.data_vars[name].set_value(np.asarray(value, dtype=np.float64))

    def initial_point(self) -> Dict[str, np.ndarray]:
        """Initial values: BART RVs start at Y.mean() broadcast to shape
        (reference support point, bart.py:184-187,219-221); continuous free
        RVs at their distribution's support point."""
        from ..sampler.compound import CompiledModel

        point: Dict[str, np.ndarray] = {}
        for brv in self.bart_rvs:
            point[brv.name] = np.full(brv.shape, float(np.mean(brv.Y)))
        compiled = CompiledModel(self)
        theta0 = compiled.initial_theta()
        off = 0
        for rv, size in zip(compiled.free_params, compiled.param_sizes):
            u = torch.from_numpy(theta0[off : off + size])
            u = u.reshape(rv.shape) if rv.shape else u[0]
            point[rv.name] = rv.dist.transform.forward(u).numpy()
            off += size
        return point


# ---------------------------------------------------------------------------
# variable node types
# ---------------------------------------------------------------------------


class Data(Expr):
    """Mutable data container (the ``pm.Data`` equivalent).

    Out-of-sample prediction works by swapping its value with
    ``set_data`` and re-running posterior prediction, mirroring the
    reference's shared-variable mechanism (reference bart.py:47-65 rng_fn
    predicting on the op's stored X; tests/test_bart.py:100-104).
    """

    def __init__(self, name: str, value, model: Optional[Model] = None, dims=None):
        self.name = name
        self._value = np.asarray(value, dtype=np.float64)
        self.dims = dims
        m = Model.get_context(model)
        m.data_vars[name] = self
        m._register(name, self)

    def get_value(self) -> np.ndarray:
        return self._value

    def set_value(self, value):
        self._value = np.asarray(value, dtype=np.float64)

    @property
    def shape(self):
        return self._value.shape


class FreeRV(Expr):
    """A continuous free RV updated by the HMC/NUTS compound step."""

    def __init__(self, name: str, dist: Dist, params, shape, dims=None,
                 model: Optional[Model] = None):
        self.name = name
        self.dist = dist
        self.params = params  # tuple of Exprs / constants
        self.shape = shape
        self.dims = dims
        m = Model.get_context(model)
        m.free_rvs.append(self)
        m._register(name, self)


class ObservedRV:
    """A likelihood node."""

    def __init__(self, name: str, dist: Dist, params, observed, shape=None,
                 dims=None, model: Optional[Model] = None):
        self.name = name
        self.dist = dist
        self.params = params
        self.observed = np.asarray(observed, dtype=np.float64)
        self.shape = shape if shape is not None else self.observed.shape
        self.dims = dims
        m = Model.get_context(model)
        m.observed_rvs.append(self)
        m._register(name, self)


class Deterministic(Expr):
    def __init__(self, name: str, expr, model: Optional[Model] = None, dims=None):
        self.name = name
        self.expr = expr
        self.dims = dims
        m = Model.get_context(model)
        m.deterministics.append(self)
        m._register(name, self)


def preprocess_xy(X, Y):
    """pandas/polars -> float ndarrays (reference bart.py:190-209)."""
    x_cols = list(X.columns) if hasattr(X, "columns") else None
    if hasattr(Y, "to_numpy"):
        Y = Y.to_numpy()
    if hasattr(X, "to_numpy"):
        X = X.to_numpy()
    if isinstance(X, Data):
        X_arr = X.get_value()
    else:
        X_arr = np.asarray(X, float)
    return X_arr, np.asarray(Y, float).squeeze(), x_cols


class BARTRV(Expr):
    """The BART sum-of-trees random variable.

    Constructor surface mirrors the reference ``BART`` distribution
    (reference ``pymc_bart/bart.py:112-124``):
    ``BART(name, X, Y, m=50, alpha=0.95, beta=2.0, response="constant",
    split_rules=None, split_prior=None, shape=..., dims=...)``.

    After ``sample()`` the posterior forests are attached as
    ``self.all_trees`` (the reference attaches a Manager-list of
    TreeArrays to the RV op, reference bart.py:130-155; here it is a
    ``PosteriorForests`` handle, see utils/posterior.py).
    """

    def __init__(self, name, X, Y, m=50, alpha=0.95, beta=2.0,
                 response="constant", split_rules=None, split_prior=None,
                 shape=None, dims=None, max_depth=6, separate_trees=False,
                 model: Optional[Model] = None, **kwargs):
        if response in ("linear", "mix"):
            warnings.warn(
                "Options linear and mix are experimental and still not well "
                "tested\nUse with caution."
            )
        self.name = name
        X_arr, Y_arr, x_cols = preprocess_xy(X, Y)
        self.X_data = X if isinstance(X, Data) else None
        self.X = X_arr if self.X_data is None else self.X_data.get_value()
        self.Y = Y_arr
        self.x_columns = x_cols
        n = self.X.shape[0]
        p = self.X.shape[1]

        if shape is None:
            n_outputs = 1
            self.shape = (n,)
        else:
            shape = tuple(shape)
            if len(shape) == 1:
                n_outputs = 1
            elif len(shape) == 2:
                n_outputs = shape[0]
            else:
                raise ValueError("BART shape must be (n,) or (k, n)")
            self.shape = shape

        rules = tuple(
            rule_code(r) for r in (split_rules if split_rules is not None else [])
        )
        if rules and len(rules) != p:
            raise ValueError("split_rules must have one entry per column")
        self.config = BartConfig(
            m=m, alpha=alpha, beta=beta, response=response,
            max_depth=max_depth, n_outputs=n_outputs,
            split_rules=rules if rules else None,
            separate_trees=bool(separate_trees) and n_outputs > 1,
        )
        self.split_prior = (
            np.asarray(split_prior, dtype=np.float64)
            if split_prior is not None else np.array([])
        )
        self.dims = dims
        self.all_trees = None  # set by sample(); PosteriorForests
        self.model = Model.get_context(model)
        self.model.bart_rvs.append(self)
        self.model._register(name, self)

    @property
    def ndim(self):
        return len(self.shape)

    def rules_array(self) -> np.ndarray:
        p = self.X.shape[1]
        if self.config.split_rules is None:
            return np.zeros(p, np.int32)
        return np.asarray(self.config.split_rules, np.int32)

    def current_X(self) -> np.ndarray:
        """Covariates to predict on (follows the Data container if any)."""
        if self.X_data is not None:
            return self.X_data.get_value()
        return self.X


def BART(name, X, Y, m=50, alpha=0.95, beta=2.0, response="constant",
         split_rules=None, split_prior=None, **kwargs) -> BARTRV:
    """Reference-parity constructor (reference bart.py:112-124)."""
    return BARTRV(name, X, Y, m=m, alpha=alpha, beta=beta, response=response,
                  split_rules=split_rules, split_prior=split_prior, **kwargs)


# ---------------------------------------------------------------------------
# user-facing distribution constructors (PyMC-shaped)
# ---------------------------------------------------------------------------


def _make_constructor(family_name: str, param_names):
    dist = FAMILIES[family_name]

    def constructor(name, *args, observed=None, shape=None, dims=None,
                    model: Optional[Model] = None, **kwargs):
        params = list(args)
        for pn in param_names[len(args):]:
            if pn in kwargs:
                params.append(kwargs.pop(pn))
        if kwargs and set(kwargs) - {"initval"}:
            unknown = set(kwargs) - {"initval"}
            raise TypeError(f"{family_name}: unexpected kwargs {unknown}")
        params = tuple(params)
        if observed is not None:
            return ObservedRV(name, dist, params, observed, shape=shape,
                              dims=dims, model=model)
        if shape is None:
            shape = ()
        elif isinstance(shape, int):
            shape = (shape,)
        return FreeRV(name, dist, params, shape, dims=dims, model=model)

    constructor.__name__ = family_name
    return constructor


Normal = _make_constructor("Normal", ("mu", "sigma"))
HalfNormal = _make_constructor("HalfNormal", ("sigma",))
Exponential = _make_constructor("Exponential", ("lam",))
Gamma = _make_constructor("Gamma", ("alpha", "beta"))
LogNormal = _make_constructor("LogNormal", ("mu", "sigma"))
Uniform = _make_constructor("Uniform", ("lower", "upper"))
StudentT = _make_constructor("StudentT", ("nu", "mu", "sigma"))
Bernoulli = _make_constructor("Bernoulli", ("p",))
Poisson = _make_constructor("Poisson", ("mu",))
NegativeBinomial = _make_constructor("NegativeBinomial", ("mu", "alpha"))
Categorical = _make_constructor("Categorical", ("p",))


def set_data(new_data: Dict[str, Any], model: Optional[Model] = None):
    Model.get_context(model).set_data(new_data)
