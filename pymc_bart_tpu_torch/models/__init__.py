from .expr import Const, Expr, Op, evaluate, math
from .inference_data import Coord, DataArray, Dataset, InferenceData
from .model import (
    BART,
    BARTRV,
    Bernoulli,
    Categorical,
    Data,
    Deterministic,
    Exponential,
    FreeRV,
    Gamma,
    HalfNormal,
    LogNormal,
    Model,
    NegativeBinomial,
    Normal,
    ObservedRV,
    Poisson,
    StudentT,
    Uniform,
    preprocess_xy,
    set_data,
)
from .predictive import sample_posterior_predictive, sample_prior_predictive

__all__ = [
    "BART", "BARTRV", "Bernoulli", "Categorical", "Const", "Coord", "Data",
    "DataArray", "Dataset", "Deterministic", "Exponential", "Expr", "FreeRV",
    "Gamma", "HalfNormal", "InferenceData", "LogNormal", "Model",
    "NegativeBinomial", "Normal", "ObservedRV", "Op", "Poisson", "StudentT",
    "Uniform", "evaluate", "math", "preprocess_xy",
    "sample_posterior_predictive", "sample_prior_predictive", "set_data",
]
