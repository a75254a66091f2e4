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
    set_data,
)

__all__ = [
    "BART", "BARTRV", "Bernoulli", "Categorical", "Const", "Coord", "Data",
    "DataArray", "Dataset", "Deterministic", "Exponential", "Expr", "FreeRV",
    "Gamma", "HalfNormal", "InferenceData", "LogNormal", "Model",
    "NegativeBinomial", "Normal", "ObservedRV", "Op", "Poisson", "StudentT",
    "Uniform", "evaluate", "math", "set_data",
]
