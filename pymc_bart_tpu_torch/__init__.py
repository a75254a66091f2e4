"""pymc_bart_tpu_torch: the PyTorch/CUDA port of ``pymc_bart_tpu``.

The JAX package ``pymc_bart_tpu`` is the reference; this package sits beside
it with the same layout (``config.py``, ``ops/``, ``sampler/``, ``models/``,
``utils/``; CUDA sources under ``csrc/``; ``convert.py`` for state carried
across the NumPy boundary) and imports ``torch`` and ``numpy`` only.

Usage (PyMC-shaped)::

    import pymc_bart_tpu_torch as pmb

    with pmb.Model() as model:
        mu = pmb.BART("mu", X, Y, m=50)
        sigma = pmb.HalfNormal("sigma", 1.0)
        y = pmb.Normal("y", mu, sigma, observed=Y)
        idata = pmb.sample(tune=200, draws=600, chains=4)   # on the GPU

``sample`` runs on ``cuda`` unless ``device="cpu"`` is passed.  On CUDA
tensors a PGBART step is one launch of the whole-step kernel where its gate
admits the configuration, else one launch per growth, SMC-resampling and
select-refine round; all four are hand-written CUDA kernels built from
``csrc/`` at first use.
"""

__version__ = "0.1.0"

from .config import (
    BartConfig,
    ContinuousSplitRule,
    OneHotSplitRule,
    PgbartConfig,
    SplitRule,
    SubsetSplitRule,
)
from .models import (
    BART,
    BARTRV,
    Bernoulli,
    Categorical,
    Data,
    Deterministic,
    Exponential,
    Gamma,
    HalfNormal,
    InferenceData,
    LogNormal,
    Model,
    NegativeBinomial,
    Normal,
    Poisson,
    StudentT,
    Uniform,
    math,
    set_data,
)
from .sampler import PGBART, sample
from .utils import PosteriorForests, check_convergence, ess_bulk, rhat, summary

__all__ = [
    "BART", "BARTRV", "BartConfig", "Bernoulli", "Categorical",
    "ContinuousSplitRule", "Data", "Deterministic", "Exponential", "Gamma",
    "HalfNormal", "InferenceData", "LogNormal", "Model", "NegativeBinomial",
    "Normal", "OneHotSplitRule", "PGBART", "PgbartConfig", "Poisson",
    "PosteriorForests", "SplitRule", "StudentT", "SubsetSplitRule", "Uniform",
    "check_convergence", "ess_bulk", "math", "rhat", "sample", "set_data",
    "summary",
]
