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
tensors a PGBART step is one launch of the large-n or the whole-step kernel
where a gate admits the configuration, else one launch per growth,
SMC-resampling and select-refine round; all five are hand-written CUDA
kernels built from ``csrc/`` at first use.  The interpretability suite
(``plot_pdp``, ``plot_ice``, ``compute_variable_importance``, ...) predicts
the stored draws on the card too.
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
    preprocess_xy,
    sample_posterior_predictive,
    sample_prior_predictive,
    set_data,
)
from .sampler import PGBART, sample
from .utils import (
    PosteriorForests,
    check_convergence,
    compute_variable_importance,
    ess_bulk,
    export_variable_inclusion,
    get_variable_inclusion,
    plot_convergence,
    plot_ice,
    plot_pdp,
    plot_scatter_submodels,
    plot_variable_importance,
    plot_variable_inclusion,
    rhat,
    summary,
    vi_to_kulprit,
)

__all__ = [
    "BART", "BARTRV", "BartConfig", "Bernoulli", "Categorical",
    "ContinuousSplitRule", "Data", "Deterministic", "Exponential", "Gamma",
    "HalfNormal", "InferenceData", "LogNormal", "Model", "NegativeBinomial",
    "Normal", "OneHotSplitRule", "PGBART", "PgbartConfig", "Poisson",
    "PosteriorForests", "SplitRule", "StudentT", "SubsetSplitRule", "Uniform",
    "check_convergence", "compute_variable_importance", "ess_bulk",
    "export_variable_inclusion", "get_variable_inclusion", "math",
    "plot_convergence", "plot_ice", "plot_pdp", "plot_scatter_submodels",
    "plot_variable_importance", "plot_variable_inclusion", "preprocess_xy",
    "rhat", "sample", "sample_posterior_predictive",
    "sample_prior_predictive", "set_data", "summary", "vi_to_kulprit",
]
