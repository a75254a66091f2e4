from .diagnostics import (check_convergence, ess_bulk, maybe_warn_convergence,
                          rhat, summary)
from .posterior import PosteriorForests, predict_draw_indices, sample_posterior

__all__ = ["PosteriorForests", "check_convergence", "ess_bulk",
           "maybe_warn_convergence", "predict_draw_indices", "rhat",
           "sample_posterior", "summary"]
