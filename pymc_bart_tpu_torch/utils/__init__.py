from .diagnostics import (check_convergence, ess_bulk, maybe_warn_convergence,
                          rhat, summary)
from .posterior import PosteriorForests

__all__ = ["PosteriorForests", "check_convergence", "ess_bulk",
           "maybe_warn_convergence", "rhat", "summary"]
