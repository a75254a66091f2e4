from .codec import _decode_vi, _encode_vi, decode_vi, encode_vi
from .diagnostics import (check_convergence, ess_bulk, maybe_warn_convergence,
                          rhat, summary)
from .importance import (
    compute_variable_importance,
    export_variable_inclusion,
    get_variable_inclusion,
    plot_scatter_submodels,
    plot_variable_importance,
    plot_variable_inclusion,
    vi_to_kulprit,
)
from .plots import plot_convergence, plot_ice, plot_pdp
from .posterior import (PosteriorForests, predict_draw_indices,
                        sample_posterior)
from .stats import hdi, pearsonr2

__all__ = [
    "PosteriorForests", "_decode_vi", "_encode_vi", "check_convergence",
    "compute_variable_importance", "decode_vi", "encode_vi", "ess_bulk",
    "export_variable_inclusion", "get_variable_inclusion", "hdi",
    "maybe_warn_convergence", "pearsonr2", "plot_convergence", "plot_ice",
    "plot_pdp", "plot_scatter_submodels", "plot_variable_importance",
    "plot_variable_inclusion", "predict_draw_indices", "rhat",
    "sample_posterior", "summary", "vi_to_kulprit",
]
