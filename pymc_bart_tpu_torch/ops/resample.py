"""Systematic resampling of SMC particles (PyTorch).

Counterpart of ``pymc_bart_tpu/ops/resample.py``.  These three functions
are the plain semantics the SMC kernel (``ops/smc.py``) is held to.  Each
works on the last axis, so a leading chain axis batches them.  Their sums
over the particles are taken in index order, as the kernels take them
(``ops/sums.py``).
"""

from __future__ import annotations

import torch

from .sums import seq_cumsum, seq_sum, true_div


def normalize_log_weights(log_w: torch.Tensor):
    """Return (normalized probabilities, log-mean weight) over the last axis.

    The log-mean is the value resampled particles' log-weights are reset
    to, preserving the absolute weight scale across rounds.
    """
    m = log_w.max(dim=-1, keepdim=True).values
    w = torch.exp(log_w - m)
    total = seq_sum(w).unsqueeze(-1)
    probs = w / total
    log_mean = m + torch.log(true_div(total, log_w.shape[-1]))
    return probs, log_mean.squeeze(-1)


def systematic_indices(u: torch.Tensor, probs: torch.Tensor, num: int):
    """Systematic resampling: ``num`` ancestor indices ~ probs.

    ``u`` is the uniform the JAX function draws from its key (shape = the
    batch shape of ``probs``); it is an argument here because the port's
    step takes its random numbers from outside.
    """
    ar = torch.arange(num, dtype=torch.float32, device=probs.device)
    positions = true_div(u.unsqueeze(-1) + ar, num)
    cdf = seq_cumsum(probs)
    cdf = cdf / cdf[..., -1:]
    return torch.searchsorted(cdf, positions.contiguous()).to(torch.int32)


def effective_sample_size(probs: torch.Tensor):
    """ESS of normalized weights: 1 / sum p_i^2."""
    return 1.0 / torch.clamp_min(seq_sum(probs * probs), 1e-38)

