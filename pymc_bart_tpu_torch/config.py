"""Frozen configuration dataclasses of the PyTorch port.

Counterpart of ``pymc_bart_tpu/config.py`` (copied: it is pure Python).

The reference carries user configuration as kwargs on ``BART(...)``
(reference ``pymc_bart/bart.py:112-124``: m, alpha, beta, response,
split_rules, split_prior, shape) and sampler configuration as kwargs on
``PGBART(...)`` (reference ``tests/test_bart.py:232``: num_particles;
batch fractions), shipped to the native sampler via ``PyBartSettings``
(reference ``pymc_bart/pymc_bart.py:2``).  Here both levels are frozen
dataclasses (hashable, immutable) passed by value through the sampler.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Split-rule codes (per covariate column).  Mirrors the reference rule set
# ContinuousSplitRule / OneHotSplitRule / SubsetSplitRule
# (reference docs/api_reference.rst:16; string selection in
# tests/test_bart.py:140-155).
RULE_CONTINUOUS = 0
RULE_ONEHOT = 1
RULE_SUBSET = 2

_RULE_NAMES = {
    "ContinuousSplit": RULE_CONTINUOUS,
    "ContinuousSplitRule": RULE_CONTINUOUS,
    "OneHotSplit": RULE_ONEHOT,
    "OneHotSplitRule": RULE_ONEHOT,
    "SubsetSplit": RULE_SUBSET,
    "SubsetSplitRule": RULE_SUBSET,
}


class SplitRule:
    """Base class of the public split-rule markers.

    The reference exports ``ContinuousSplitRule`` / ``OneHotSplitRule`` /
    ``SubsetSplitRule`` classes (reference ``docs/api_reference.rst:16``)
    and also accepts their string names (``tests/test_bart.py:140-155``);
    ``BART(split_rules=[...])`` here takes either form (or raw int
    codes).  The classes are markers only — routing itself is the int
    code dispatched inside the traversal kernels (``ops/trees.py``).
    """

    code: int = RULE_CONTINUOUS


class ContinuousSplitRule(SplitRule):
    """Route left when ``x <= split_value`` (numeric covariates)."""

    code = RULE_CONTINUOUS


class OneHotSplitRule(SplitRule):
    """Route left when ``x == split_value`` (one-hot encoded columns)."""

    code = RULE_ONEHOT


class SubsetSplitRule(SplitRule):
    """Route left when the category is in a random subset of the levels.

    Any number of categories is supported: each split stores a 32-bit
    salt indexing a pseudo-uniform random subset (hash-salted membership,
    ops/trees.py ``subset_member``), with the sampled row's own category
    always a member (reference SubsetSplitRule,
    docs/api_reference.rst:16)."""

    code = RULE_SUBSET


def rule_code(name_or_code) -> int:
    """Map a split rule — class, instance, reference-style name, or int
    code — to the kernel's int code."""
    if isinstance(name_or_code, type) and issubclass(name_or_code, SplitRule):
        return name_or_code.code
    if isinstance(name_or_code, SplitRule):
        return name_or_code.code
    if isinstance(name_or_code, int):
        if name_or_code not in (RULE_CONTINUOUS, RULE_ONEHOT, RULE_SUBSET):
            raise ValueError(f"unknown split rule code {name_or_code}")
        return name_or_code
    try:
        return _RULE_NAMES[str(name_or_code)]
    except KeyError:
        raise ValueError(
            f"unknown split rule {name_or_code!r}; valid: {sorted(_RULE_NAMES)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class BartConfig:
    """Static (hashable) configuration of one BART random variable.

    Matches the user surface of reference ``pymc_bart/bart.py:112-124``.
    ``max_depth`` is new: the engine uses fixed-depth structure-of-arrays
    tree tensors, so tree depth is bounded at ``max_depth`` (the depth prior
    alpha*(1+d)^-beta makes deep nodes exponentially unlikely; with the
    default alpha=0.95, beta=2 the grow probability at depth 6 is ~2%).
    """

    m: int = 50
    alpha: float = 0.95
    beta: float = 2.0
    response: str = "constant"  # "constant" | "linear" | "mix"
    max_depth: int = 6
    n_outputs: int = 1
    # split rules, one code per column; None means all-continuous.
    split_rules: Optional[Tuple[int, ...]] = None
    # multi-output: one tree structure with n_outputs leaf values per
    # node (False, default), or n_outputs fully separate forests sharing
    # the likelihood (True — reference CHANGELOG.md:385 "Allow training
    # separate tree structures if training multiple trees")
    separate_trees: bool = False

    @property
    def n_nodes(self) -> int:
        """Number of node slots in the complete binary tree of depth max_depth."""
        return 2 ** (self.max_depth + 1) - 1

    def __post_init__(self):
        if self.response not in ("constant", "linear", "mix"):
            raise ValueError(f"response must be constant|linear|mix, got {self.response}")
        if not 0.0 < self.alpha < 1.0:
            raise ValueError("alpha must be in (0, 1)")
        if self.beta < 0:
            raise ValueError("beta must be positive")
        if self.max_depth < 1 or self.max_depth > 12:
            raise ValueError("max_depth must be in [1, 12]")


@dataclasses.dataclass(frozen=True)
class PgbartConfig:
    """Static configuration of the particle-Gibbs tree sampler.

    Mirrors the reference PGBART knobs: ``num_particles`` and the
    ``batch=(tune_fraction, draw_fraction)`` pair giving the fraction of the
    m trees updated per MCMC step during tuning and draws (reference
    ``tests/test_bart.py:232-233`` and SURVEY 2.3).
    """

    num_particles: int = 10
    batch: Tuple[float, float] = (0.1, 0.1)
    # Exponential forgetting of the Dirichlet-style split-prior counts:
    # per tree update during tuning, alpha_vec <- alpha_vec * decay +
    # split_counts.  1.0 (default) is the reference's linear accumulation
    # ("alpha_vec[index] += 1").  At high p the uniform initial mass (p
    # pseudo-counts) dilutes the adaptation; a decay slightly below 1
    # washes the base out so the proposal concentrates on the covariates
    # the SMC likelihood keeps selecting (BASELINE config 5).
    split_prior_decay: float = 1.0
    # Metropolis refinement sweeps over the selected tree's leaf values
    # after each SMC tree update.  The SMC's leaf-value proposals are
    # anchored at the node residual mean — near-conjugate for Gaussian
    # likelihoods but mean-reverting for link functions (softmax/logit),
    # where the likelihood's preferred leaf values are far from the
    # pseudo-residual scale.  A few random-walk MH sweeps on the values
    # (structure fixed, likelihood-targeted) restore value mixing there;
    # they are cheap relative to the SMC (one likelihood eval each).
    num_refinements: int = 5
    # Retained-path rejuvenation (the tree-structured counterpart of
    # Particle Gibbs with Ancestor Sampling — see sampler/rejuvenate.py):
    # after each PGBART step, run grow/prune Metropolis sweeps over the
    # committed trees.  Attacks the frozen-particle PG mixing floor
    # (min bulk-ESS ~5/2400 draws on friedman, flat in every other
    # lever) by perturbing retained tree STRUCTURE locally with
    # likelihood-ratio acceptance.  Off by default: behavior is
    # bit-identical to plain PGBART when False.
    ancestor_sampling: bool = False
    rejuvenation_sweeps: int = 1

    def __post_init__(self):
        if self.num_particles < 2:
            raise ValueError("num_particles must be >= 2")
        if self.rejuvenation_sweeps < 1:
            raise ValueError("rejuvenation_sweeps must be >= 1")
        if not 0.0 < self.split_prior_decay <= 1.0:
            raise ValueError("split_prior_decay must be in (0, 1]")
        if self.num_refinements < 0:
            raise ValueError("num_refinements must be >= 0")
        for frac in self.batch:
            if not 0.0 < frac <= 1.0:
                raise ValueError("batch fractions must be in (0, 1]")

    def batch_size(self, m: int, tuning: bool) -> int:
        frac = self.batch[0] if tuning else self.batch[1]
        return max(1, int(round(m * frac)))
