"""The port's convergence diagnostics (``utils/diagnostics.py``): rank
normalisation with average ranks for ties and the inverse normal of
``torch.special.ndtri``, held to SciPy's (which the test may import and the
port may not) to 1e-12; a constant quantity has R-hat 1 and draws no
warning; chains that disagree still do, and the warning names the
caller's line."""

import warnings

import numpy as np
import pytest
import torch
from scipy.stats import norm, rankdata

from pymc_bart_tpu_torch.models.inference_data import (DataArray, Dataset,
                                                       InferenceData)
from pymc_bart_tpu_torch.utils import diagnostics


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _idata(**variables):
    return InferenceData(posterior=Dataset({
        name: DataArray(v, dims=("chain", "draw")
                        + tuple(f"{name}_dim_{i}" for i in range(v.ndim - 2)))
        for name, v in variables.items()}))


def _scipy_scores(x):
    n = x.shape[0] * x.shape[1]
    flat = x.reshape(n, -1)
    return np.stack([norm.ppf((rankdata(flat[:, j]) - 0.375) / (n + 0.25))
                     for j in range(flat.shape[1])], axis=1).reshape(x.shape)


@pytest.mark.parametrize("ties", [False, True])
def test_rank_normal_scores_equal_scipy(ties):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 60, 3))
    if ties:
        x = np.round(x, 1)             # many tied draws
    else:
        assert len(np.unique(x)) == x.size
    got = diagnostics._rank_normalize(x)
    np.testing.assert_allclose(got, _scipy_scores(x), rtol=0, atol=1e-12)


def test_constant_quantity_has_rhat_one_and_no_warning():
    rng = np.random.default_rng(1)
    mixed = rng.normal(size=(4, 80, 5))
    mixed[:, :, 2] = 3.25              # one row of the function never moves
    idata = _idata(mu=mixed, sigma=np.full((4, 80), 0.5))
    assert float(diagnostics.rhat(np.full((4, 80), 0.5))) == 1.0
    got = diagnostics.check_convergence(idata)
    assert set(got) == {"mu", "sigma"}
    assert got["sigma"] == 1.0 and got["mu"] <= 1.1, got
    with warnings.catch_warnings(record=True) as said:
        warnings.simplefilter("always")
        diagnostics.maybe_warn_convergence(idata)
    assert not said, [str(w.message) for w in said]


def test_chains_that_disagree_are_reported_whatever_the_threshold():
    rng = np.random.default_rng(2)
    apart = rng.normal(size=(4, 80)) + np.arange(4)[:, None] * 3.0
    idata = _idata(theta=apart)
    loose = diagnostics.check_convergence(idata, rhat_threshold=100.0)
    assert loose == diagnostics.check_convergence(idata)   # not a filter
    assert loose["theta"] > 1.1
    with pytest.warns(UserWarning, match="theta"):
        diagnostics.maybe_warn_convergence(idata)


def test_the_convergence_warning_names_the_callers_line():
    """``stacklevel`` counts as ``warnings.warn`` would in the caller: the
    default names the caller's own line, 2 the line that called it (as
    ``sample()`` passes its own caller's)."""
    apart = np.random.default_rng(3).normal(size=(4, 80)) \
        + np.arange(4)[:, None] * 3.0
    idata = _idata(theta=apart)

    def through_a_wrapper():
        return diagnostics.maybe_warn_convergence(idata, stacklevel=2)

    with warnings.catch_warnings(record=True) as said:
        warnings.simplefilter("always")
        diagnostics.maybe_warn_convergence(idata)
        line = _line()
        through_a_wrapper()
    assert [(w.filename, w.lineno) for w in said] == [
        (__file__, line - 1), (__file__, line + 1)]


def _line():
    """The line that called this function."""
    import inspect

    return inspect.currentframe().f_back.f_lineno
