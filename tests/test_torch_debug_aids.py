"""The debug aids of the port's ``sample()`` on the CPU: ``posterior_dtype``
(half-precision storage of the collected values), ``debug_nans`` (a
``FloatingPointError`` at the first draw whose state is not finite) and
``profile_dir`` (a ``torch.profiler`` trace of the draw loop)."""

import json
import os

import numpy as np
import pytest
import torch

import pymc_bart_tpu_torch as tpmb

KW = dict(tune=10, draws=10, chains=2, random_seed=0, device="cpu",
          convergence_checks=False)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(nan_target=False):
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(80, 3))
    Y = (X[:, 0] * 5 + rng.normal(size=80)).astype(np.float32)
    if nan_target:
        Y[7] = np.nan
    return X, Y


def _sample(nan_target=False, **kw):
    X, Y = _data(nan_target)
    with tpmb.Model():
        mu = tpmb.BART("mu", X, Y, m=4)
        s = tpmb.HalfNormal("sigma", 1.0)
        tpmb.Normal("y", mu, s, observed=Y)
        return tpmb.sample(**{**KW, **kw})


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_posterior_dtype_half_precision(dtype):
    """The JAX package's ``test_posterior_dtype_half_precision``: a float32
    posterior within 1e-2 of the float32 run relative to its largest value;
    the sample stats are not cast."""
    half = _sample(posterior_dtype=dtype, store_trees=False)
    full = _sample(store_trees=False)
    for name in ("mu", "sigma"):
        a, b = half.posterior[name].values, full.posterior[name].values
        assert a.dtype == np.float32 and a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1.0)
        assert float(np.abs(a - b).max()) / scale < 1e-2, name
        assert not np.array_equal(a, b)     # the storage was half precision
    for name in full.sample_stats.keys():
        np.testing.assert_array_equal(half.sample_stats[name].values,
                                      full.sample_stats[name].values)


def test_posterior_dtype_refuses_another_type():
    with pytest.raises(ValueError, match="posterior_dtype"):
        _sample(posterior_dtype="float64")


def test_debug_nans_leaves_a_sound_run_unchanged():
    checked = _sample(debug_nans=True)
    plain = _sample()
    for group in ("posterior", "sample_stats"):
        for name in plain[group].keys():
            np.testing.assert_array_equal(checked[group][name].values,
                                          plain[group][name].values)


def test_debug_nans_names_the_draw_and_the_quantity():
    """A NaN in the target makes the sum of trees NaN from the start; the
    first draw step raises, naming it.  Without the check the run ends."""
    with pytest.warns(UserWarning, match="per-round"):
        with pytest.raises(FloatingPointError,
                           match=r"draw 0: sum_trees of 'mu' is not finite"):
            _sample(nan_target=True, debug_nans=True, tune=2, draws=2)
    with pytest.warns(UserWarning, match="per-round"):
        idata = _sample(nan_target=True, tune=2, draws=2)
    assert np.isnan(idata.posterior["mu"].values).any()


def test_profile_dir_writes_a_trace(tmp_path):
    d = str(tmp_path / "prof")
    idata = _sample(profile_dir=d, tune=2, draws=3)
    assert idata.posterior["mu"].shape[1] == 3
    path = os.path.join(d, "draws.pt.trace.json")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in nm for nm in names)
