"""The port's plain SMC resampling step against the JAX package's Pallas
kernel (interpret mode on the CPU), on the same NumPy-seeded inputs.

Tolerances: ``take`` exactly equal; ``log_w`` and ``ll_prev`` rtol 1e-4 /
atol 1e-5 (softmax sums are taken in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymc_bart_tpu.ops.smc_pallas import smc_resample_pallas

from pymc_bart_tpu_torch.ops.resample import (effective_sample_size,
                                              normalize_log_weights)
from pymc_bart_tpu_torch.ops.smc import smc_resample, smc_resample_plain


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(trial, P=12):
    rng = np.random.default_rng(trial)
    spread = [0.1, 5.0][trial % 2]  # low spread -> no-resample branch
    ll, llp, lw = (rng.normal(scale=spread, size=P).astype(np.float32)
                   for _ in range(3))
    return ll, llp, lw, np.float32(rng.random())


@pytest.mark.parametrize("trial", range(6))
def test_smc_plain_matches_pallas(trial):
    ll, llp, lw, u = _inputs(trial)
    want = [np.asarray(o) for o in smc_resample_pallas(
        jnp.asarray(ll), jnp.asarray(llp), jnp.asarray(lw), jnp.asarray(u))]
    T = lambda a: torch.from_numpy(np.asarray(a))[None]  # noqa: E731
    got = [o[0].numpy() for o in smc_resample_plain(
        T(ll), T(llp), T(lw), torch.tensor([u]))]
    np.testing.assert_array_equal(want[1], got[1])
    np.testing.assert_allclose(want[0], got[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(want[2], got[2], rtol=1e-4, atol=1e-5)
    resampled = not np.array_equal(got[1], np.arange(len(ll)))
    assert resampled == (trial % 2 == 1)   # both branches occur


def test_smc_chains_are_independent_and_dispatch_is_plain_on_cpu():
    cases = [_inputs(t) for t in range(4)]
    ll, llp, lw = (torch.from_numpy(np.stack([c[i] for c in cases]))
                   for i in range(3))
    u = torch.tensor([c[3] for c in cases])
    batched = smc_resample(ll, llp, lw, u)
    assert smc_resample.launches == 0
    for i in range(4):
        single = smc_resample_plain(ll[i:i + 1], llp[i:i + 1], lw[i:i + 1],
                                    u[i:i + 1])
        for a, b in zip(batched, single):
            np.testing.assert_array_equal(a[i].numpy(), b[0].numpy())
    with pytest.raises(ValueError, match="CUDA"):
        smc_resample(ll, llp, lw, u, impl="kernel")


def test_resample_helpers_match_jax():
    from pymc_bart_tpu.ops import resample as jres

    rng = np.random.default_rng(3)
    lw = rng.normal(scale=2.0, size=9).astype(np.float32)
    p_j, lm_j = jres.normalize_log_weights(jnp.asarray(lw))
    p_t, lm_t = normalize_log_weights(torch.from_numpy(lw))
    np.testing.assert_allclose(np.asarray(p_j), p_t.numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(lm_j), float(lm_t), rtol=1e-5)
    np.testing.assert_allclose(float(jres.effective_sample_size(p_j)),
                               float(effective_sample_size(p_t)), rtol=1e-5)
