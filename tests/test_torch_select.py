"""The port's plain select-refine round against the JAX package's Pallas
kernel (interpret mode on the CPU), on the same NumPy-seeded inputs.

Tolerances: structure and ``leaf_idx`` exactly equal; ``split_val`` rtol
1e-5 / atol 1e-6; leaves and predictions rtol 1e-4 / atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymc_bart_tpu.ops.select_pallas import select_refine_pallas

from pymc_bart_tpu_torch.ops.select import select_refine, select_refine_plain


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, R, P=5, S=15, n=32):
    rng = np.random.default_rng(seed)
    sv = rng.integers(-1, 2, size=(P, S)).astype(np.int32)
    sl = rng.normal(size=(P, S)).astype(np.float32)
    st = rng.integers(0, 2**32, size=(P, S), dtype=np.uint32)
    lf = rng.normal(size=(P, 1, S)).astype(np.float32)
    ct = rng.integers(0, 5, size=(P, S)).astype(np.float32)
    li = rng.integers(0, S, size=(P, n)).astype(np.int32)
    pred = np.take_along_axis(lf[:, 0, :], li, axis=1)[:, None, :]
    return dict(
        sv=sv, sl=sl, st=st, lf=lf, ct=ct, li=li, pred=pred,
        log_w=rng.normal(size=P).astype(np.float32),
        resid=rng.normal(size=(1, n)).astype(np.float32),
        llw=rng.uniform(0.5, 2.0, size=(1, n)).astype(np.float32),
        eps=(0.3 * rng.normal(size=(R, 1, S))).astype(np.float32),
        # large accept uniforms: both accepted and rejected sweeps occur
        u_acc=rng.uniform(0.2, 1.0, size=R).astype(np.float32),
        u_sel=np.float32(rng.random()), hiv=np.float32(0.5 / 1.3**2), R=R)


def _run_jax(c, m):
    J = jnp.asarray
    out = select_refine_pallas(
        J(c["sv"]), J(c["sl"]), J(c["st"]), J(c["lf"]), J(c["ct"]),
        J(c["li"]), J(c["pred"]), J(c["log_w"]), J(c["resid"]), J(c["llw"]),
        J(c["eps"]), J(c["u_acc"]), J(c["u_sel"]), J(c["hiv"]),
        num_refinements=c["R"], m=m)
    return [np.asarray(o) for o in out]


def _run_torch(cases, m, fn=select_refine_plain, **kw):
    def T(key, bits=False):
        arrs = [np.asarray(c[key]) for c in cases]
        if bits:
            arrs = [np.ascontiguousarray(a).view(np.int32) for a in arrs]
        return torch.from_numpy(np.stack(arrs))

    out = fn(T("sv"), T("sl"), T("st", bits=True), T("lf"), T("ct"), T("li"),
             T("pred"), T("log_w"), T("resid"), T("llw"), T("eps"),
             T("u_acc"), T("u_sel"), T("hiv"), num_refinements=cases[0]["R"],
             m=m, **kw)
    out = [o.numpy() for o in out]
    out[2] = out[2].view(np.uint32)
    return out


def _compare(want, got):
    for i in (0, 2, 5):  # split_var, split_set, leaf_idx
        np.testing.assert_array_equal(want[i], got[i])
    np.testing.assert_allclose(want[1], got[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(want[4], got[4])  # counts are integers
    np.testing.assert_allclose(want[3], got[3], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(want[6], got[6], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("R", [1, 5])
def test_select_plain_matches_pallas(R, seed):
    c = _inputs(seed, R)
    want = _run_jax(c, m=3)
    got = [o[0] for o in _run_torch([c], m=3)]
    _compare(want, got)


def test_select_refinement_moves_leaves_and_chains_are_independent():
    cases = [_inputs(10 + i, 5) for i in range(3)]
    got = _run_torch(cases, m=3, fn=select_refine)   # CPU -> plain version
    assert select_refine.launches == 0
    moved = 0
    for i, c in enumerate(cases):
        want = _run_jax(c, m=3)
        _compare(want, [o[i] for o in got])
        widx = int(np.where((c["sv"] == want[0]).all(axis=1))[0][0])
        moved += int(not np.allclose(want[3], c["lf"][widx]))
    assert moved > 0   # at least one chain accepted a refinement sweep
    with pytest.raises(ValueError, match="CUDA"):
        _run_torch(cases, m=3, fn=select_refine, impl="kernel")
