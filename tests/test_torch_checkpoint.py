"""Checkpoint and resume of the port's ``sample()`` (``utils/checkpoint.py``),
on the CPU, without JAX.

A run interrupted after a chunk and resumed from its checkpoint directory
returns what the uninterrupted run returns, bit for bit: posterior, sample
stats, ``variable_inclusion`` and the stored forests.  The interruption is
real: ``save_checkpoint`` raises once it has written the chosen step, so the
directory holds exactly what a run killed there leaves behind."""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

import pymc_bart_tpu_torch as tpmb
from pymc_bart_tpu_torch.sampler import compound
from pymc_bart_tpu_torch.utils import checkpoint as ck

N, P_COLS = 40, 3
KW = dict(tune=6, draws=9, chains=2, num_particles=4, random_seed=3,
          device="cpu", convergence_checks=False, chunk_size=3)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread each, since the suite
    runs several workers on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(N, P_COLS)).astype(np.float32)
    Y = (3 * np.sin(3 * X[:, 0]) + X[:, 1]
         + 0.3 * rng.normal(size=N)).astype(np.float32)
    return X, Y


def _friedman_model(m=5):
    X, Y = _data()

    def build():
        mu = tpmb.BART("mu", X, Y, m=m, max_depth=3)
        sigma = tpmb.HalfNormal("sigma", 1.0)
        tpmb.Normal("y", mu, sigma, observed=Y)
    return build


def _het_model():
    X, Y = _data(1)

    def build():
        w = tpmb.BART("w", X, Y, m=4, max_depth=3, shape=(2, N),
                      separate_trees=True)
        tpmb.Normal("y", w[0], tpmb.math.abs(w[1]) + 0.1, observed=Y)
    return build


def _run(build, **kw):
    """``sample()`` of the model ``build`` makes; returns the InferenceData
    and the stored forests (a list of stores for separate trees)."""
    with tpmb.Model() as model:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            build()
            idata = tpmb.sample(**{**KW, **kw})
    trees = model.bart_rvs[0].all_trees
    return idata, trees if isinstance(trees, list) else [trees]


class _Interrupt(Exception):
    pass


def _interrupted(build, directory, at_step, monkeypatch, **kw):
    """Run until the checkpoint of step ``at_step`` is written, then stop."""
    real = ck.save_checkpoint

    def save(directory, state, meta=None, step=0):
        path = real(directory, state, meta, step)
        if step == at_step:
            raise _Interrupt(step)
        return path

    monkeypatch.setattr(ck, "save_checkpoint", save)
    with pytest.raises(_Interrupt):
        _run(build, checkpoint_dir=directory, **kw)
    monkeypatch.setattr(ck, "save_checkpoint", real)


def _assert_same(a, b):
    (ia, ta), (ib, tb) = a, b
    for group in ("posterior", "sample_stats"):
        da, db = ia[group], ib[group]
        assert set(da.keys()) == set(db.keys())
        for name in da.keys():
            va, vb = np.asarray(da[name].values), np.asarray(db[name].values)
            assert va.dtype == vb.dtype and va.shape == vb.shape, name
            np.testing.assert_array_equal(va, vb, err_msg=f"{group} {name}")
    assert len(ta) == len(tb)
    for sa, sb in zip(ta, tb):
        for f in ("split_var", "split_val", "split_set", "leaf", "count",
                  "slope"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f),
                                          err_msg=f)


@pytest.mark.parametrize("at_step", [3, 12], ids=["tuning", "draws"])
def test_resume_after_an_interrupt_is_bit_for_bit(at_step, tmp_path,
                                                  monkeypatch):
    """Interrupted after the first tuning chunk (step 3 of 6) or after the
    second draw chunk (step 12 = 6 tuning + 6 draws); resumed, the result
    equals the uninterrupted run's, which equals a run that saves nothing."""
    build = _friedman_model()
    plain = _run(build)
    full = _run(build, checkpoint_dir=str(tmp_path / "full"))
    _assert_same(full, plain)
    d = str(tmp_path / "cut")
    _interrupted(build, d, at_step, monkeypatch)
    assert ck.latest_checkpoint(d)[1] == at_step
    assert len(ck.load_draw_chunks(d)) == max(0, (at_step - 6) // 3)
    _assert_same(_run(build, checkpoint_dir=d, resume=True), full)


def test_resume_with_more_draws_returns_the_full_posterior(tmp_path):
    """The JAX package's ``test_checkpoint_resume``: a finished run of 10
    draws resumed with ``draws=20`` runs only the remaining 10 and returns
    all 20, the first 10 the original run's; bit for bit the run that asked
    for 20 at once."""
    build = _friedman_model()
    kw = dict(tune=10, chains=1, random_seed=5, chunk_size=10)
    d = str(tmp_path / "ck")
    first, _ = _run(build, draws=10, checkpoint_dir=d, **kw)
    assert ck.latest_checkpoint(d)[1] == 20
    meta = ck.load_meta(d)
    assert (meta["step"], meta["tune"], meta["draws"]) == (20, 10, 10)
    assert meta["package"] == "pymc_bart_tpu_torch"
    second = _run(build, draws=20, checkpoint_dir=d, resume=True, **kw)
    assert second[0].posterior["mu"].shape == (1, 20, N)
    np.testing.assert_array_equal(second[0].posterior["mu"].values[:, :10],
                                  first.posterior["mu"].values)
    _assert_same(second, _run(build, draws=20, **kw))


def _finished_run(tmp_path):
    d = str(tmp_path / "ck")
    _run(_friedman_model(), checkpoint_dir=d, tune=3, draws=3)
    return d


@pytest.mark.parametrize("meta, word", [
    (None, "no format stamp"),
    ({"format_version": ck.FORMAT_VERSION + 1,
      "package": "pymc_bart_tpu_torch"}, "format_version=2"),
    ({"step": 6, "format_version": 2, "package_version": "0.4.0",
      "tune": 3, "draws": 3}, "JAX"),
], ids=["unstamped", "wrong_version", "jax_package"])
def test_check_format_refuses(meta, word, tmp_path):
    """An unstamped checkpoint, another format version and one stamped by
    the JAX package (its meta as that package writes it) are refused, by
    ``check_format`` and by ``sample(resume=True)``."""
    d = _finished_run(tmp_path)
    path = os.path.join(d, "meta.json")
    if meta is None:
        os.remove(path)
    else:
        with open(path, "w") as f:
            json.dump(meta, f)
    with pytest.raises(ValueError, match=word):
        ck.check_format(d)
    with pytest.raises(ValueError, match=word):
        _run(_friedman_model(), checkpoint_dir=d, resume=True, tune=3,
             draws=3)


def test_a_carry_of_another_shape_is_refused(tmp_path):
    """Resuming with another number of trees names the first array that
    differs."""
    d = _finished_run(tmp_path)
    with pytest.raises(ValueError, match="'pgbart/mu/forest.split_var'"):
        _run(_friedman_model(m=6), checkpoint_dir=d, resume=True, tune=3,
             draws=3)


def test_checkpoint_holds_the_whole_carry(tmp_path):
    """Every field of every forest entry's state and of the HMC state, and
    the generator's state; written atomically (no temporary file left) and
    restored onto the run's device with dtypes kept."""
    d = _finished_run(tmp_path)
    assert not [f for f in os.listdir(d) if ".tmp" in f]
    path, step = ck.latest_checkpoint(d)
    with np.load(path) as data:
        names = set(data.files)
        assert data["generator"].dtype == np.uint8
    want = {"generator"}
    want |= {f"pgbart/mu/forest.{f.name}"
             for f in dataclasses.fields(compound.Forest)}
    want |= {f"pgbart/mu/{f.name}"
             for f in dataclasses.fields(compound.pgbart.PgbartState)
             if f.name != "forest"}
    want |= {f"hmc/{f.name}"
             for f in dataclasses.fields(compound.hmc.HmcState)}
    assert names == want
    like = {"hmc/theta": torch.zeros((2, 1)), "generator":
            torch.zeros(torch.Generator().get_state().shape,
                        dtype=torch.uint8)}
    with pytest.raises(ValueError, match="missing"):
        ck.load_checkpoint(path, like)
    with np.load(path) as data:
        like = {k: torch.from_numpy(np.zeros_like(data[k]))
                for k in data.files}
    got = ck.load_checkpoint(path, like)
    assert got["pgbart/mu/forest.split_set"].dtype == torch.int32
    assert all(got[k].dtype == like[k].dtype for k in like)
    chunks = ck.load_draw_chunks(d)
    assert len(chunks) == 1 and chunks[0]["vi"].shape[1] == 3


@pytest.mark.parametrize("case", ["separate_trees", "ancestor_sampling"])
def test_resume_is_bit_for_bit_for_other_samplers(case, tmp_path,
                                                  monkeypatch):
    """A separate-trees model (two forest entries in the carry) and a run
    with ``ancestor_sampling`` (rejuvenation numbers from the same
    generator) resume bit for bit too."""
    if case == "separate_trees":
        build, kw = _het_model(), {}
    else:
        build, kw = _friedman_model(), dict(ancestor_sampling=True)
    full = _run(build, checkpoint_dir=str(tmp_path / "full"), **kw)
    d = str(tmp_path / "cut")
    _interrupted(build, d, 9, monkeypatch, **kw)
    _assert_same(_run(build, checkpoint_dir=d, resume=True, **kw), full)
