"""``sample(mesh=...)`` of the port over gloo ranks on the CPU: the
counterpart of ``tests/test_parallel.py`` and ``tests/test_multihost.py``
(``file://`` rendezvous under the test's directory, no sockets; one
intra-op thread in every rank).

* Chains over 2 ranks (4 chains) and over 4 ranks (8 chains, 2 a rank):
  every rank returns the FULL posterior, equal bit for bit to one process's
  ``sample()`` (every posterior variable, ``sample_stats`` with
  ``variable_inclusion``, the stored forests), on the whole-step, per-round
  and large-n routes and for a generic likelihood (Poisson).
* Checkpoint / resume under a 2-rank chain mesh: interrupted after a draw
  chunk on every rank and resumed, bit for bit the uninterrupted run; rank
  1's checkpoint_dir never holds a file (rank 0 alone reads and writes).
* Rows over a (2 chains x 2 data) mesh: the sharded run meets the bound the
  unsharded run meets (posterior-mean rmse against the true function below
  0.3 std of it), and the JAX package's three refusals are raised with its
  messages.
"""

import os
import warnings

import numpy as np
import pytest
import torch

N = 48
KW = dict(tune=6, draws=6, random_seed=4, device="cpu", num_particles=5,
          convergence_checks=False)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    f = 2 * np.sin(3 * X[:, 0]) + X[:, 1]
    Y = (f + 0.3 * rng.normal(size=n)).astype(np.float32)
    return X, Y, f


def _regression(pmb, n=N, m=5):
    X, Y, _f = _data(n=n)
    mu = pmb.BART("mu", X, Y, m=m, max_depth=3)
    sigma = pmb.HalfNormal("sigma", 1.0)
    pmb.Normal("y", mu, sigma, observed=Y)


def _poisson(pmb):
    X, _Y, f = _data(1)
    y = np.random.default_rng(2).poisson(np.exp(0.5 * f)).astype(np.float32)
    mu = pmb.BART("mu", X, np.log1p(y), m=4, max_depth=3)
    pmb.Poisson("y", pmb.math.exp(mu), observed=y)


MODELS = {
    "fused": (_regression, dict(pgbart_route="fused")),
    "rounds": (_regression, dict(pgbart_route="rounds")),
    "bign": (_regression, dict(pgbart_route="bign")),
    "generic": (_poisson, {}),
}


def _run(build, mesh=None, chains=4, route_warnings=False, **kw):
    """``sample()`` of ``build``'s model: its posterior, sample stats and
    stored forests as one flat dict of arrays (and the per-round route's
    warnings under ``"warned"``)."""
    import pymc_bart_tpu_torch as pmb

    with pmb.Model() as model:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            build(pmb)
            idata = pmb.sample(**{**KW, "chains": chains, **kw}, mesh=mesh)
    out = {}
    if route_warnings:
        out["warned"] = np.array([str(w.message) for w in caught
                                  if "per-round" in str(w.message)])
    for group in ("posterior", "sample_stats"):
        for name, da in idata[group].items():
            out[f"{group}/{name}"] = np.asarray(da.values)
    trees = model.bart_rvs[0].all_trees
    for f in ("split_var", "split_val", "split_set", "leaf", "count",
              "slope"):
        out[f"trees/{f}"] = np.asarray(getattr(trees, f))
    return out


def _assert_same(want, got, tag):
    assert set(want) == set(got), tag
    for k in want:
        assert want[k].dtype == got[k].dtype and want[k].shape == got[k].shape
        np.testing.assert_array_equal(want[k], got[k], err_msg=f"{tag} {k}")


def _rmse(out, n=N):
    _X, _Y, f = _data(n=n)
    post = out["posterior/mu"].reshape(-1, n).mean(axis=0)
    return float(np.sqrt(np.mean((post - f) ** 2))) / float(np.std(f))


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

class _Interrupt(Exception):
    pass


def _save(outdir, rank, tag, out):
    np.savez(os.path.join(outdir, f"{tag}_rank{rank}.npz"), **out)


def _traced_run(pmesh, outdir, rank, tag, build, mesh, **kw):
    """``_run`` with ``timings``: the calls of the program's ``collective``
    span and the increase of ``collective_calls`` are saved beside."""
    before = sum(pmesh.collective_calls.values())
    timings = {}
    out = _run(build, mesh, timings=timings, **kw)
    spans = {k: v[1] for k, v in timings["spans"].items()
             if k.split("/")[-1] == "collective"}
    _save(outdir, rank, f"{tag}_collectives", {
        "calls": np.array(sum(pmesh.collective_calls.values()) - before),
        "span_calls": np.array(sum(spans.values())),
        "paths": np.array(sorted(spans))})
    return out


def _world_of_two(rank, init_file, outdir):
    torch.set_num_threads(1)
    from pymc_bart_tpu_torch.parallel import mesh as pmesh
    from pymc_bart_tpu_torch.sampler import compound
    from pymc_bart_tpu_torch.utils import checkpoint as ck

    pmesh.initialize_distributed(f"file://{init_file}", 2, rank,
                                 device="cpu")
    mesh = pmesh.make_mesh()
    for tag, (build, kw) in MODELS.items():
        _save(outdir, rank, tag, _traced_run(pmesh, outdir, rank, tag, build,
                                             mesh, **kw))
    # checkpoint / resume: every rank stops once the checkpoint of step 10
    # (6 tuning + 4 draws) is on disk, then all resume.  Rank 1's
    # checkpoint_dir is a directory of its own that nothing writes to (ranks
    # on hosts without a shared filesystem): it resumes from rank 0's files.
    ckdir = os.path.join(outdir, "ckpt")
    mine = ckdir if rank == 0 else os.path.join(outdir, "ckpt_rank1")
    real = compound.pmesh.broadcast_object

    def broadcast_object(obj, m):
        obj = real(obj, m)
        found = ck.latest_checkpoint(ckdir)
        if found is not None and found[1] == 10:
            raise _Interrupt()
        return obj

    compound.pmesh.broadcast_object = broadcast_object
    try:
        _run(_regression, mesh, checkpoint_dir=mine, chunk_size=2)
        raise AssertionError("the run was not interrupted")
    except _Interrupt:
        pass
    finally:
        compound.pmesh.broadcast_object = real
    _save(outdir, rank, "resumed", _run(
        _regression, mesh, checkpoint_dir=mine, chunk_size=2, resume=True))
    try:
        _run(_regression, mesh, chains=3)
        message = ""
    except ValueError as e:
        message = str(e)
    _save(outdir, rank, "odd_chains", {"message": np.array(message)})
    torch.distributed.destroy_process_group()


def _world_of_four(rank, init_file, outdir):
    torch.set_num_threads(1)
    from pymc_bart_tpu_torch.parallel import mesh as pmesh

    pmesh.initialize_distributed(f"file://{init_file}", 4, rank,
                                 device="cpu")
    _save(outdir, rank, "chains8",
          _run(_regression, pmesh.make_mesh(), chains=8))
    mesh = pmesh.make_mesh(n_data_shards=2)
    _save(outdir, rank, "rows", _traced_run(
        pmesh, outdir, rank, "rows", _regression_long, mesh,
        route_warnings=True, **_LONG))
    refusals = []
    import pymc_bart_tpu_torch as pmb
    for build in (_refused_generic, _refused_linear, _refused_deterministic):
        with pmb.Model():
            build(pmb)
            try:
                pmb.sample(**KW, chains=4, mesh=mesh)
                refusals.append("")
            except ValueError as e:
                refusals.append(str(e))
    _save(outdir, rank, "refusals", {"messages": np.array(refusals)})
    torch.distributed.destroy_process_group()


def _regression_long(pmb):
    _regression(pmb, n=96, m=8)


_LONG = dict(tune=30, draws=30)


def _refused_generic(pmb):
    _poisson(pmb)


def _refused_linear(pmb):
    X, Y, _f = _data()
    mu = pmb.BART("mu", X, Y, m=4, response="linear")
    pmb.Normal("y", mu, 0.5, observed=Y)


def _refused_deterministic(pmb):
    X, Y, _f = _data()
    mu = pmb.BART("mu", X, Y, m=4)
    pmb.Deterministic("twice", mu * 2.0)
    pmb.Normal("y", mu, 0.5, observed=Y)


def _load(d, tag, world):
    return [dict(np.load(os.path.join(d, f"{tag}_rank{r}.npz")))
            for r in range(world)]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    from pymc_bart_tpu_torch.parallel.mesh import run_local_world

    d = str(tmp_path_factory.mktemp("world2"))
    run_local_world(_world_of_two, 2, args=(os.path.join(d, "init"), d),
                    timeout=300)
    return d


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    from pymc_bart_tpu_torch.parallel.mesh import run_local_world

    d = str(tmp_path_factory.mktemp("world4"))
    run_local_world(_world_of_four, 4, args=(os.path.join(d, "init"), d),
                    timeout=300)
    return d


@pytest.mark.parametrize("tag", list(MODELS))
def test_chains_over_two_ranks_bit_for_bit(two, tag):
    build, kw = MODELS[tag]
    want = _run(build, **kw)
    for got in _load(two, tag, 2):
        _assert_same(want, got, f"{tag}")


def test_chains_over_four_ranks_two_a_rank_bit_for_bit(four):
    want = _run(_regression, chains=8)
    assert want["posterior/mu"].shape == (8, KW["draws"], N)
    for got in _load(four, "chains8", 4):
        _assert_same(want, got, "8 chains over 4 ranks")
    # the chains differ (independent streams)
    last = want["posterior/mu"][:, -1]
    assert np.unique(last.round(4), axis=0).shape[0] > 1


def test_checkpoint_resume_under_a_chain_mesh_bit_for_bit(two):
    want = _run(_regression, checkpoint_dir=None, chunk_size=2)
    for got in _load(two, "resumed", 2):
        _assert_same(want, got, "resumed")
    assert sorted(f for f in os.listdir(os.path.join(two, "ckpt"))
                  if f.startswith("draws_"))[-1] == "draws_00000012.npz"
    # rank 0 alone wrote the files: rank 1 resumed without seeing them
    assert not os.path.exists(os.path.join(two, "ckpt_rank1"))


def test_rows_over_a_data_axis_meet_the_unsharded_bound(four):
    ranks = _load(four, "rows", 4)
    for got in ranks[1:]:
        for k in ranks[0]:
            np.testing.assert_array_equal(ranks[0][k], got[k], err_msg=k)
    got = ranks[0]
    assert got["posterior/mu"].shape == (4, _LONG["draws"], 96)
    assert np.isfinite(got["posterior/mu"]).all()
    assert len(got["warned"]) == 1 and "'data' axis" in got["warned"][0]
    unsharded = _run(_regression_long, **_LONG)
    assert _rmse(unsharded, 96) < 0.3
    assert _rmse(got, 96) < 0.3, _rmse(got, 96)


def test_row_sharding_refusals(four):
    want = ["requires a fused likelihood",
            "row sharding supports response='constant' only",
            "row sharding does not support Deterministic tracking"]
    for r in _load(four, "refusals", 4):
        for msg, pat in zip(r["messages"].tolist(), want):
            assert pat in msg, (msg, pat)


@pytest.mark.parametrize("tag", list(MODELS) + ["rows"])
def test_collective_span_counts_every_collective(two, four, tag):
    world, d = (4, four) if tag == "rows" else (2, two)
    for r in _load(d, f"{tag}_collectives", world):
        assert int(r["calls"]) > 0
        assert int(r["span_calls"]) == int(r["calls"]), r
        paths = set(r["paths"].tolist())
        # the drained chunks' gathering in the draw phase, the adaptation's
        # mean after the tuning phase
        assert {"draw/collective", "collective"} <= paths
        if tag == "rows":       # NUTS's observed sums, PGBART's reductions
            assert {"draw/nuts_step/nuts_leapfrog/collective",
                    "draw/pgbart_step/collective"} <= paths, paths


def test_chains_not_a_multiple_of_the_mesh_raise(two):
    for r in _load(two, "odd_chains", 2):
        assert str(r["message"]) == ("chains=3 must be a multiple of the "
                                     "mesh 'chains' axis size 2")
