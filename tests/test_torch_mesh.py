"""The port's ``parallel/mesh.py``: the counterpart of
``tests/test_parallel.py::test_make_mesh_axes``, over gloo ranks on the CPU
(no sockets: ``file://`` rendezvous under ``tmp_path``).

A world of one gives the mesh (1, 1); a world of four gives (4, 1) by
default and (2, 2) with two data shards, rank ``c * 2 + d`` at ``(c, d)``,
with the data group of a rank its chain shard's two ranks and the chains
group its data shard's.  The sampler's collectives are checked on those
groups with known values."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pymc_bart_tpu_torch.parallel import mesh as pmesh


def _world_of_four(rank, init_file, outdir):
    torch.set_num_threads(1)
    pmesh.initialize_distributed(f"file://{init_file}", 4, rank,
                                 device="cpu")
    out = {}
    flat = pmesh.make_mesh()
    out["flat_shape"] = np.array(pmesh.mesh_shape(flat))
    out["flat_chains"] = np.array(pmesh.chain_sharding(flat, 8).indices(8))
    try:
        pmesh.make_mesh(3, 1)
        out["bad_mesh"] = np.array(0)
    except ValueError:
        out["bad_mesh"] = np.array(1)
    mesh = pmesh.make_mesh(n_data_shards=2)
    out["names"] = np.array(mesh.mesh_dim_names)
    out["shape"] = np.array(pmesh.mesh_shape(mesh))
    out["coords"] = np.array(pmesh.mesh_coords(mesh))
    out["data_group"] = np.array(
        dist.get_process_group_ranks(mesh.get_group("data")))
    out["chains_group"] = np.array(
        dist.get_process_group_ranks(mesh.get_group("chains")))
    out["chain_part"] = np.array(pmesh.chain_sharding(mesh, 6).indices(6))
    rows = pmesh.row_shard(mesh, 9)
    out["rows"] = np.array([rows.row0, rows.n, rows.n_total])
    v = torch.tensor([float(rank), -float(rank)], dtype=torch.float64)
    out["row_sum"] = pmesh.row_sum(v, rows).numpy()
    out["row_max"] = pmesh.row_max(v, rows).numpy()
    mine = torch.full((2, 3), float(rank))
    out["chains_gather"] = pmesh.chains_gather(mine, mesh).numpy()
    out["chains_mean"] = pmesh.chains_mean(mine, mesh).numpy()
    host = {"a": np.full((2, 1, 3), rank), "b": np.full((2, 2), rank * 10),
            "w": np.array([7])}
    g = pmesh.gather_outputs(host, mesh, {"a": 2}, whole=("w",))
    out.update({f"gather_{k}": v for k, v in g.items()})
    out["seed"] = np.array(pmesh.broadcast_object(100 + rank, mesh))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_world")
    pmesh.run_local_world(_world_of_four, 4, args=(str(d / "init"), str(d)),
                          timeout=120)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


def test_make_mesh_axes_world_of_one():
    """Without a world: a world of one process (gloo on an in-memory store),
    mesh (1, 1) with the JAX package's axis names; every chain and row is
    this rank's and no rows are sharded."""
    assert not dist.is_initialized()
    try:
        mesh = pmesh.make_mesh()
        assert mesh.mesh_dim_names == ("chains", "data")
        assert pmesh.mesh_shape(mesh) == (1, 1)
        assert pmesh.mesh_coords(mesh) == (0, 0)
        assert pmesh.chain_sharding(mesh, 4) == slice(0, 4)
        assert pmesh.row_sharding(mesh, 10) == slice(0, 10)
        assert pmesh.row_shard(mesh, 10) is None
        t = torch.arange(3.0)
        assert pmesh.row_sum(t, None) is t
        assert torch.equal(pmesh.chains_mean(t[:, None], mesh)[0], t.mean()[None])
    finally:
        dist.destroy_process_group()


def test_no_mesh_and_one_process_are_no_ops():
    assert pmesh.mesh_shape(None) == (1, 1)
    assert pmesh.chain_sharding(None, 3) == slice(0, 3)
    assert pmesh.broadcast_object(5, None) == 5
    pmesh.initialize_distributed(num_processes=1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        pmesh.initialize_distributed(num_processes=2)


def test_row_bounds_split_like_array_split():
    for n, parts in ((10, 3), (64, 2), (5, 5), (7, 4)):
        b = pmesh.row_bounds(n, parts)
        want = np.cumsum([0] + [len(a) for a in np.array_split(
            np.arange(n), parts)])
        assert b == want.tolist()


def test_world_of_four_default_mesh(four):
    for r in four:
        assert tuple(r["flat_shape"]) == (4, 1)
        assert r["bad_mesh"] == 1
    assert [tuple(r["flat_chains"])[:2] for r in four] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]


def test_world_of_four_two_by_two(four):
    for rank, r in enumerate(four):
        c, d = divmod(rank, 2)
        assert tuple(r["names"]) == ("chains", "data")
        assert tuple(r["shape"]) == (2, 2)
        assert tuple(r["coords"]) == (c, d)
        assert r["data_group"].tolist() == [2 * c, 2 * c + 1]
        assert r["chains_group"].tolist() == [d, d + 2]
        assert tuple(r["chain_part"])[:2] == (3 * c, 3 * c + 3)
        # rows 0..4 and 5..8 of 9
        assert r["rows"].tolist() == ([0, 5, 9] if d == 0 else [5, 4, 9])


def test_world_of_four_collectives(four):
    for rank, r in enumerate(four):
        c, d = divmod(rank, 2)
        pair = [2 * c, 2 * c + 1]
        assert r["row_sum"].tolist() == [sum(pair), -sum(pair)]
        assert r["row_max"].tolist() == [max(pair), -min(pair)]
        # chains gathered over the data shard's ranks d and d + 2
        want = np.repeat([float(d), float(d + 2)], 2)[:, None] * np.ones(3)
        np.testing.assert_array_equal(r["chains_gather"], want)
        np.testing.assert_array_equal(r["chains_mean"],
                                      want.mean(0, keepdims=True))
        # the whole on every rank: chains over the chain shards, the rows of
        # "a" over the data shards, "b" from each chain shard's first rank
        a = np.concatenate([np.concatenate(
            [np.full((2, 1, 3), 2 * cc + dd) for dd in (0, 1)], axis=2)
            for cc in (0, 1)], axis=0)
        np.testing.assert_array_equal(r["gather_a"], a)
        np.testing.assert_array_equal(
            r["gather_b"], np.concatenate([np.full((2, 2), 0),
                                           np.full((2, 2), 20)]))
        assert r["gather_w"].tolist() == [7]
        assert int(r["seed"]) == 100


def _fails(rank, init_file):
    if rank == 1:
        raise RuntimeError("rank 1 fails")


def _hangs(rank, init_file):
    import time
    time.sleep(60)


def test_run_local_world_raises_for_a_failing_or_late_rank(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails"):
        pmesh.run_local_world(_fails, 2, args=(str(tmp_path / "a"),),
                              timeout=60)
    with pytest.raises(TimeoutError):
        pmesh.run_local_world(_hangs, 2, args=(str(tmp_path / "b"),),
                              timeout=3)
