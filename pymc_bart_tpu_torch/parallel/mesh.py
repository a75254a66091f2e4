"""Process groups, the (chains, data) mesh and the sampler's collectives
(PyTorch).

Counterpart of ``pymc_bart_tpu/parallel/mesh.py``.  The JAX package runs one
program over a grid of devices; here each process ("rank") of a
``torch.distributed`` world drives one device, ``cuda:<local rank>``
(``initialize_distributed`` sets it), and the grid is a ``DeviceMesh`` of
ranks with the axes ``("chains", "data")``:

* chains: ``sample(mesh=...)`` gives each rank along ``"chains"`` an equal
  block of chains (``chain_sharding``); nothing crosses ranks inside a PGBART
  step.  Every rank draws the random blocks of ALL chains from the one
  generator and keeps its own (``StepRands.shard``), so a run does not depend
  on how the chains are placed.
* data: the rows of X, the targets and the observed values are split over
  ``"data"`` (``row_sharding``, ``row_shard``); child statistics, likelihood
  sums and the split-value winner are reduced over the data group
  (``row_sum`` / ``row_max``), and the tree state stays replicated.
* processes: every rank returns the full posterior (``gather_outputs``).

Collectives run on the process group's own backend.  NCCL refuses two ranks
on one GPU, so ranks that share a card use gloo, which reduces host memory:
a CUDA tensor given to a gloo group is copied to the host, reduced there and
copied back, explicitly in ``_on_host`` (one device synchronisation a
collective).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing

AXES = ("chains", "data")
# collectives issued by this process, by kind (read by chip_smoke.py)
collective_calls = {"all_reduce": 0, "all_gather": 0, "gather_outputs": 0}


def run_local_world(fn, nprocs: int, args=(), timeout: Optional[float] = None
                    ) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes (``spawn``: a
    parent that has touched CUDA cannot fork) and wait for all of them.  A
    rank that raises or exits with another code than 0, or a world that is
    still running after ``timeout`` seconds, ends every rank and raises."""
    import torch.multiprocessing as tmp

    ctx = tmp.start_processes(fn, args=tuple(args), nprocs=nprocs,
                              join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"a world of {nprocs} ranks still ran "
                                   f"after {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()


def local_rank(process_id: int) -> int:
    """The device index of a rank on its host: ``LOCAL_RANK`` (set by
    ``torchrun``), else the process id modulo the visible devices."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_id % max(torch.cuda.device_count(), 1)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None) -> None:
    """Join a world of ``num_processes`` ranks (a no-op for one process).

    ``coordinator_address`` is ``host:port`` (TCP) or an ``init_method``
    URL (``file://...``).  ``backend``: the caller's; by default ``"nccl"``
    when the ranks run on the card and ``"gloo"`` for ``device="cpu"``.  It is
    never switched behind the caller's back.  On the card the rank's device
    becomes ``cuda:<local_rank>``."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize_distributed: a world of "
                         f"{num_processes} processes needs the coordinator "
                         "address and this process's id")
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    if not on_cpu:
        torch.cuda.set_device(local_rank(process_id))
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)


def make_mesh(n_chain_shards: Optional[int] = None, n_data_shards: int = 1):
    """``DeviceMesh`` of the world's ranks over ``("chains", "data")``, rank
    ``c * n_data_shards + d`` at ``(c, d)``.  ``n_chain_shards`` defaults to
    every rank on the chains axis.  A process that has not joined a world is
    a world of one (a gloo group on an in-memory store): mesh (1, 1)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if n_chain_shards is None:
        n_chain_shards = world // n_data_shards
    if n_chain_shards * n_data_shards != world:
        raise ValueError(f"a ({n_chain_shards}, {n_data_shards}) mesh needs "
                         f"{n_chain_shards * n_data_shards} ranks; the world "
                         f"has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type,
                      torch.arange(world).reshape(n_chain_shards,
                                                  n_data_shards),
                      mesh_dim_names=AXES)


def check_mesh(mesh) -> None:
    """Refuse what is not a ``DeviceMesh`` over ``"chains"`` and / or
    ``"data"`` (None, no mesh, passes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if mesh is not None and (not names or not set(names) <= set(AXES)):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh over "
                        f"the axes {AXES} (make_mesh), got {mesh!r}")


def mesh_shape(mesh) -> Tuple[int, int]:
    """``(chain shards, data shards)``; an axis the mesh lacks counts 1."""
    if mesh is None:
        return 1, 1
    names = tuple(mesh.mesh_dim_names or ())
    return tuple(mesh.size(names.index(ax)) if ax in names else 1
                 for ax in AXES)


def mesh_coords(mesh) -> Tuple[int, int]:
    """This rank's ``(chain shard, data shard)``."""
    if mesh is None:
        return 0, 0
    names = tuple(mesh.mesh_dim_names or ())
    return tuple(mesh.get_local_rank(ax) if ax in names else 0 for ax in AXES)


def _group(mesh, axis: str):
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)


def chain_sharding(mesh, chains: int) -> slice:
    """The chains this rank holds: an equal block along ``"chains"``."""
    nc, _nd = mesh_shape(mesh)
    if chains % nc != 0:
        raise ValueError(f"chains={chains} must be a multiple of the mesh "
                         f"'chains' axis size {nc}")
    per = chains // nc
    c = mesh_coords(mesh)[0]
    return slice(c * per, (c + 1) * per)


def row_bounds(n: int, parts: int) -> List[int]:
    """Row offsets of ``parts`` shards of ``n`` rows (the first ``n % parts``
    shards hold one row more, as ``numpy.array_split``)."""
    base, extra = divmod(n, parts)
    return [i * base + min(i, extra) for i in range(parts + 1)]


def row_sharding(mesh, n: int) -> slice:
    """The rows this rank holds along ``"data"``."""
    _nc, nd = mesh_shape(mesh)
    b = row_bounds(n, nd)
    d = mesh_coords(mesh)[1]
    return slice(b[d], b[d + 1])


@dataclasses.dataclass(frozen=True)
class RowShard:
    """Rows ``[row0, row0 + n)`` of ``n_total`` and the data group that
    holds the others: what the sampler's row reductions read."""

    group: Any
    row0: int
    n: int
    n_total: int


def row_shard(mesh, n_total: int) -> Optional[RowShard]:
    """This rank's ``RowShard`` of ``n_total`` rows, or None when the mesh
    does not split rows."""
    if mesh_shape(mesh)[1] == 1:
        return None
    s = row_sharding(mesh, n_total)
    return RowShard(_group(mesh, "data"), s.start, s.stop - s.start, n_total)


def _on_host(t: torch.Tensor, group, collective) -> torch.Tensor:
    """Run ``collective(tensor)`` (in place) on ``t``; a CUDA tensor under a
    gloo group goes through a host copy (gloo reduces host memory)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        tracing.count("host_syncs", 2)      # the copy out and the copy back
        host = t.cpu()
        collective(host)
        return host.to(t.device)
    collective(t)
    return t


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``op`` (``dist.ReduceOp``) of ``t`` over ``group``, as a new tensor."""
    collective_calls["all_reduce"] += 1
    with tracing.span("collective"):
        return _on_host(t.clone(memory_format=torch.contiguous_format),
                        group, lambda x: dist.all_reduce(x, op=op,
                                                         group=group))


def row_sum(t: torch.Tensor, rows: Optional[RowShard]) -> torch.Tensor:
    """Sum over the data group (``t`` itself without row sharding)."""
    return t if rows is None else all_reduce(t, dist.ReduceOp.SUM, rows.group)


def row_max(t: torch.Tensor, rows: Optional[RowShard]) -> torch.Tensor:
    """Maximum over the data group (``t`` itself without row sharding)."""
    return t if rows is None else all_reduce(t, dist.ReduceOp.MAX, rows.group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) joined along ``dim`` in rank order."""
    size = dist.get_world_size(group)
    if size == 1:
        return t
    collective_calls["all_gather"] += 1
    with tracing.span("collective"):
        src = t.contiguous()
        if src.is_cuda and dist.get_backend(group) == "gloo":
            tracing.count("host_syncs", 2)  # the copy out and the copy back
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(t.device)


def chains_gather(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every chain shard's block of ``t`` joined along its chain axis."""
    group = _group(mesh, "chains")
    return t if group is None else all_gather(t, group, dim)


def chains_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """Mean over ALL chains of ``t`` (local chains on axis 0), shape
    ``(1, ...)``: the chains are gathered and averaged in one process's
    order, so the mean has the bits of an unsharded run's."""
    return chains_gather(t, mesh).mean(dim=0, keepdim=True)


def broadcast_object(obj, mesh):
    """Rank 0's ``obj`` (any picklable value) on every rank."""
    if mesh is None or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_outputs(outs: Dict[str, np.ndarray], mesh,
                   row_axes: Dict[str, int],
                   whole=()) -> Dict[str, np.ndarray]:
    """Every rank's host arrays joined into the whole: each array's chains
    (axis 0) over the chain shards and, for the names in ``row_axes``, its
    rows (that axis) over the data shards.  Other arrays are the same on
    every rank of a data group and are taken from its first; the names in
    ``whole`` are the same on every rank and are taken from rank 0.  One
    pickled all-gather over the world (any backend); each rank gets the
    whole."""
    if mesh is None or dist.get_world_size() == 1:
        return outs
    collective_calls["gather_outputs"] += 1
    gathered: List[Dict[str, np.ndarray]] = [None] * dist.get_world_size()
    with tracing.span("collective"):
        dist.all_gather_object(gathered, outs)
    grid = mesh.mesh.reshape(mesh_shape(mesh)).tolist()
    out = {}
    for name in outs:
        if name in whole:
            out[name] = gathered[0][name]
            continue
        per_chain = []
        for ranks in grid:
            if name in row_axes:
                per_chain.append(np.concatenate(
                    [gathered[r][name] for r in ranks], axis=row_axes[name]))
            else:
                per_chain.append(gathered[ranks[0]][name])
        out[name] = np.concatenate(per_chain, axis=0)
    return out
