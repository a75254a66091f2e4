"""Runs one cell: set-up, the window's closed loop of fits, the traced
slice, the check against the reference, and the result's line.

A cell on one card runs in this process.  A cell on several cards runs one
process a card (``spawn``), joined by ``torch.distributed`` over a free port
of this host; rank 0 judges the fits and hands the result back in a file
under ``TMPDIR``."""

import json
import os
import socket
import sys
import tempfile
import time

from . import fits as fitmod
from . import judge as judgemod
from . import registry
from .devtrace import Slice, SliceDone
from .peaks import peak_of
from .spans import Spans

# top-level module names that no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "pymc_bart_tpu")
WORLD_TIMEOUT_S = 330.0
HOST_THREADS = 1


def forbidden_modules():
    """The forbidden top-level names in ``sys.modules`` (whole names: the
    port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a metric's reader (``metrics/<name>.py``) reads.

    ``fits``: one dict a fit of the window (``wall``, ``timings``,
    ``seed``); ``steady``: the fits the wall-clock readers average (the
    window's: the profiled slice runs in a fit of its own after it);
    ``spans`` (traced runs): the host time of each span by fit;
    ``slices``: every rank's reduced slice (``devtrace``), rank 0's first;
    ``peak``: the card's published peaks, or None."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def slice(self):
        return self.slices[0] if self.slices and self.slices[0] else None

    def steps(self, fit_records):
        """Tuning and draw steps of ``fit_records``."""
        return len(fit_records) * (self.kw["tune"] + self.kw["draws"])

    def span_ms_per_step(self, span):
        """Host milliseconds inside ``span`` a step of the steady fits."""
        if self.spans is None:
            return None
        got = self.spans.per_fit([f["index"] for f in self.steady], span)
        if got is None:
            return None
        return got[0] / self.steps(self.steady) * 1e3


def run(cell_name, seed, seconds, trace, *, root, t_start, device=None,
        control=None, hook=None):
    """The cell's result: the last line's object, with the checks' lines
    (``_lines``), the forbidden modules seen (``_forbidden``) and notes for
    standard error (``_notes``) besides.  ``device="cpu"`` runs on the CPU
    (tests); ``control``: extra ``sample()`` arguments; ``hook(rank)``: called
    first in every rank's process."""
    chips = registry.Registry(root).cell(cell_name)["chips"]
    args = dict(cell_name=cell_name, seed=seed, seconds=seconds, trace=trace,
                root=str(root), t_start=t_start, device=device,
                control=control, hook=hook)
    if chips == 1:
        return run_rank(0, 1, **args)
    return run_world(chips, args)


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_entry(rank, world, args, out_dir):
    result = run_rank(rank, world, port=args.pop("port"), **args)
    if rank == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as fh:
            json.dump(result, fh)


def run_world(world, args):
    """Run ``run_rank`` in ``world`` new processes and return rank 0's
    result.  A rank that fails, or a world still running after
    ``WORLD_TIMEOUT_S``, ends every rank and raises."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    args = dict(args, port=_free_port())
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_rank_entry,
                             args=(r, world, dict(args), out_dir))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
                if p.is_alive():
                    raise TimeoutError(f"a world of {world} ranks still ran "
                                       f"after {WORLD_TIMEOUT_S} s")
                if p.exitcode != 0:
                    raise RuntimeError(f"a rank exited with {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        with open(os.path.join(out_dir, "result.json")) as fh:
            return json.load(fh)


def run_rank(rank, world, cell_name, seed, seconds, trace, root, t_start,
             device=None, control=None, hook=None, port=None):
    if hook is not None:
        hook(rank)
    import numpy as np
    import torch

    # one host thread for torch's operators in every rank: the host issues
    # the work, and a pool of idle threads only takes cores from it
    torch.set_num_threads(HOST_THREADS)
    import pymc_bart_tpu_torch as pmb
    from pymc_bart_tpu_torch.parallel import mesh as pmesh

    reg = registry.Registry(root)
    cell = reg.cell(cell_name)
    cfg, traffic = cell["config"], cell["traffic"]
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    mesh = None
    if world > 1:
        pmesh.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                     device=dev)
        shards = traffic["mesh"]
        mesh = pmesh.make_mesh(shards["chain_shards"],
                               shards.get("data_shards", 1))

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    # -- set-up: the data sets, their models, a warm-up fit of a few steps ---
    model_mod = reg.model(cfg["model"])
    check_mod = reg.reference(model_mod.CHECK)
    data = [fitmod.make_data(reg, cfg, seed, j)
            for j in range(traffic["datasets"])]
    models = [model_mod.build(pmb, cfg, X, Y) for X, Y, _f in data]
    kw = fitmod.sample_kwargs(cfg, traffic)
    if control:
        kw.update(control)
    warm = dict(kw, **cell["warmup"])
    fitmod.fit(pmb, *models[0], warm, fitmod.derive(seed, 3),
               model_mod.DRAWS, device=dev, mesh=mesh)
    spans = slice_ = None
    if trace:
        spans = Spans().install()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    calls0 = sum(pmesh.collective_calls.values())

    # -- the window: whole fits back to back --------------------------------
    window_start = time.time()
    w0 = time.perf_counter()
    records, outputs = [], []
    i = 0
    while True:
        rs = fitmod.derive(seed, 1, i)
        if spans is not None:
            spans.fit = i
        wall, timings, out, warns = fitmod.fit(
            pmb, *models[i % len(models)], kw, rs, model_mod.DRAWS,
            device=dev, mesh=mesh)
        records.append(dict(index=i, wall=wall, timings=timings, seed=rs,
                            warnings=len(warns)))
        if rank == 0:
            out["data"] = i % len(models)
            outputs.append(out)
        del out
        i += 1
        stop = time.perf_counter() - w0 >= seconds
        if mesh is not None:
            stop = pmesh.broadcast_object(stop, mesh)
        if stop:
            break
    window_s = time.perf_counter() - w0
    collectives = sum(pmesh.collective_calls.values()) - calls0
    peak_bytes = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if spans is not None:
        # the profiled slice: the draw steps of one more fit, after the window
        slice_ = Slice(cell["trace_steps"], sync)
        spans.fit = None
        spans.before = slice_.before
        try:
            fitmod.fit(pmb, *models[0], kw, fitmod.derive(seed, 4),
                       model_mod.DRAWS, device=dev, mesh=mesh)
        except SliceDone:
            pass
        slice_.stop()
        spans.uninstall()
    mine = dict(peak_bytes=peak_bytes, forbidden=forbidden_modules(),
                slice=slice_.summary() if slice_ is not None else None)
    ranks = [mine]
    if world > 1:
        ranks = [None] * world
        torch.distributed.all_gather_object(ranks, mine)
        torch.distributed.destroy_process_group()
    if rank != 0:
        return None

    # -- after the window: the program's state freed, the reference --------
    del models
    if on_card:
        torch.cuda.empty_cache()
    j0 = time.perf_counter()
    numbers, failed = judgemod.judge(outputs, data, cell, kw, seed,
                                     check_mod)
    judge_s = time.perf_counter() - j0
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    run_ = Run(cell=cell, config=cfg, traffic=traffic, kw=kw, chips=world,
               chains=kw["chains"], chains_local=kw["chains"] // world,
               seconds=seconds, setup_s=window_start - t_start,
               window_s=window_s, fits=records, steady=records, spans=spans,
               slices=[r["slice"] for r in ranks],
               peak_bytes=max(r["peak_bytes"] for r in ranks),
               collectives=collectives, on_card=on_card, kind=kind,
               peak=peak_of(kind))
    metrics = {}
    for name, unit in reg.metrics_of(cell_name, trace):
        value = reg.metric_reader(name)(run_)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": unit}
    device_ = {"platform": "gpu" if on_card else "cpu", "kind": kind,
               "count": world, "memory_peak_bytes": int(run_.peak_bytes)}
    result = {"correct": failed == 0 and all(
                  v["value"] is not None and v["value"] <= v["limit"]
                  for v in numbers.values()),
              "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": device_}
    sl = [s for s in run_.slices if s]
    if trace:
        if sl:
            device_["busy_s"] = float(np.mean([s["busy_s"] for s in sl]))
            device_["window_s"] = float(np.mean([s["window_s"] for s in sl]))
            result["breakdown"] = {"device_ops": sl[0]["device_ops"],
                                   "idle_gaps": sl[0]["idle_gaps"]}
    result["checks"] = numbers
    result["_lines"] = judgemod.lines(numbers)
    # every rank's at the window's close, and what this process loaded
    # since: the check, the metrics' readers
    result["_forbidden"] = sorted({m for r in ranks for m in r["forbidden"]}
                                  | set(forbidden_modules()))
    result["_notes"] = {"fit_walls": [r["wall"] for r in records],
                        "warnings": sum(r["warnings"] for r in records),
                        "judge_s": judge_s,
                        "idle_by_span": sl[0]["idle_by_span"] if sl else None,
                        "device_events_matched": (
                            sl[0]["device_events_matched"] if sl else None)}
    return result
