"""bign_rowll_roofline_pct: the floor time of a draw step's tree updates in
the row-log-likelihood mode (``counts/pgbart_rowll.py``: the larger of the
bytes over the card's bandwidth and the float operations over its float32
rate, for this rank's chains) over the device time of the operations issued
inside the ``pgbart_step`` span and outside the ``rejuvenate_forest`` span,
a step of the profiled slice (as ``pgbart_kernel_roofline_pct`` reads it)."""

from benchmark.counts import pgbart as counts
from benchmark.counts import pgbart_rowll


def read(run):
    sl = run.slice
    if sl is None or run.peak is None or not sl["steps"]:
        return None
    dev = sl["span_device_s"].get("pgbart_step", 0.0) - sl[
        "span_device_s"].get("rejuvenate_forest", 0.0)
    if dev <= 0:
        return None
    c = run.config
    flops, nbytes = pgbart_rowll.rowll_tree_updates(
        run.chains_local, run.kw["num_particles"], c["n"], c["p"], c["m"],
        c["max_depth"], run.kw["batch"][1])
    floor = counts.floor_seconds(flops, nbytes, run.peak)
    return floor / (dev / sl["steps"]) * 100.0
