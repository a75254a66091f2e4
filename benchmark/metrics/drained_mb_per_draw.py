"""drained_mb_per_draw: ``timings["drained_bytes"]`` (this rank's copy to
the host) over the draws, in 10^6 bytes."""


def read(run):
    total = sum(f["timings"]["drained_bytes"] for f in run.steady)
    return total / (len(run.steady) * run.kw["draws"]) / 1e6
