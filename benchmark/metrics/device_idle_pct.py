"""device_idle_pct: 1 - (the union of the intervals of every device kernel
and copy on every stream) / the wall time of the profiled slice, the mean
over the ranks."""


def read(run):
    sl = [s for s in run.slices if s and s["window_s"] > 0]
    if not sl or not run.on_card:
        return None
    return sum(1.0 - s["busy_s"] / s["window_s"] for s in sl) / len(sl) * 100
