"""draw_ms_per_step: ``timings["draw_seconds_total"]`` over the draws, over
the window's fits outside the profiled slice (compound step layer)."""


def read(run):
    total = sum(f["timings"]["draw_seconds_total"] for f in run.steady)
    return total / (len(run.steady) * run.kw["draws"]) * 1e3
