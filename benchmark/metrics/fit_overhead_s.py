"""fit_overhead_s: a fit's wall time less its tuning and draw phases
(``timings``): model compilation into the sampler, trace assembly and the
convergence checks; the mean over the fits outside the profiled slice."""


def read(run):
    rest = [f["wall"] - f["timings"]["tune_seconds"]
            - f["timings"]["draw_seconds_total"] for f in run.steady]
    return sum(rest) / len(rest)
