"""step_mfu_pct: the float operations a draw step needs (``counts/pgbart.py``:
the tree updates with their winners' predictions, and the rejuvenation
moves where they run; every chain) over ``draw_ms_per_step`` times the
float32 peak of the cards used."""

from benchmark.counts import pgbart as counts


def read(run):
    if run.peak is None:
        return None
    c = run.config
    moves = (c["m"] * run.kw.get("rejuvenation_sweeps", 1)
             if run.kw.get("ancestor_sampling") else 0)
    flops = counts.draw_step_flops(
        run.chains, run.kw["num_particles"], c["n"], c["p"], c["m"],
        c["max_depth"], run.kw["num_refinements"], run.kw["batch"][1], moves)
    step_s = sum(f["timings"]["draw_seconds_total"] for f in run.steady) / (
        len(run.steady) * run.kw["draws"])
    return flops / (step_s * run.chips * run.peak["fp32_flops"]) * 100.0
