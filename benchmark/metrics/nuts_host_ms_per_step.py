"""nuts_host_ms_per_step: host milliseconds inside the ``nuts_step`` span
(``sampler/nuts.py``) a tuning or draw step."""


def read(run):
    return run.span_ms_per_step("nuts_step")
