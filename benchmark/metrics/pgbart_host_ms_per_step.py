"""pgbart_host_ms_per_step: host milliseconds inside the ``pgbart_step``
span (``sampler/pgbart.py``, rejuvenation included) a step."""


def read(run):
    return run.span_ms_per_step("pgbart_step")
