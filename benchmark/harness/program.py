"""The program's own spans and counters, as ``sample(timings=...)`` leaves
them in ``timings["spans"]`` (``path -> [seconds, calls]``) and
``timings["counters"]`` (``path -> total``), a path being the names of the
spans open around it joined by ``/``.  A name is summed over every path
that ends in it (``tune/nuts_step/nuts_leapfrog`` and
``draw/nuts_step/nuts_leapfrog``) and over the fits given.  Where a fit's
``timings`` hold no such key (a version of the program that does not
record it) the sums are None."""


def _values(fits, key, name):
    """The values of every path of ``timings[key]`` ending in ``name``,
    over ``fits``; None where a fit's timings lack ``key``."""
    out = []
    for f in fits:
        got = f["timings"].get(key)
        if got is None:
            return None
        out += [v for path, v in got.items()
                if path.rsplit("/", 1)[-1] == name]
    return out


def span(fits, name):
    """``(seconds, calls)`` of the span ``name`` over ``fits``, or None."""
    vals = _values(fits, "spans", name)
    if not vals:
        return None
    return sum(v[0] for v in vals), sum(v[1] for v in vals)


def counter(fits, name):
    """The counter ``name`` summed over ``fits``, or None."""
    vals = _values(fits, "counters", name)
    return sum(vals) if vals else None
