"""Spans around the port's layers, from the benchmark's own files.

In a traced run the harness replaces, where their callers look them up,
the callables below by wrappers that enter ``torch.profiler.record_function``
(so a profiler sees the span and the kernels issued inside it) and add the
host time of the call to the current fit's totals, kept in memory.  A
callable that a later version of the port no longer has is skipped: the
metrics that read its span then read nothing."""

import importlib
import inspect
import time

PREFIX = "bench/"

# (module, attribute, span name): where the callers look them up
TARGETS = (
    ("pymc_bart_tpu_torch.sampler.nuts", "nuts_step", "nuts_step"),
    ("pymc_bart_tpu_torch.sampler.pgbart", "pgbart_step", "pgbart_step"),
    # pgbart.py imports it by name
    ("pymc_bart_tpu_torch.sampler.pgbart", "rejuvenate_forest",
     "rejuvenate_forest"),
    ("pymc_bart_tpu_torch.sampler.pgbart", "draw_rands", "draw_rands"),
    # the per-draw collection of the updated trees
    ("pymc_bart_tpu_torch.sampler.compound", "_pack_forest_slice",
     "pack_forest"),
)


class Spans:
    """Host time a span name takes, by fit, and a hook before each call.

    ``before(name, arguments)`` is called ahead of the span (outside it),
    ``arguments()`` giving the call's arguments by name (or None); the
    harness uses it to start and stop its profiled slice."""

    def __init__(self):
        self.fit = None
        self.totals = {}              # fit -> {name: [seconds, calls]}
        self.before = None
        self._saved = []

    def install(self):
        import torch

        for mod_name, attr, span in TARGETS:
            try:
                mod = importlib.import_module(mod_name)
            except ImportError:
                continue
            orig = getattr(mod, attr, None)
            if orig is None:
                continue
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(orig, span, torch))
        return self

    def uninstall(self):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []

    def _wrap(self, orig, span, torch):
        try:
            sig = inspect.signature(orig)
        except (TypeError, ValueError):
            sig = None
        label = PREFIX + span

        def wrapper(*args, **kwargs):
            if self.before is not None:
                def arguments():
                    try:
                        return sig.bind(*args, **kwargs).arguments
                    except (AttributeError, TypeError):
                        return None
                self.before(span, arguments)
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(label):
                    return orig(*args, **kwargs)
            finally:
                if self.fit is not None:
                    tot = self.totals.setdefault(self.fit, {}).setdefault(
                        span, [0.0, 0])
                    tot[0] += time.perf_counter() - t0
                    tot[1] += 1

        wrapper.__wrapped__ = orig
        return wrapper

    def per_fit(self, fits, span):
        """``(seconds, calls)`` of ``span`` summed over ``fits``, or None
        where no call of it was seen."""
        sec = calls = 0
        for f in fits:
            s, c = self.totals.get(f, {}).get(span, (0.0, 0))
            sec += s
            calls += c
        return (sec, calls) if calls else None
