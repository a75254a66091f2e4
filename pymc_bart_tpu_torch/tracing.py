"""Spans and counters of the sampler's own layers, kept in ``sample()``'s
``timings`` dict.

``sample(timings=d)`` records into ``d`` for the length of the call
(``recording``); code on its path marks its work with ``span(name)`` and
``count(name, k)``.  When the call returns (or raises), ``d`` holds

* ``d["spans"][path] = [seconds, calls]``: host seconds
  (``time.perf_counter``) and entries of each span, where ``path`` joins the
  names of the spans open at its start with ``/``
  (``draw/nuts_step/nuts_leapfrog``), so a span's self time is its seconds
  less those of the paths one level below it;
* ``d["counters"][path]``: the sum of a counter's counts under the same rule
  (``draw/nuts_step/host_syncs``).

A dict given to several calls adds them up.  With no ``timings`` (the
default) ``span`` returns one shared no-op context manager, ``count``
returns at once and a ``spanned`` function is called straight through: no
clock is read and no span is made; what is left is the wrapper's own call
(its argument tuple included).  While a
``torch.profiler`` records, a span also enters
``torch.profiler.record_function("bart/<name>")``, so the spans lie on the
profiler's clock beside the device's operations; only then, since entering
one costs microseconds.  No span or counter touches a tensor, the device or
a generator.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import inspect
import time
from typing import Any, Dict, Optional

import torch

LABEL_PREFIX = "bart/"

_perf_counter = time.perf_counter
_profiler_enabled = torch.autograd._profiler_enabled
_record_function = torch.profiler.record_function


class _Node:
    """One path: its totals, its counters and its children by name.  A path
    is open at most once at a time (a span inside itself is another path),
    so its start time and profiler range live here."""

    __slots__ = ("path", "kids", "seconds", "calls", "counts", "t0", "rf")

    def __init__(self, path: str = ""):
        self.path = path
        self.kids = {}
        self.seconds = 0.0
        self.calls = 0
        self.counts = {}
        self.t0 = 0.0
        self.rf = None


class _Tracer:
    """The paths of one ``recording`` block, the open ones on ``stack``."""

    __slots__ = ("root", "stack", "named")

    def __init__(self):
        self.root = _Node()
        self.stack = [self.root]
        self.named = {}        # name -> its _Span, made once

    def close(self):
        """Leave every span still open (a block that raised past them)."""
        while len(self.stack) > 1:
            node = self.stack.pop()
            if node.rf is not None:
                node.rf.__exit__(None, None, None)
                node.rf = None

    def write(self, timings: Dict[str, Any]):
        """Add the totals to ``timings["spans"]`` and ``["counters"]``."""
        spans = timings.setdefault("spans", {})
        counters = timings.setdefault("counters", {})
        todo = [self.root]
        while todo:
            node = todo.pop()
            prefix = node.path + "/" if node.path else ""
            for name, k in node.counts.items():
                counters[prefix + name] = counters.get(prefix + name, 0) + k
            if node.calls:
                rec = spans.setdefault(node.path, [0.0, 0])
                rec[0] += node.seconds
                rec[1] += node.calls
            todo.extend(node.kids.values())


_TRACER: contextvars.ContextVar[Optional[_Tracer]] = contextvars.ContextVar(
    "pymc_bart_tpu_torch_tracer", default=None)


class _Span:
    """The span ``name`` of one tracer.  ``seconds``: the total of its path
    in this recording, once an entry has ended.  ``start`` / ``stop`` serve
    a span that is not a block of code."""

    __slots__ = ("_stack", "_name", "_label", "_parent", "_node")

    def __init__(self, tracer: _Tracer, name: str):
        self._stack = tracer.stack
        self._name = name
        self._label = LABEL_PREFIX + name
        self._parent = self._node = None     # the last path entered

    @property
    def seconds(self):
        return self._node.seconds if self._node is not None else None

    def __enter__(self):
        stack = self._stack
        parent = stack[-1]
        if parent is self._parent:
            node = self._node
        else:
            node = parent.kids.get(self._name)
            if node is None:
                node = parent.kids[self._name] = _Node(
                    parent.path + "/" + self._name if parent.path
                    else self._name)
            self._parent, self._node = parent, node
        if _profiler_enabled():
            node.rf = _record_function(self._label)
            node.rf.__enter__()
        stack.append(node)
        node.t0 = _perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False

    def start(self):
        return self.__enter__()

    def stop(self, calls: int = 1):
        """End the entry, counted as ``calls`` entries (a replayed CUDA
        graph that does the work of several)."""
        t1 = _perf_counter()
        node = self._stack.pop()
        if node.rf is not None:
            node.rf.__exit__(None, None, None)
            node.rf = None
        node.seconds += t1 - node.t0
        node.calls += calls


class _NoSpan:
    """What ``span`` gives when nothing records: it does nothing."""

    __slots__ = ()
    seconds = None

    def start(self):
        return self

    def stop(self, calls: int = 1):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context manager timing its block as the span ``name`` (or
    ``.start()`` ... ``.stop()``)."""
    tracer = _TRACER.get()
    if tracer is None:
        return _NO_SPAN
    sp = tracer.named.get(name)
    if sp is None:
        sp = tracer.named[name] = _Span(tracer, name)
    return sp


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name`` under the open spans' path."""
    tracer = _TRACER.get()
    if tracer is None:
        return
    counts = tracer.stack[-1].counts
    counts[name] = counts.get(name, 0) + k


def spanned(name: str):
    """Decorator: every call of the function is the span ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _TRACER.get() is None:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


@contextlib.contextmanager
def recording(timings: Optional[Dict[str, Any]]):
    """Record the spans and counters of the block into ``timings`` (nothing
    where it is None); the tracer active before is active again after."""
    tracer = None if timings is None else _Tracer()
    token = _TRACER.set(tracer)
    try:
        yield
    finally:
        _TRACER.reset(token)
        if tracer is not None:
            tracer.close()
            tracer.write(timings)


def records_into(arg: str, also: Optional[str] = None):
    """Decorator: each call records into its argument ``arg`` (a dict or
    None) through ``recording``, or into a dict of its own where ``arg`` is
    None and the argument ``also`` is not (so that a profiler the call
    starts sees the spans)."""
    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            given = sig.bind(*args, **kwargs).arguments
            timings = given.get(arg)
            if timings is None and given.get(also) is not None:
                timings = {}
            with recording(timings):
                return fn(*args, **kwargs)
        return wrapper
    return deco
