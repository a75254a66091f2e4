"""A bounded profiled slice of a fit's draw phase, reduced in memory.

``Slice`` runs ``torch.profiler`` (host and CUDA activity) over ``steps``
draw steps of one fit: it starts ahead of the first draw step's PGBART step
and stops ahead of step ``steps + 1``'s, with the device synchronised at
both ends, so every device operation issued inside the slice ran inside
it; there it ends the fit by raising ``SliceDone`` (a fit with fewer draw
steps ends the slice when it returns).  A process that has run the
profiler issues its kernels more slowly afterwards, so the harness profiles
one extra fit after the window closes.  Nothing is written to disk.
``summary`` gives:

* ``busy_s``: the union of the intervals of every device kernel and copy on
  every stream (so a copy that overlaps a kernel counts once);
* ``window_s``: the host's wall time of the slice;
* ``span_host_s`` / ``span_device_s``: by span name, the host time inside
  the harness's spans and the device time of the operations launched
  inside them (a device operation is matched to its launch on the host by
  its CUDA correlation id, and belongs to every span open at the launch);
* ``device_ops``: device time by operation name, the longest first;
* ``idle_gaps``: the gaps between device intervals, the longest first,
  each labelled with the innermost span open on the host at its start."""

import time

from .spans import PREFIX


class SliceDone(Exception):
    """Raised ahead of the first draw step past the slice."""


class Slice:
    def __init__(self, steps, sync):
        self.steps = steps
        self.sync = sync
        self.prof = None
        self.seen = 0          # draw steps started inside the slice
        self.done = False
        self.t0 = self.t1 = None

    def before(self, span, arguments):
        """The ``Spans.before`` hook: counts the draw steps' PGBART steps."""
        if self.done or span != "pgbart_step":
            return
        args = arguments()
        if args is None or args.get("tuning", True):
            return
        if self.prof is None:
            self.start()
        elif self.seen >= self.steps:
            self.stop()
            raise SliceDone()
        self.seen += 1

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        if self.prof is None or self.done:
            return
        self.sync()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.done = True

    def summary(self, top=10):
        """The reduced slice (see the module docstring), or None."""
        if not self.done:
            return None
        from torch.autograd import DeviceType

        events = list(self.prof.events())
        dev, spans = [], []
        for e in events:
            is_span = e.name.startswith(PREFIX)
            if e.device_type == DeviceType.CUDA:
                if not is_span and not getattr(e, "is_user_annotation",
                                               False):
                    dev.append(e)
            elif is_span:
                spans.append(e)
        host = [e for e in events if e.device_type == DeviceType.CPU]
        lo = min((e.time_range.start for e in host), default=0.0)
        hi = max((e.time_range.end for e in host), default=0.0)
        union = []
        for s, t in sorted((e.time_range.start, e.time_range.end)
                           for e in dev):
            if union and s <= union[-1][1]:
                union[-1][1] = max(union[-1][1], t)
            else:
                union.append([s, t])
        busy_us = sum(t - s for s, t in union)
        ops = {}
        for e in dev:
            ops[e.name] = ops.get(e.name, 0.0) + (e.time_range.end
                                                  - e.time_range.start)
        span_host = {}
        for e in spans:
            nm = e.name[len(PREFIX):]
            span_host[nm] = span_host.get(nm, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
        span_dev, matched = _span_device_us(dev, host, spans)
        edges = [lo] + [x for iv in union for x in iv] + [max(hi, lo)]
        gaps = _labelled_gaps(list(zip(edges[0::2], edges[1::2])), spans)
        gaps.sort(key=lambda g: -g[1])
        return {
            "steps": self.seen,
            "window_s": self.t1 - self.t0,
            "busy_s": busy_us / 1e6,
            "device_events": len(dev),
            "device_events_matched": matched,
            "span_host_s": {k: v / 1e6 for k, v in span_host.items()},
            "span_device_s": {k: v / 1e6 for k, v in span_dev.items()},
            "device_ops": sorted(([k, v / 1e6] for k, v in ops.items()),
                                 key=lambda r: -r[1])[:top],
            "idle_gaps": [list(g) for g in gaps[:top]],
            "idle_by_span": _by_label(gaps),
        }


def _span_device_us(dev, host, spans):
    """Device microseconds by span name of the operations launched inside
    each span, and the share of device operations matched to a launch
    (a kernel launched through ``ctypes`` has no PyTorch operator around
    it, so the profiler's own attribution, ``device_time_total``, misses
    it).  Where fewer than half are matched, no span has a device time."""
    import bisect

    launch = {e.id: e.time_range.start for e in host
              if e.name.startswith("cu") and e.id}
    by_name = {}
    for e in spans:
        by_name.setdefault(e.name[len(PREFIX):], []).append(
            (e.time_range.start, e.time_range.end))
    for v in by_name.values():
        v.sort()
    starts = {k: [s for s, _ in v] for k, v in by_name.items()}
    out = {k: 0.0 for k in by_name}
    hit = 0
    for d in dev:
        t = launch.get(d.id)
        if t is None:
            continue
        hit += 1
        for k, ivs in by_name.items():
            i = bisect.bisect_right(starts[k], t) - 1
            if i >= 0 and ivs[i][1] >= t:
                out[k] += d.time_range.end - d.time_range.start
    share = hit / len(dev) if dev else 0.0
    return (out if share >= 0.5 else {}), share


def _labelled_gaps(bounds, spans):
    """``(label, seconds)`` of each gap ``(start, end)`` (microseconds) with
    the innermost span open at its start: one sweep over the nested spans
    and the gaps, both in order of their starts."""
    order = sorted(((e.time_range.start, e.time_range.end,
                     e.name[len(PREFIX):]) for e in spans))
    out, stack, i = [], [], 0
    for s, t in sorted(b for b in bounds if b[1] > b[0]):
        while i < len(order) and order[i][0] <= s:
            while stack and stack[-1][1] <= order[i][0]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] <= s:
            stack.pop()
        out.append((stack[-1][2] if stack else "outside_spans",
                    (t - s) / 1e6))
    return out


def _by_label(gaps):
    out = {}
    for label, sec in gaps:
        out[label] = out.get(label, 0.0) + sec
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
