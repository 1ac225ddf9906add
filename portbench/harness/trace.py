"""The device trace of a traced run and what the readers take from it.

`traced(enabled, device)` wraps the window in torch.profiler recording the
card's activity alone: recording every host operation as well would slow
the host's issue of a step's thousands of launches, and the idle share
would then measure the profiler. The benchmark's own spans around its
calls into the system ("issue", "fetch", "step", "check") and the window
itself are taken on the host's clock (`time.time_ns`, the epoch the
profiler's timestamps are in). `Trace` reads the profiler's raw events
once:

- the card's intervals (kernels, copies, sets) inside the window, merged,
  so that busy time is their union and not a sum;
- device time and launches by kernel name;
- the longest idle gaps between busy intervals, each named by the
  benchmark span the host was in when the gap opened ("other" outside).
"""

import contextlib
import contextvars
import re
import time

import torch

_SPANS = contextvars.ContextVar("portbench_spans", default=None)


@contextlib.contextmanager
def span(name):
    """Record the block as span `name` while a traced window is open."""
    spans = _SPANS.get()
    if spans is None:
        yield
        return
    start = time.time_ns()
    try:
        yield
    finally:
        spans.append((start, time.time_ns(), name))


class Window:
    """A traced window: the profiler, the spans and the window's bounds."""

    def __init__(self, prof):
        self.prof, self.spans, self.start, self.end = prof, [], None, None


@contextlib.contextmanager
def traced(enabled, device):
    """torch.profiler (the card's activity) over the block when `enabled`:
    yields a Window, else None."""
    if not enabled:
        yield None
        return
    activity = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[activity.CUDA if device.type == "cuda" else activity.CPU]) as prof:
        window = Window(prof)
        token = _SPANS.set(window.spans)
        try:
            window.start = time.time_ns()
            yield window
            window.end = time.time_ns()
        finally:
            _SPANS.reset(token)


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


class Trace:
    def __init__(self, window):
        self.start, self.end = window.start, window.end
        self.window_s = (self.end - self.start) / 1e9
        device = [(e.name(), e.start_ns(), e.end_ns()) for e in window.prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()]
        self.kernels = [(n, max(s, self.start), min(t, self.end)) for n, s, t in device
                        if t > self.start and s < self.end]
        busy = _merge([[s, t] for _, s, t in self.kernels])
        self.busy_s = sum(t - s for s, t in busy) / 1e9
        self.spans = sorted(window.spans)
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = sorted(((b - a, a) for a, b in zip(edges[0::2], edges[1::2]) if b > a), reverse=True)
        self.gaps = [(self._host_at(a), d / 1e9) for d, a in gaps[:10]]

    def _host_at(self, t):
        """The innermost benchmark span open on the host at time t."""
        inner = None
        for s, e, name in self.spans:
            if s > t:
                break
            if e >= t and (inner is None or s >= inner[0]):
                inner = (s, name)
        return inner[1] if inner else "other"

    def device_seconds(self, pattern=None):
        """(device seconds, launches) of the kernels whose names match the
        regular expression `pattern` (every device operation for None)."""
        rx = re.compile(pattern) if pattern else None
        hits = [(t - s) for n, s, t in self.kernels if rx is None or rx.search(n)]
        return sum(hits) / 1e9, len(hits)

    def top_ops(self, count=10):
        by_name = {}
        for n, s, t in self.kernels:
            by_name[n] = by_name.get(n, 0) + (t - s) / 1e9
        return [[n[:160], v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:count]]

    def breakdown(self):
        return {"device_ops": self.top_ops(), "idle_gaps": [[n, s] for n, s in self.gaps]}
