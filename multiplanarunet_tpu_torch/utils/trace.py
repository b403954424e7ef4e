"""Spans and counters of the port's work, in one recorder that the
predictor, the Trainer and the sampler share.

A span names a stretch of work on one thread::

    with trace.span("predict.plan"):
        ...
    with trace.span("train.step", device=dev, request=(epoch, step)):
        ...

It records its name, its host start and end (`time.perf_counter_ns`),
the span that encloses it on the same thread (its parent) and a request
id (given, or the parent's). Opened with a CUDA `device`, it also
records a timing event on that device's current stream when it opens
and when it closes; the device milliseconds between them are resolved
only when the records are taken. Counters (`count`) are named integers,
added to the innermost open span of the thread and to the recorder's
totals.

Spans are recorded while the recorder is on (`enable`) and while a
`torch.profiler` runs in the process (torch's process-wide flag: a
profiled stretch gives the records too, the prefetch worker's
included). Records stay in memory, thread-safe, until `take` returns
and clears them. Under a profiler each span also opens a profiler range
"mp." + name (a record function of the function scope, so it stays on
the host's timeline), so the spans sit in the profiler's trace beside
the card's operations and name its idle gaps (a thread the profiler
does not follow, such as the prefetch worker under a profiler of one
thread, shows none).

Off (no recorder, no profiler), `span` returns one shared no-op
context: it reads no clock, makes no CUDA event and takes no lock. A
span given a `keep` list is live all the same and appends itself to
that list (the predictor keeps its last image's stages so, for
`MultiViewPredictor.stage_ms`). The recorder never resets the
allocator's peak statistics.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler


def _profiled():
    """Whether a torch.profiler runs in this process (any thread)."""
    return _autograd_profiler._is_profiler_enabled


# A profiler range of the function scope. `torch.profiler.record_function`
# opens one of the user scope, which the profiler also copies onto the
# card's timeline around the kernels it encloses; those copies would count
# as device operations wherever a trace is read for the card's busy time.
_RecordFunction = torch._C._profiler._RecordFunctionFast


class _NoSpan:
    """The shared span of the recorder when it is off: does nothing."""

    __slots__ = ()
    recorded = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, name, n=1):
        pass


NO_SPAN = _NoSpan()


def _cuda_mallocs(device):
    """cudaMalloc calls of the caching allocator on `device` so far."""
    return torch.cuda.memory_stats(device).get("segment.all.allocated", 0)


class Span:
    """One stretch of work on one thread (see the module's docstring)."""

    __slots__ = ("recorder", "name", "request", "parent", "thread", "id",
                 "recorded", "start_ns", "end_ns", "counters", "_device",
                 "_profile", "_keep", "_mallocs", "_segments", "_rf",
                 "_stream", "_start", "_end", "_device_ms")

    def __init__(self, recorder, name, device, request, recorded, profile,
                 keep, mallocs):
        self.recorder = recorder
        self.name = name
        self.request = request
        self.recorded = recorded
        self.counters = {}
        self.parent = self.start_ns = self.end_ns = None
        dev = None if device is None else torch.device(device)
        self._device = dev if dev is not None and dev.type == "cuda" else None
        mdev = None if mallocs is None else torch.device(mallocs)
        self._mallocs = (mdev if recorded and mdev is not None
                         and mdev.type == "cuda" else None)
        self._profile = profile
        self._keep = keep
        self._segments = self._rf = self._stream = None
        self._start = self._end = self._device_ms = None

    def __enter__(self):
        stack = self.recorder._stack()
        self.parent = stack[-1] if stack else None
        if self.request is None and self.parent is not None:
            self.request = self.parent.request
        self.thread = threading.current_thread().name
        self.id = next(self.recorder._ids)
        if self._profile:
            self._rf = _RecordFunction("mp." + self.name)
            self._rf.__enter__()
        if self._mallocs is not None:
            self._segments = _cuda_mallocs(self._mallocs)
        if self._device is not None:
            self._stream = torch.cuda.current_stream(self._device)
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(self._stream)
        if self._keep is not None:
            self._keep.append(self)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._stream is not None:
            self._end = torch.cuda.Event(enable_timing=True)
            self._end.record(self._stream)
        if self._segments is not None:
            self.count("alloc.cuda_mallocs",
                       _cuda_mallocs(self._mallocs) - self._segments)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.recorder._stack().pop()
        if self.recorded:
            self.recorder._finish(self)
        return False

    def count(self, name, n=1):
        """Add n to this span's counter `name` (and, when the span is
        recorded, to the recorder's total)."""
        self.counters[name] = self.counters.get(name, 0) + int(n)
        if self.recorded:
            self.recorder._add(name, n)

    @property
    def timed(self):
        """Whether the span holds device timing events."""
        return self._start is not None

    @property
    def host_ms(self):
        return (self.end_ns - self.start_ns) / 1e6

    def device_ms(self):
        """Device milliseconds between the span's two events (waits for
        the second), or None for a span without them."""
        if self._end is None:
            return None
        if self._device_ms is None:
            self._end.synchronize()
            self._device_ms = self._start.elapsed_time(self._end)
        return self._device_ms

    def ms_until(self, other):
        """Device milliseconds from this span's end to the start of a later
        span on the same stream."""
        other._end.synchronize()
        return self._end.elapsed_time(other._start)

    def record(self):
        """The span as a plain dict (the form `take` returns)."""
        return {"id": self.id, "name": self.name,
                "parent": None if self.parent is None else self.parent.id,
                "thread": self.thread, "request": self.request,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "host_ms": self.host_ms, "device_ms": self.device_ms(),
                "counters": dict(self.counters)}


class Recorder:
    """The spans and counters of one process (the module's functions act
    on one shared instance)."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._spans = []
        self._counters = {}

    def _stack(self):
        local = self._local
        try:
            return local.stack
        except AttributeError:
            local.stack = []
            return local.stack

    def _finish(self, span):
        with self._lock:
            self._spans.append(span)

    def _add(self, name, n):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def span(self, name, device=None, request=None, keep=None,
             mallocs=None):
        """A context for one span (see the module's docstring). `mallocs`:
        a CUDA device whose cudaMalloc calls across the span are counted
        as `alloc.cuda_mallocs` (read only when the span is recorded)."""
        profiled = _profiled()
        recorded = self.enabled or profiled
        if not recorded and keep is None:
            return NO_SPAN
        return Span(self, name, device, request, recorded, profiled, keep,
                    mallocs)

    def count(self, name, n=1):
        """Add n to counter `name`: in the innermost open span of this
        thread, and in the recorder's totals. Nothing when not
        recording."""
        if not (self.enabled or _profiled()):
            return
        stack = self._stack()
        if stack:
            top = stack[-1]
            top.counters[name] = top.counters.get(name, 0) + int(n)
        self._add(name, n)

    def take(self):
        """{"spans": [records], "counters": {name: total}} of what was
        recorded since the last take, which is cleared. A span's record:
        id, name, parent (id or None), thread, request, start_ns, end_ns,
        host_ms, device_ms (None without a device) and counters."""
        with self._lock:
            spans, self._spans = self._spans, []
            counters, self._counters = self._counters, {}
        return {"spans": [s.record() for s in spans], "counters": counters}


RECORDER = Recorder()


def enable():
    """Record every span and counter from now on (until `disable`)."""
    RECORDER.enabled = True


def disable():
    RECORDER.enabled = False


def enabled():
    return RECORDER.enabled


span = RECORDER.span
count = RECORDER.count
take = RECORDER.take


def summary(records):
    """{span name: (count, host ms, device ms or None)} of `take()`'s
    records, the milliseconds summed, in order of first appearance."""
    out = {}
    for r in records["spans"]:
        n, host, dev = out.get(r["name"], (0, 0.0, None))
        if r["device_ms"] is not None:
            dev = (dev or 0.0) + r["device_ms"]
        out[r["name"]] = (n + 1, host + r["host_ms"], dev)
    return out
