"""The port's tracing: spans and counters inside the program, and the
profiler window behind the recipe's ``--profile-dir``.

The tracer is off unless a ``torch.profiler`` is recording, or
``tracing()`` holds it on (tests, and measuring what tracing costs).  Off,
``span`` returns one shared no-op object and ``count`` returns at once: no
CUDA event, no allocation, no profiler call.  On, a span

- opens the host range ``pkr.<name>`` with ``_RecordFunctionFast``: a CPU
  op on the profiler's own clock.  ``torch.profiler.record_function``
  would come back as a user annotation, which on the card also emits a
  device-side annotation event; the fast form adds no device activity to
  the trace, so the trace's busy time and its list of device operations
  stay as they are without the spans;
- notes the host clock at entry and exit;
- records a CUDA event at each end on the current stream once CUDA is
  initialized (the host clock stands in before), read in ``summary()``
  only, which waits for them: never inside a step.

Each name keeps its last ``RING`` records, so a long profiler window does
not grow memory without limit; occurrences and counters count on.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from collections import deque
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

RING = 4096  # records kept per span name


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("tracer", "name", "range", "t0", "ev0")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.range = torch._C._profiler._RecordFunctionFast("pkr." + self.name)
        self.range.__enter__()
        self.ev0 = self.tracer._event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        ev1 = self.tracer._event()
        self.range.__exit__(*exc)
        self.tracer._keep(self.name, self.t0, t1, self.ev0, ev1)
        return False


class Tracer:
    """Spans and counters of one process (the module's functions are those
    of one shared instance)."""

    def __init__(self):
        self.forced = 0  # depth of tracing() blocks
        self.records: Dict[str, deque] = {}  # name -> (t0 ns, t1 ns, event, event)
        self.occurrences: Dict[str, int] = {}
        self.counters: Dict[str, int] = {}
        self.free_events: list = []

    def enabled(self) -> bool:
        return bool(self.forced or _autograd_profiler._is_profiler_enabled)

    def span(self, name: str):
        """A context manager timing the enclosed work as ``name``."""
        if not (self.forced or _autograd_profiler._is_profiler_enabled):
            return NOOP
        return _Span(self, name)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the counter ``name``."""
        if not (self.forced or _autograd_profiler._is_profiler_enabled):
            return
        self.counters[name] = self.counters.get(name, 0) + n

    def _event(self):
        if not torch.cuda.is_initialized():
            return None
        ev = self.free_events.pop() if self.free_events else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _recycle(self, *events) -> None:
        self.free_events.extend(ev for ev in events if ev is not None)

    def _keep(self, name: str, t0: int, t1: int, ev0, ev1) -> None:
        recs = self.records.get(name)
        if recs is None:
            recs = self.records[name] = deque()
        if len(recs) >= RING:
            self._recycle(*recs.popleft()[2:])
        recs.append((t0, t1, ev0, ev1))
        self.occurrences[name] = self.occurrences.get(name, 0) + 1

    def summary(self) -> dict:
        """``{"spans": {name: {"n", "host_ms", "device_ms"}}, "counters":
        {name: total}}``: each span name's occurrences and the host and
        device ms of its last ``RING`` occurrences, oldest first.  Device ms
        run from the CUDA event at the span's entry to the one at its exit
        (idle time on the card between them included); where no event was
        recorded, the host ms stand in.  Waits for the events."""
        spans = {}
        for name, recs in self.records.items():
            host, device = [], []
            for t0, t1, ev0, ev1 in recs:
                host.append((t1 - t0) * 1e-6)
                if ev0 is None or ev1 is None:
                    device.append(host[-1])
                else:
                    ev1.synchronize()
                    device.append(ev0.elapsed_time(ev1))
            spans[name] = {"n": self.occurrences[name], "host_ms": host, "device_ms": device}
        return {"spans": spans, "counters": dict(self.counters)}

    def reset(self) -> None:
        """Forget every span and counter (``tracing()`` blocks stay)."""
        for recs in self.records.values():
            for rec in recs:
                self._recycle(*rec[2:])
        self.records.clear()
        self.occurrences.clear()
        self.counters.clear()

    @contextlib.contextmanager
    def tracing(self):
        """Hold the tracer on, with or without a profiler."""
        self.forced += 1
        try:
            yield self
        finally:
            self.forced -= 1


_TRACER = Tracer()
enabled = _TRACER.enabled
span = _TRACER.span
count = _TRACER.count
summary = _TRACER.summary
reset = _TRACER.reset
tracing = _TRACER.tracing


def spanned(name: str):
    """Decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the enclosed work, written to
    ``log_dir/trace_<pid>_<time>.json`` on exit, with the window's spans and
    counters (``summary()``) beside it in ``spans_<pid>_<time>.json``;
    nothing if no dir is given."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    stamp = f"{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stamp}.json"))
    with open(os.path.join(log_dir, f"spans_{stamp}.json"), "w") as f:
        json.dump(summary(), f)
