"""Device timing for the benchmark: CUDA-event spans, the profiler's trace
of a steady stretch, and what the trace says (busy time, idle gaps, the
longest operations).

The stretch is traced the way ``chip_smoke.py``'s ``device_ms`` traces a
call: between two marker kernels (spin kernels, counted nowhere), so that
neither end of the trace is a step's.  A trace now and then comes back
without some of the device activities that the same launches show in
another, so a stretch is traced again until two traces agree on the count,
and the run fails after three that do not.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

MARKER = "spin_kernel"


class Spans:
    """Named spans on the device's clock: a CUDA event recorded at each end,
    read once after the caller has synchronized.  On the CPU (the tests)
    the host clock stands in."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.open: Dict[str, object] = {}
        self.pairs: Dict[str, List[Tuple[object, object]]] = {}

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self, name: str) -> None:
        self.open[name] = self._mark()

    def stop(self, name: str) -> None:
        self.pairs.setdefault(name, []).append((self.open.pop(name), self._mark()))

    def ms(self, name: str) -> List[float]:
        """Each span's length in ms (call after a synchronize)."""
        out = []
        for a, b in self.pairs.get(name, []):
            out.append(a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
        return out


class Ticks:
    """A mark on the device's clock after each unit of work: the intervals
    between consecutive marks, with no host sync in between."""

    def __init__(self, device: torch.device):
        self.spans = Spans(device)
        self.marks: list = []

    def tick(self) -> None:
        self.marks.append(self.spans._mark())

    def intervals_ms(self) -> List[float]:
        m = self.marks
        if self.spans.cuda:
            return [a.elapsed_time(b) for a, b in zip(m[:-1], m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m[:-1], m[1:])]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _profile_once(run: Callable[[], None]) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        run()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    acts, cpu, marks = [], [], []
    for e in prof.events():
        t = (e.time_range.start, e.time_range.end)  # us
        if e.device_type == DeviceType.CUDA:
            (marks if MARKER in e.name else acts).append((e.name, t[0], t[1]))
        elif e.device_type == DeviceType.CPU:
            cpu.append((e.name, t[0], t[1]))
    if len(marks) >= 2:
        marks.sort(key=lambda a: a[1])
        lo, hi = marks[0][2], marks[-1][1]
    elif acts:
        lo, hi = min(a[1] for a in acts), max(a[2] for a in acts)
    else:
        lo = hi = 0.0
    return {"acts": acts, "cpu": cpu, "window_us": (lo, hi)}


def steady_trace(run: Callable[[], None], tries: int = 3) -> dict:
    """The profiler's trace of ``run`` (a stretch of steps), taken again
    until two traces show the same number of device activities; raises
    after ``tries`` traces without two that agree."""
    counts = []
    for _ in range(tries):
        tr = _profile_once(run)
        n = len(tr["acts"])
        if n and n in counts:
            return tr
        counts.append(n)
    raise RuntimeError(f"{tries} traces of the same stretch showed {counts} device "
                       "activities: no two agree, so some trace dropped activities")


def summarize(tr: dict, top: int = 10) -> dict:
    """Busy seconds (the union of the device activities), the window's
    seconds, device seconds by kernel name, and the longest idle gaps
    labelled by the innermost host operation running at the gap's start."""
    lo, hi = tr["window_us"]
    acts = [(n, max(a, lo), min(b, hi)) for n, a, b in tr["acts"] if b > lo and a < hi]
    busy = _union([(a, b) for _, a, b in acts])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for n, a, b in acts:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
    gaps = []
    edges = [(lo, lo)] + busy + [(hi, hi)]
    for (_, b0), (a1, _) in zip(edges[:-1], edges[1:]):
        if a1 > b0:
            gaps.append((b0, a1))
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    labelled = []
    for g0, g1 in gaps[:top]:
        inner = [c for c in tr["cpu"] if c[1] <= g0 < c[2]]
        label = min(inner, key=lambda c: c[2] - c[1])[0] if inner else "no host op"
        labelled.append([label[:80], (g1 - g0) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_us * 1e-6, "window_s": (hi - lo) * 1e-6,
            "by_name_s": by_name,
            "breakdown": {"device_ops": [[k[:80], v] for k, v in ops],
                          "idle_gaps": labelled}}


def p95(values: List[float]) -> float:
    """The 95th percentile of all the values (linear between ranks)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))
