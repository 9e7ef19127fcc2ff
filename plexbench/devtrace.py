"""The device trace of a traced run: ``torch.profiler`` over the card's
activity alone (kernels, copies, sets), read from the profiler's raw events
(building its Python event tree would take minutes at a decode loop's
hundreds of thousands of kernels).

The profiler's event times are on the Unix clock; the harness's spans are on
``time.monotonic``. ``offset`` (monotonic minus Unix, read when tracing
starts) maps the one onto the other.
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self.t0 = self.t1 = None       # monotonic seconds
        self.offset = 0.0
        self.kernels: List[Tuple[str, float, float]] = []   # name, start, dur

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self.offset = time.monotonic() - time.time()
        self.t0 = time.monotonic()

    def stop(self):
        """Stop tracing (the profiler synchronises the card first) and keep
        every device event that lies in the traced stretch."""
        from torch.autograd import DeviceType
        self.t1 = time.monotonic()
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        out = []
        for e in events:
            if e.device_type() != DeviceType.CUDA:
                continue
            start = e.start_ns() / 1e9 + self.offset
            out.append((e.name(), start, e.duration_ns() / 1e9))
        out.sort(key=lambda k: k[1])
        self.kernels = out
        self._prof = None

    @property
    def started(self) -> bool:
        return self.t0 is not None

    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device events' intervals, clipped to the traced
        stretch."""
        merged: List[List[float]] = []
        for _, s, d in self.kernels:
            a, b = max(s, self.t0), min(s + d, self.t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle stretches of the card between the traced stretch's ends."""
        out, cur = [], self.t0
        for a, b in self.busy_intervals():
            if a > cur:
                out.append((cur, a))
            cur = max(cur, b)
        if self.t1 > cur:
            out.append((cur, self.t1))
        return out

    def matching(self, patterns) -> List[Tuple[str, float, float]]:
        return [k for k in self.kernels if any(p in k[0] for p in patterns)]


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = re.sub(r"^void ", "", name)
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:96]


def top_ops(trace: DeviceTrace, n: int = 10) -> List[list]:
    by: Dict[str, float] = {}
    for name, _, dur in trace.kernels:
        key = short_name(name)
        by[key] = by.get(key, 0.0) + dur
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def labelled_gaps(trace: DeviceTrace, label, n: int = 10) -> List[list]:
    """The ``n`` longest idle gaps, each named by ``label(t)``: what the
    host was doing at the gap's middle."""
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:n]
    return [[label(0.5 * (a + b)), b - a] for a, b in gaps]


def clip_note(trace: Optional[DeviceTrace]) -> str:
    if trace is None or not trace.started:
        return "no trace"
    return f"{len(trace.kernels)} device events over {trace.window_s()} s"
