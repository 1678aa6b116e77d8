"""Spans, counters and the device trace of a run.

Host spans are the benchmark's own, recorded around its calls into the port
(``score.batch``, ``model.forward``, ``score.loss``), with
``time.perf_counter``, only in a traced run.
The device trace is torch.profiler's (CUDA activity: kernels only, so that
the window's events stay few); its clock is tied to the host's by a marker
kernel launched on an idle device at the start and the end of the window.
The arithmetic of device time by kernel name follows ``chip_smoke.py``'s.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

MARK = "spin_kernel"


class Spans:
    """Host spans (name, start, end) in perf_counter seconds; a no-op unless
    ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t, time.perf_counter()))


@dataclass
class Trace:
    """What a traced run hands the per-layer readers."""

    window_s: float
    spans: Spans
    counters: Dict[str, float]
    work: Dict[str, float]  # bound seconds by layer, and the window's model FLOPs
    t0: float
    t1: float
    kernels: List[Tuple[str, float, float]]  # host-clock seconds

    def device_s(self, *needles: str) -> float:
        """Device seconds of the kernels whose name holds any of ``needles``."""
        return sum(e - s for n, s, e in self.kernels if any(k in n for k in needles))

    def busy_s(self) -> float:
        """Seconds of the window in which some kernel ran (union of intervals)."""
        return sum(e - s for s, e in _union(self.kernels, self.t0, self.t1))


def _union(kernels, t0, t1):
    iv = sorted((max(s, t0), min(e, t1)) for _, s, e in kernels if e > t0 and s < t1)
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _mark():
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return t


class DeviceTrace:
    """torch.profiler over the window, on the card; ``kernels()`` gives every
    kernel as (name, start, end) on the host's perf_counter clock."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.marks: List[float] = []

    def __enter__(self):
        self.prof.__enter__()
        self.marks.append(_mark())
        return self

    def __exit__(self, *exc):
        self.marks.append(_mark())
        return self.prof.__exit__(*exc)

    def _raw(self):
        """(name, start us, end us) of the device events, on the profiler's
        clock."""
        out = []
        try:
            for e in self.prof.profiler.kineto_results.events():
                if e.device_type() != torch.autograd.DeviceType.CUDA:
                    continue
                if hasattr(e, "start_ns"):
                    s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
                else:
                    s, d = e.start_us(), e.duration_us()
                out.append((e.name(), s, s + d))
        except AttributeError:
            out = [(e.name, e.time_range.start, e.time_range.end) for e in self.prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        return out

    def kernels(self) -> List[Tuple[str, float, float]]:
        raw = self._raw()
        marks = sorted(s for n, s, _ in raw if MARK in n)
        if len(marks) < 2:
            raise RuntimeError(f"device trace: {len(marks)} marker kernels found of 2 "
                               f"({len(raw)} device events)")
        # host = a * device + b through the two markers
        (d0, d1), (h0, h1) = (marks[0], marks[-1]), self.marks
        a = (h1 - h0) / ((d1 - d0) * 1e-6)
        return [(n, h0 + a * (s - d0) * 1e-6, h0 + a * (e - d0) * 1e-6)
                for n, s, e in raw if MARK not in n]


def breakdown(tr: Trace, top: int = 10) -> Optional[dict]:
    """The device operations that took most time, and the idle gaps of the
    window summed by the innermost span open on the host when each began."""
    if not tr.kernels:
        return None
    ops: Dict[str, float] = {}
    for n, s, e in tr.kernels:
        ops[n] = ops.get(n, 0.0) + (e - s)
    busy = _union(tr.kernels, tr.t0, tr.t1)
    gaps, prev = [], tr.t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if tr.t1 > prev:
        gaps.append((prev, tr.t1))
    # spans nest (context managers on one thread): sweep them with a stack
    spans = sorted(tr.spans.items, key=lambda x: x[1])
    idle: Dict[str, float] = {}
    stack, i = [], 0
    for s, e in gaps:
        while i < len(spans) and spans[i][1] <= s:
            while stack and stack[-1][2] <= spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] <= s:
            stack.pop()
        name = stack[-1][0] if stack else "no span"
        idle[name] = idle.get(name, 0.0) + (e - s)

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_of(ops), "idle_gaps": top_of(idle)}
