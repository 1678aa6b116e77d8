"""The window's kernels joined to the spans that launched them.

The card runs behind the host: a kernel usually runs after the span that
launched it has closed, so a kernel is never placed by the time it ran.
torch.profiler (CUDA activity, as ``trace.DeviceTrace`` configures it) also
records each launch call on the host (``cudaLaunchKernel*``, ``cuLaunchKernel*``)
under the ``correlation_id`` of the kernel it launched.  The host time of that
record, moved onto ``time.perf_counter`` by the two marker kernels' own
launch records, finds the innermost span open at the launch: the harness's
spans (``trace.Spans``) and the port's (``utils/tracing.py``) in one list on
one clock.  A kernel without a launch record belongs to no span.

Readings from a join: ``attn_span_roofline`` (the attention layer's bound
over the device time launched inside ``dmx.attention``) and
``forward_self_ms`` (device ms a batch launched inside ``dmx.forward`` but
inside neither ``dmx.linear`` nor ``dmx.attention``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import MARK, _union

NO_SPAN = "no span"

Span = Tuple[str, float, float]  # name, start, end: perf_counter seconds


def one_list(harness: Sequence[Span], port: Sequence[tuple]) -> List[Span]:
    """The harness's spans and the port's records ``(name, parent, start,
    end)`` as one list of closed spans, ordered by start, outer first."""
    spans = list(harness) + [(n, s, e) for n, _, s, e in port if e is not None]
    return sorted(spans, key=lambda x: (x[1], -x[2]))


def nest(spans: Sequence[Span]) -> List[int]:
    """Each span's parent index in ``spans`` (ordered as :func:`one_list`
    orders them), -1 at the top; spans nest, as context managers on one
    thread do."""
    parents, stack = [], []
    for i, (_, s, _) in enumerate(spans):
        while stack and spans[stack[-1]][2] <= s:
            stack.pop()
        parents.append(stack[-1] if stack else -1)
        stack.append(i)
    return parents


def innermost(spans: Sequence[Span], times: Sequence[float]) -> List[int]:
    """For each time, the index of the innermost span open then, -1 for none."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [-1] * len(times)
    stack, i = [], 0
    for q in order:
        t = times[q]
        while i < len(spans) and spans[i][1] <= t:
            while stack and spans[stack[-1]][2] <= spans[i][1]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]][2] <= t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


@dataclass
class Joined:
    """Kernels ``(name, device seconds, index of the innermost span open at
    the launch or -1)`` over ``spans``, with ``parents`` from :func:`nest`."""

    spans: List[Span]
    parents: List[int]
    kernels: List[Tuple[str, float, int]]
    residual_s: float = 0.0  # the clock map's error at the markers
    unlaunched: int = 0  # kernels with no launch record, under no span
    _chains: Dict[int, frozenset] = field(default_factory=dict, repr=False)

    def chain(self, i: int) -> frozenset:
        """The names of span ``i`` and of every span around it."""
        if i < 0:
            return frozenset()
        if i not in self._chains:
            self._chains[i] = self.chain(self.parents[i]) | {self.spans[i][0]}
        return self._chains[i]

    def name_of(self, i: int) -> str:
        return self.spans[i][0] if i >= 0 else NO_SPAN

    def device_s_under(self, name: str, self_only: bool = False) -> float:
        """Device seconds of the kernels launched inside a span ``name``;
        ``self_only``: only those whose innermost span it is."""
        if self_only:
            return sum(d for _, d, i in self.kernels if self.name_of(i) == name)
        return sum(d for _, d, i in self.kernels if name in self.chain(i))

    def by_span(self) -> Dict[str, float]:
        """Device seconds by innermost span name."""
        out: Dict[str, float] = {}
        for _, d, i in self.kernels:
            out[self.name_of(i)] = out.get(self.name_of(i), 0.0) + d
        return out

    def idle_by_span(self, executed, t0: float, t1: float) -> Dict[str, float]:
        """The idle gaps of [t0, t1] between ``executed`` kernels ``(name,
        start, end)``, summed by the innermost span open on the host when
        each gap began."""
        gaps, prev = [], t0
        for s, e in _union(executed, t0, t1):
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if t1 > prev:
            gaps.append((prev, t1))
        idle: Dict[str, float] = {}
        for (s, e), i in zip(gaps, innermost(self.spans, [s for s, _ in gaps])):
            idle[self.name_of(i)] = idle.get(self.name_of(i), 0.0) + (e - s)
        return idle


def join(kernels: Sequence[Tuple[str, float, Optional[float]]], spans: Sequence[Span],
         residual_s: float = 0.0) -> Joined:
    """``kernels`` as ``(name, device seconds, launch time on perf_counter or
    None)`` joined to ``spans`` (ordered as :func:`one_list` orders them)."""
    launched = [k for k in kernels if k[2] is not None]
    at = innermost(spans, [t for _, _, t in launched])
    out = [(n, d, i) for (n, d, _), i in zip(launched, at)]
    out += [(n, d, -1) for n, d, t in kernels if t is None]
    return Joined(list(spans), nest(spans), out, residual_s, len(kernels) - len(launched))


def profile_launches(prof, marks: Sequence[float]):
    """From a finished torch.profiler ``prof`` over a window bracketed by the
    two marker kernels, launched at perf_counter ``marks``: each other device
    event as ``(name, device seconds, launch time on perf_counter or None)``,
    the clock map's residual (s), and the launch calls' names with their
    counts.  The map is fitted on the markers' launch records; the residual
    is how far the two markers' clock offsets disagree."""
    import torch

    dev, host = [], {}  # host: the earliest CUDA API call of each correlation id
    for e in prof.profiler.kineto_results.events():
        c = e.correlation_id()
        s = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            d = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
            dev.append((e.name(), d * 1e-9, c))
        elif c and e.name().startswith("cu") and (c not in host or s < host[c][0]):
            host[c] = (s, e.name())
    mark = sorted(host[c][0] for n, _, c in dev if MARK in n and c in host)
    if len(mark) < 2 or len(marks) < 2:
        raise RuntimeError(f"launch join: {len(mark)} marker launch records of 2")
    (l0, l1), (h0, h1) = (mark[0], mark[-1]), (marks[0], marks[-1])
    a = (h1 - h0) / ((l1 - l0) * 1e-9)
    residual = abs((h1 - h0) - (l1 - l0) * 1e-9)
    apis: Dict[str, int] = {}
    out = []
    for n, d, c in dev:
        if MARK in n:
            continue
        rec = host.get(c)
        if rec is not None:
            apis[rec[1]] = apis.get(rec[1], 0) + 1
        out.append((n, d, None if rec is None else h0 + a * (rec[0] - l0) * 1e-9))
    return out, residual, apis


def attn_span_roofline(trace, joined: Joined) -> "float | None":
    """100 x the window's attention bound (``work/``) over the device time
    launched inside ``dmx.attention``, in %; None without such time."""
    bound, dev = trace.work.get("attention"), joined.device_s_under("dmx.attention")
    if not bound or dev <= 0:
        return None
    return 100.0 * bound / dev


def forward_self_ms(trace, joined: Joined) -> "float | None":
    """Device ms a batch of the kernels launched inside ``dmx.forward`` and in
    no span within it (``dmx.linear``, ``dmx.attention``); None without."""
    dev, n = joined.device_s_under("dmx.forward", self_only=True), trace.counters.get("batches")
    if dev <= 0 or not n:
        return None
    return 1e3 * dev / n
