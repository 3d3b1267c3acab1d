"""Reduction of a torch.profiler trace to what the per-layer metrics
read: the device's busy time (the union of its activities) inside the
traced window, its activities by name, the host spans, and the device's
idle gaps labelled by the host span that was open during each.

The traced window is the host span WINDOW_SPAN that the harness opens
around the traced units; only activities inside it count.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Tuple

WINDOW_SPAN = "bench.window"


class TraceSummary(NamedTuple):
    window_s: float                 # length of the traced window
    busy_s: float                   # union of device activities in it
    activities: int                 # kernels, copies and fills in it
    ops: Dict[str, float]           # device seconds by activity name
    spans: Dict[str, Tuple[int, float]]   # host span: (count, seconds)
    gaps: Dict[str, float]          # idle seconds by the open host span


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals, sorted and disjoint."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def innermost_segments(spans: List[Tuple[int, int, str]]):
    """Flatten nested host spans (start, end, name) into disjoint
    segments, each labelled by the innermost span open over it: sorted
    segment starts and [(start, end, name)]."""
    events = []
    for a, b, name in spans:
        events.append((a, 1, b, name))
        events.append((b, 0, a, name))
    events.sort(key=lambda e: (e[0], e[1]))
    stack: List[Tuple[int, int, str]] = []
    segs: List[Tuple[int, int, str]] = []
    last = None
    for t, is_open, other, name in events:
        if stack and last is not None and t > last:
            segs.append((last, t, stack[-1][2]))
        if is_open:
            stack.append((t, other, name))
        else:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][2] == name and stack[i][0] == other:
                    del stack[i]
                    break
        last = t
    return [s[0] for s in segs], segs


def _start_duration_ns(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.duration_ns()
    return e.start_us() * 1000, e.duration_us() * 1000


def summarize(events) -> TraceSummary:
    """`events` are kineto events (`prof.profiler.kineto_results.events()`)
    or any objects with name(), device_type(), is_user_annotation(),
    start_ns() and duration_ns() (or start_us() and duration_us())."""
    from torch.autograd import DeviceType
    window = None
    host_spans: List[Tuple[int, int, str]] = []
    acts: List[Tuple[int, int, str]] = []
    for e in events:
        a, d = _start_duration_ns(e)
        b = a + d
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                acts.append((a, b, e.name()))
        elif e.is_user_annotation():
            if e.name() == WINDOW_SPAN:
                window = (a, b)
            else:
                host_spans.append((a, b, e.name()))
    if window is None:
        raise ValueError(f"trace has no {WINDOW_SPAN} span")
    w0, w1 = window
    acts = [(max(a, w0), min(b, w1), n) for a, b, n in acts
            if b > w0 and a < w1]
    ops: Dict[str, float] = {}
    for a, b, n in acts:
        ops[n] = ops.get(n, 0.0) + (b - a) * 1e-9
    busy = merge([(a, b) for a, b, _ in acts])
    spans: Dict[str, Tuple[int, float]] = {}
    inside = [s for s in host_spans if s[0] >= w0 and s[1] <= w1]
    for a, b, n in inside:
        c, t = spans.get(n, (0, 0.0))
        spans[n] = (c + 1, t + (b - a) * 1e-9)
    starts, segs = innermost_segments(inside)
    gaps: Dict[str, float] = {}
    prev = w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            mid = (prev + a) // 2
            i = bisect.bisect_right(starts, mid) - 1
            label = (segs[i][2] if i >= 0 and segs[i][0] <= mid < segs[i][1]
                     else "outside any span")
            gaps[label] = gaps.get(label, 0.0) + (a - prev) * 1e-9
        prev = max(prev, b)
    return TraceSummary(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(b - a for a, b in busy) * 1e-9,
        activities=len(acts), ops=ops, spans=spans, gaps=gaps)


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    """The n largest entries of {name: seconds} as [[name, seconds]]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
