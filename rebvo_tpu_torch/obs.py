"""Spans, counters and device stage times of the port, kept in memory.

    from rebvo_tpu_torch import obs
    with obs.unit(fe, n=8):                 # one entry call: its frame id
        with obs.span("graph.replay"):      # a host span
            ...
    obs.count("graph.replays")              # a counter
    obs.records(), obs.counters()           # read them back
    obs.dump("trace.json")                  # Chrome-trace JSON

Spans. `span(name)` opens the `torch.profiler.record_function` of the
same name, so a profiler trace keeps every span, and appends a record to
a bounded ring in memory: the name, the frame id and lanes of its unit,
the enclosing span, its start and end on `time.time_ns()` (the clock of
the profiler's events: Unix-epoch nanoseconds), the time its direct
children cover (its self time is the rest), and `profiled`: whether a
profiler session was recording when it opened. The profiler records
every op a span dispatches and stretches its host time, so a metric of
host time reads the spans with `profiled` false. The ring and the
counters are always on: there is no switch.

Units and frame ids. A unit is one entry call: one frame
(`VOFrontend.step_donated`, `VOSystem.process_frame`), a chunk of N
frames (`VOFrontend.step_scan`) or one vmapped call over B lanes
(`parallel.mesh.shard_sequences`, one unit with its lane count). Its
frame id is a host-side sequence number: `unit(source, n, lanes)` takes
it from `source`, an int, or an object whose `frame_id` attribute it
advances by n (`VOFrontend` keeps one). A unit opened while another is
open on the thread is that unit. No device value is read to number
frames. The ring keeps the last `CAPACITY` units, each with its records.

Device stage times. A `Timeline` records a CUDA event
(`enable_timing=True, external=True`) at each stage boundary of a step:
one at its start, one at each boundary (consecutive stages share one)
and one at its end, so the stages and the unnamed rest between them
(`vo.rest`) add up to the step's device time. Under CUDA-graph capture
the events become event-record nodes, which every replay records again;
eagerly they come from a small pool. Their times are read when the next
unit opens, by which time a caller that reads each unit's outputs back
has let them complete: a step's times are read only after `query()`
reports its last event complete. A graph's step whose events are
incomplete when the graph is replayed again, or an eager step still
incomplete behind `MAX_PENDING` newer ones, is dropped and counted in
the counter `obs.dropped`. Nothing here synchronizes or reads a device
value. On the CPU no event is recorded. A stage's device time runs from
the end of the device's work before it to the end of its own, so on the
eager path it holds the device's waits for the host's launches; inside
a graph, only the gaps between the graph's nodes.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Deque, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

CAPACITY = 4096       # units the ring keeps
MAX_PENDING = 64      # eager steps whose device times may wait unread
REST = "vo.rest"      # device time between and after the named stages


class Record(NamedTuple):
    """A host span (`device_ms` None) or a device stage time (`start_ns`
    and `end_ns` 0)."""

    name: str
    frame: int                  # frame id of its unit; -1 outside units
    lanes: int
    parent: Optional[str]       # the enclosing span (host spans)
    start_ns: int               # time.time_ns()
    end_ns: int
    profiled: bool              # a profiler session was recording
    child_ns: int               # time its direct child spans cover
    device_ms: Optional[float]  # device stages: the stage's device time

    @property
    def ms(self) -> float:
        """Host milliseconds of a span, device milliseconds of a stage."""
        if self.device_ms is not None:
            return self.device_ms
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def self_ns(self) -> int:
        return self.end_ns - self.start_ns - self.child_ns


class Unit:
    """One entry call: its first frame id, its frames and lanes, and what
    was recorded inside it, as tuples (name, parent, start_ns, end_ns,
    profiled, child_ns, device_ms, frame or None for the unit's) in
    `raw` (`records` makes them `Record`s)."""

    __slots__ = ("frame", "frames", "lanes", "raw")

    def __init__(self, frame: int, frames: int = 1, lanes: int = 1):
        self.frame, self.frames, self.lanes = frame, frames, lanes
        self.raw: list = []

    @property
    def records(self) -> List[Record]:
        return [Record(r[0], self.frame if r[7] is None else r[7],
                       self.lanes, *r[1:7]) for r in self.raw]


class _Pending(NamedTuple):
    timeline: "Timeline"
    unit: Unit
    frame: int


class _Tracer:
    def __init__(self, capacity: int = CAPACITY):
        self.ring: Deque[Unit] = collections.deque(maxlen=capacity)
        self.counts: Dict[str, int] = {}
        self.frame_id = 0               # frame ids of units given no source
        self.pending: List[_Pending] = []
        self.pool: Dict[int, list] = {}  # idle eager events, by device
        self.lock = threading.Lock()
        self.local = threading.local()


_T = _Tracer()


def _thread():
    loc = _T.local
    if not hasattr(loc, "stack"):
        loc.stack = []          # open spans, innermost last
        loc.unit = None         # the open unit
        loc.capture = None      # timelines made under graph capture
        loc.quiet = 0           # > 0: steps record no device events
    return loc


_now = time.time_ns


def _profiling() -> bool:
    return _autograd_profiler._is_profiler_enabled


def reset(capacity: int = CAPACITY) -> None:
    """Forget every record, counter and pending device time; the ring
    keeps the last `capacity` units from here on."""
    global _T
    _T = _Tracer(capacity)


def count(name: str, n: int = 1) -> None:
    with _T.lock:
        _T.counts[name] = _T.counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    with _T.lock:
        return dict(_T.counts)


class span:
    """`with span(name):` a host span (see the module docstring)."""

    __slots__ = ("name", "_rf", "_t0", "_prof", "_child", "_loc")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        loc = self._loc = _thread()
        rf = self._rf = record_function(self.name)
        rf.__enter__()
        self._prof = _autograd_profiler._is_profiler_enabled
        self._child = 0
        loc.stack.append(self)
        self._t0 = _now()
        return self

    def __exit__(self, *exc):
        t1 = _now()
        self._rf.__exit__(*exc)
        loc = self._loc
        stack = loc.stack
        stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            parent._child += t1 - self._t0
        u = loc.unit
        if u is None:               # a span outside any unit
            u = Unit(-1)
            _T.ring.append(u)
        u.raw.append((self.name, parent.name if parent is not None else None,
                      self._t0, t1, self._prof, self._child, None, None))
        return False


def open_unit() -> Optional[Unit]:
    """The unit open on this thread, or None outside any entry call."""
    return _thread().unit


class unit:
    """`with unit(source, n, lanes):` one entry call of `n` frames over
    `lanes` lanes. Its frame id is `source` (an int), or `source.frame_id`
    (advanced by n), or the module's own count when `source` is None or
    has no `frame_id`. Inside an open unit it is that unit. Opening a
    unit first reads the device times of earlier units that are ready."""

    __slots__ = ("source", "n", "lanes", "_opened")

    def __init__(self, source=None, n: int = 1, lanes: int = 1):
        self.source, self.n, self.lanes = source, n, lanes

    def __enter__(self) -> Unit:
        loc = _thread()
        self._opened = loc.unit is None
        if not self._opened:
            return loc.unit
        src = self.source
        if isinstance(src, int):
            frame = src
        else:
            owner = src if hasattr(src, "frame_id") else _T
            frame = owner.frame_id
            owner.frame_id = frame + self.n
        loc.unit = Unit(frame, self.n, self.lanes)
        _T.ring.append(loc.unit)
        if _T.pending:
            with span("obs.collect"):
                collect()
        return loc.unit

    def __exit__(self, *exc):
        if self._opened:
            _thread().unit = None
        return False


# ---------------------------------------------------------------------------
# Device stage times
# ---------------------------------------------------------------------------


def _event():
    return torch.cuda.Event(enable_timing=True, external=True)


class Timeline:
    """CUDA events at the stage boundaries of one step on `device`:

        tl = Timeline(device)      # the step's start
        ...                        # stage A
        tl.mark("A")               # A ends (and B starts)
        ...
        tl.close()                 # the rest, to the step's end

    The events are recorded on the device's current stream (under
    capture, the capturing one). Inactive on the CPU and while a graph's
    warm-up runs (`quiet`). Under graph capture its events belong to the
    graph (`capture`); eagerly they come from the device's pool, and
    `close` leaves the step's times to be read when the next unit
    opens."""

    __slots__ = ("events", "labels", "eager", "pending", "stream")

    def __init__(self, device):
        loc = _thread()
        self.events = None
        self.pending = False
        if device.type != "cuda" or loc.quiet:
            return
        self.eager = loc.capture is None
        if not self.eager:
            loc.capture.append(self)
        self.stream = torch.cuda.current_stream(device)
        self.events, self.labels = [], []
        self._record(None)

    def _record(self, label) -> None:
        ev = None
        if self.eager:
            with _T.lock:
                pool = _T.pool.get(self.stream.device_index)
                ev = pool.pop() if pool else None
        ev = ev or _event()
        ev.record(self.stream)
        self.events.append(ev)
        self.labels.append(label)

    def mark(self, label: str = REST) -> None:
        """The interval since the last mark is stage `label`."""
        if self.events is not None:
            self._record(label)

    def close(self) -> None:
        """The rest to the step's end; an eager step's times wait to be
        read (`collect`)."""
        if self.events is None:
            return
        self._record(REST)
        if self.eager:
            u = _thread().unit or Unit(-1)
            _pend(self, u, u.frame)

    def ready(self) -> bool:
        """The step's last event has completed (`query()`): the device
        records a step's events in order, and `elapsed_time` asks both of
        its events again before it reads them."""
        return self.events[-1].query()

    def read(self) -> Dict[str, float]:
        """The step's device milliseconds by stage, once `ready()`."""
        ms: Dict[str, float] = {}
        for a, b, label in zip(self.events, self.events[1:],
                               self.labels[1:]):
            ms[label] = ms.get(label, 0.0) + a.elapsed_time(b)
        return ms


def _pend(tl: Timeline, u: Unit, frame: int) -> None:
    tl.pending = True
    with _T.lock:
        _T.pending.append(_Pending(tl, u, frame))


def _release(tl: Timeline) -> None:
    tl.pending = False
    if tl.eager:
        with _T.lock:
            _T.pool.setdefault(tl.stream.device_index, []).extend(tl.events)
        tl.events = None


def collect() -> None:
    """Read the device times of every pending step whose events have
    completed into its unit's records; drop eager steps left behind
    `MAX_PENDING` newer ones. Never waits on the device."""
    if not _T.pending or torch.cuda.is_current_stream_capturing():
        return
    with _T.lock:
        todo, _T.pending = _T.pending, []
    keep = []
    for p in todo:
        if p.timeline.ready():
            p.unit.raw.extend((k, None, 0, 0, False, 0, v, p.frame)
                              for k, v in p.timeline.read().items())
            _release(p.timeline)
        else:
            keep.append(p)
    for p in keep[:max(0, len(keep) - MAX_PENDING)]:
        _release(p.timeline)
        count("obs.dropped")
    with _T.lock:
        _T.pending[:0] = keep[max(0, len(keep) - MAX_PENDING):]


class capture:
    """`with capture() as timelines:` around a graph capture: the steps
    captured record their events into the graph, and `timelines` lists
    their Timelines in order (`replayed` reads them after each
    replay)."""

    def __enter__(self) -> List[Timeline]:
        loc = _thread()
        self._prev = loc.capture
        loc.capture = []
        return loc.capture

    def __exit__(self, *exc):
        _thread().capture = self._prev
        return False


class quiet:
    """`with quiet():` steps record no device events (a graph's
    warm-up)."""

    def __enter__(self):
        _thread().quiet += 1

    def __exit__(self, *exc):
        _thread().quiet -= 1
        return False


def replayed(timelines) -> None:
    """A graph holding `timelines` (one a step, in order) was replayed in
    the open unit: step i is the unit's frame + i. A timeline still
    pending from the graph's last replay is dropped: the replay records
    its events again."""
    u = _thread().unit or Unit(-1)
    for i, tl in enumerate(timelines):
        if tl.pending:
            with _T.lock:
                _T.pending = [p for p in _T.pending if p.timeline is not tl]
            tl.pending = False
            count("obs.dropped")
        _pend(tl, u, u.frame + i)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def units() -> List[Unit]:
    """The units in the ring, oldest first (pending device times that
    are ready are read first)."""
    collect()
    return list(_T.ring)


def records(name: Optional[str] = None) -> List[Record]:
    """Every record in the ring, oldest unit first, or those named
    `name`."""
    return [r for u in units() for r in u.records
            if name is None or r.name == name]


def _kineto_base_ns() -> int:
    """The base time (`baseTimeNanoseconds`) that torch.profiler's
    `export_chrome_trace` writes, read from an empty session's export."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "base.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return int(json.load(fh)["baseTimeNanoseconds"])


def dump(path: str) -> str:
    """Write the ring as Chrome-trace JSON to `path`, on the epoch of
    torch.profiler's `export_chrome_trace` (its `baseTimeNanoseconds`;
    Unix epoch, base 0, while a profiler session records and no other
    can start), so that the two open together in Perfetto.
    Host spans are complete events of the process; each unit's device
    stage times lie end to end from the unit's first host span in a
    process of their own (their offset from the host is not measured);
    the counters go into `otherData`."""
    base_ns = 0 if _profiling() else _kineto_base_ns()
    pid = os.getpid()
    dev_pid = 1_000_000 + pid
    ev = [{"ph": "M", "name": "process_name", "pid": pid,
           "args": {"name": "rebvo_tpu_torch.obs host spans"}},
          {"ph": "M", "name": "process_name", "pid": dev_pid,
           "args": {"name": "rebvo_tpu_torch.obs device stage times "
                            "(end to end from each unit's host start)"}}]
    for u in units():
        spans = [r for r in u.records if r.device_ms is None]
        for r in spans:
            ev.append({"ph": "X", "cat": "obs", "name": r.name, "pid": pid,
                       "tid": pid, "ts": (r.start_ns - base_ns) / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3,
                       "args": {"frame": r.frame, "lanes": r.lanes,
                                "profiled": r.profiled}})
        t = min((r.start_ns for r in spans), default=None)
        if t is None:
            continue
        t = (t - base_ns) / 1e3
        for r in u.records:
            if r.device_ms is not None:
                ev.append({"ph": "X", "cat": "obs.device", "name": r.name,
                           "pid": dev_pid, "tid": 0, "ts": t,
                           "dur": r.device_ms * 1e3,
                           "args": {"frame": r.frame, "lanes": r.lanes}})
                t += r.device_ms * 1e3
    with open(path, "w") as fh:
        json.dump({"traceEvents": ev, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": base_ns,
                   "otherData": {"counters": counters()}}, fh)
    return path
