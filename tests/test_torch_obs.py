"""rebvo_tpu_torch.obs on the CPU: the spans of eager steps at 188x120
(frame ids, parents, self time), the bounded ring, the spans against the
profiler's events on one clock, the Chrome-trace dump's epoch, VOSystem's
frame ids, where the step marks its stage boundaries, the device-stage
bookkeeping with stand-in events (no CUDA event exists on the CPU),
`run_vo --trace-out`, and the benchmark's readers of the ring, fed a
stand-in ring as vobench/tests/test_vobench_metrics.py feeds stand-in
profiler events."""

import ast
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import rebvo_tpu_torch
from rebvo_tpu_torch import obs
from rebvo_tpu_torch.config import REBVOParameters, save_config
from rebvo_tpu_torch.frontend.imu import ImuWindow
from rebvo_tpu_torch.frontend.step import VOFrontend
from rebvo_tpu_torch.io.render import render_lateral
from rebvo_tpu_torch.system import VOSystem

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(ImageWidth=188, ImageHeight=120, ZfX=100.0, ZfY=100.0,
            PPx=94.0, PPy=60.0, KcR2=0.0, KcR4=0.0, KcP1=0.0, KcP2=0.0,
            KeylineMax=2048, MaxPoints=2048, ReferencePoints=800,
            TrackPoints=2048, GlobalMatchThreshold=50, DetectorThresh=0.03,
            DetectorAutoGain=1e-6)
STAGES = ["vo.front", "vo.pose", "vo.match_depth", obs.REST, "vo.keyframe",
          obs.REST]
NEAR_NS = 200_000      # a span and its profiler twin, start and end

torch.set_num_threads(2)


def tiny(**kw):
    return REBVOParameters().replace(**TINY, **kw)


@pytest.fixture(scope="module")
def frames():
    return render_lateral(tiny(), 4)


@pytest.fixture(autouse=True)
def fresh():
    obs.reset()
    yield
    obs.reset()


def stepped(frames, n=1):
    """A CPU frontend after its bootstrap and n donated steps."""
    fe = VOFrontend(tiny(), device="cpu")
    st = fe.bootstrap(fe.init(), frames[0], 0.0)
    for i in range(1, n + 1):
        st, _ = fe.step_donated(st, frames[i], i / 20.0)
    return fe, st


def test_eager_step_spans(frames):
    fe, _ = stepped(frames)
    us = obs.units()
    assert [u.frame for u in us] == [0, 1] and fe.frame_id == 2
    recs = us[1].records
    assert [r.name for r in recs] == ["vo.detect", "vo.front", "vo.pose",
                                      "vo.match_depth", "vo.keyframe"]
    by = {r.name: r for r in recs}
    assert by["vo.detect"].parent == "vo.front"
    assert all(by[k].parent is None for k in STAGES if k in by)
    assert all(r.frame == 1 and r.lanes == 1 and not r.profiled
               and r.device_ms is None for r in recs)
    det, front = by["vo.detect"], by["vo.front"]
    assert front.start_ns <= det.start_ns <= det.end_ns <= front.end_ns
    assert front.child_ns == det.end_ns - det.start_ns
    assert front.self_ns == (front.end_ns - front.start_ns) - \
        (det.end_ns - det.start_ns)
    assert det.self_ns == det.end_ns - det.start_ns
    for a, b in zip(recs[1:], recs[2:]):
        assert a.end_ns <= b.start_ns


def test_step_scan_is_one_unit(frames):
    fe, st = stepped(frames)
    st, outs = fe.step_scan(st, torch.stack(
        [torch.as_tensor(f) for f in frames[2:4]]),
        np.asarray([0.1, 0.15], np.float32))
    u = obs.units()[-1]
    assert (u.frame, u.frames, u.lanes) == (2, 2, 1) and fe.frame_id == 4
    assert [r.name for r in u.records].count("vo.pose") == 2
    assert {r.frame for r in u.records} == {2}


def test_ring_is_bounded():
    obs.reset(capacity=5)
    for i in range(12):
        with obs.unit(i):
            with obs.span("s"):
                pass
    us = obs.units()
    assert [u.frame for u in us] == list(range(7, 12))
    assert len(obs.records("s")) == 5


def test_counters_and_unit_numbering():
    class Owner:
        frame_id = 40
    o = Owner()
    with obs.unit(o, n=8, lanes=3) as u:
        with obs.unit(o) as inner:          # inside a unit: that unit
            assert inner is u
        obs.count("x")
        obs.count("x", 2)
    assert (u.frame, u.frames, u.lanes, o.frame_id) == (40, 8, 3, 48)
    with obs.unit() as a, obs.span("s"):
        pass
    with obs.unit() as b:
        pass
    assert (a.frame, b.frame) == (0, 1)
    assert obs.counters() == {"x": 3}
    with obs.span("loose"):
        pass
    assert obs.records("loose")[0].frame == -1


def _twins(prof, names):
    """The profiler's host annotations named in `names`, by start."""
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU and e.is_user_annotation()
           and e.name() in names]
    return sorted(evs, key=lambda e: e.start_ns())


def test_spans_on_the_profilers_clock(frames):
    fe, st = stepped(frames)
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("warm"):
            pass
        st, _ = fe.step_donated(st, frames[2], 0.1)
    inside = obs.records()
    assert inside and all(r.profiled for r in inside)
    twins = _twins(prof, {r.name for r in inside})
    assert len(twins) == len(inside)
    for r, e in zip(sorted(inside, key=lambda r: r.start_ns), twins):
        assert r.name == e.name()
        assert abs(r.start_ns - e.start_ns()) <= NEAR_NS, r.name
        assert abs(r.end_ns - (e.start_ns() + e.duration_ns())) <= \
            NEAR_NS, r.name
    obs.reset()
    fe.step_donated(st, frames[3], 0.15)
    assert obs.records() and not any(r.profiled for r in obs.records())


def test_dump_shares_the_profilers_epoch(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):
            with obs.unit(k), obs.span("outer"), obs.span("inner"):
                torch.ones(8).sum()
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    obs.dump(str(tmp_path / "obs.json"))
    kin = json.loads((tmp_path / "prof.json").read_text())
    got = json.loads((tmp_path / "obs.json").read_text())
    assert got["baseTimeNanoseconds"] == kin["baseTimeNanoseconds"]
    ours = [e for e in got["traceEvents"] if e.get("cat") == "obs"]
    assert len(ours) == 6
    for name in ("outer", "inner"):
        a = sorted(e["ts"] for e in ours if e["name"] == name)
        b = sorted(e["ts"] for e in kin["traceEvents"]
                   if e.get("name") == name
                   and e.get("cat") == "user_annotation")
        assert len(a) == len(b) == 3
        assert max(abs(x - y) for x, y in zip(a, b)) <= NEAR_NS / 1e3
    assert all(e["args"]["profiled"] for e in ours)
    assert "counters" in got["otherData"]


def test_vosystem_spans_carry_their_frame(frames):
    s = VOSystem(tiny(TrackKeyFrames=1), device="cpu")
    for i in range(3):
        s.process_frame(frames[i], i / 20.0)
    us = obs.units()
    assert [u.frame for u in us] == [0, 1, 2]
    assert [r.name for r in us[0].records] == ["sys.prep", "sys.step"]
    for u in us[1:]:
        by = {r.name: r for r in u.records}
        assert by["sys.output"].frame == by["vo.pose"].frame == u.frame
        assert by["sys.read"].parent == "sys.output"
        assert by["vo.pose"].parent == "sys.step"
        assert by["sys.prep"].end_ns <= by["sys.step"].start_ns <= \
            by["sys.step"].end_ns <= by["sys.output"].start_ns
    # the logger's stage times keep their layout: prep, step, and the
    # previous frame's output section
    assert len(s.logger.rows[-1]["tproc"]) == 3


class _MarkLog:
    """A Timeline stand-in that logs where the step marks."""

    log = []

    def __init__(self, device):
        self.log.append([])

    def mark(self, label=obs.REST):
        self.log[-1].append(label)

    def close(self):
        self.log[-1].append("end")


def test_steps_mark_their_stage_boundaries(frames, monkeypatch):
    monkeypatch.setattr(obs, "Timeline", _MarkLog)
    _MarkLog.log = []
    stepped(frames)
    assert _MarkLog.log == [STAGES[:-1] + ["end"]]
    _MarkLog.log = []
    fe = VOFrontend(tiny(ImuMode=2), device="cpu")
    st = fe.bootstrap(fe.init(), frames[0], 0.0)
    win = ImuWindow(gyro=torch.zeros(32, 3), accel=torch.zeros(32, 3),
                    count=torch.tensor(10, dtype=torch.int32),
                    tsample=torch.tensor(0.005))
    fe.step_imu_donated(st, frames[1], 0.05, win)
    assert _MarkLog.log == [["vo.imu", "vo.front", "vo.pose",
                             "vo.imu_filter", "vo.match_depth", obs.REST,
                             "vo.keyframe", "end"]]


class _Event:
    """A CUDA event stand-in: recording advances a clock by 1 ms; done
    only when the test says so."""

    clock = 0.0

    def __init__(self):
        self.t, self.done = None, False

    def record(self, stream):
        _Event.clock += 1.0
        self.t, self.done = _Event.clock, False

    def query(self):
        return self.done

    def elapsed_time(self, other):
        assert self.done and other.done
        return other.t - self.t


@pytest.fixture
def stand_in_events(monkeypatch):
    monkeypatch.setattr(obs, "_event", _Event)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(device_index=0))
    return torch.device("cuda")


def _one_step(dev):
    tl = obs.Timeline(dev)
    tl.mark("a")
    tl.mark()
    tl.mark("b")
    tl.close()
    return tl


def test_eager_stage_times_wait_until_complete(stand_in_events):
    dev = stand_in_events
    with obs.unit(5):
        tl = _one_step(dev)
    with obs.unit(6):
        pass
    assert obs.records(obs.REST) == []          # not complete: still waits
    for ev in tl.events:
        ev.done = True
    with obs.unit(7):
        pass
    got = {r.name: r for r in obs.records() if r.device_ms is not None}
    assert {k: r.device_ms for k, r in got.items()} == \
        {"a": 1.0, "b": 1.0, obs.REST: 2.0}
    assert {r.frame for r in got.values()} == {5}
    assert tl.events is None and len(obs._T.pool[0]) == 5   # pooled again
    with obs.unit(8):
        _one_step(dev)
    assert obs._T.pool[0] == []                 # the pool's events reused
    for _ in range(obs.MAX_PENDING + 3):       # 68 left incomplete
        with obs.unit(9):
            _one_step(dev)
    # the last unit's step waits on its own; the collect before it keeps
    # MAX_PENDING of the 67 older ones
    assert obs.counters() == {"obs.dropped": 3}
    assert len(obs._T.pending) == obs.MAX_PENDING + 1
    with obs.quiet():
        assert obs.Timeline(dev).events is None
    assert obs.Timeline(torch.device("cpu")).events is None


def test_graph_stage_times_by_replay(stand_in_events):
    dev = stand_in_events
    with obs.capture() as tls:
        steps = [_one_step(dev) for _ in range(2)]
    assert tls == steps and not any(t.pending for t in tls)
    with obs.unit(10, n=2):
        obs.replayed(tls)
    with obs.unit(20, n=2):                     # replayed again unread
        obs.replayed(tls)
    assert obs.counters() == {"obs.dropped": 2}
    for t in tls:
        for ev in t.events:
            ev.done = True
    stages = [r for r in obs.records() if r.device_ms is not None]
    assert sorted({r.frame for r in stages}) == [20, 21]
    assert len(stages) == 6 and tls[0].events is not None   # the graph's


def test_obs_reads_no_device_value():
    tree = ast.parse((ROOT / "rebvo_tpu_torch" / "obs.py").read_text())
    attrs = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert not attrs & {"item", "cpu", "synchronize", "numpy", "tolist"}


def test_run_vo_trace_out(tmp_path):
    from rebvo_tpu_torch.apps.run_vo import main
    cfg = str(tmp_path / "tiny.cfg")
    save_config(tiny(), cfg)
    path = tmp_path / "trace.json"
    main(["--config", cfg, "--render", "4", "--out-dir", str(tmp_path),
          "--cpu", "--trace-out", str(path)])
    got = json.loads(path.read_text())
    poses = [e for e in got["traceEvents"] if e.get("name") == "vo.pose"]
    assert [e["args"]["frame"] for e in poses] == [1, 2, 3]
    assert all(e["dur"] > 0 for e in poses)


# ---------------------------------------------------------------------------
# The benchmark's readers of the ring
# ---------------------------------------------------------------------------


def _unit(frame, lanes, raw):
    u = obs.Unit(frame, 1, lanes)
    u.raw = [r + (None,) if len(r) == 7 else r for r in raw]
    return u


def _span(name, ms, profiled=False, t0=0):
    return (name, None, t0, t0 + int(ms * 1e6), profiled, 0, None)


def _stage(name, ms, frame=None):
    return (name, None, 0, 0, False, 0, ms, frame)


def stand_in_ring():
    """A replay unit of 3 frames, a 16-lane call, two live frames, one
    profiled; graph calls with and without every span."""
    return [
        _unit(1, 1, [_span("graph.copy_in", 1.0), _span("graph.replay", 2.0),
                     _span("graph.clone_out", 3.0),
                     _stage("vo.pose", 5.0, 1), _stage("vo.front", 2.0, 1),
                     _stage("vo.pose", 6.0, 2), _stage("vo.pose", 7.0, 3)]),
        _unit(4, 16, [_span("graph.copy_in", 0.5), _span("graph.replay", 0.5),
                      _span("graph.clone_out", 1.0),
                      _stage("vo.pose", 16.0)]),
        _unit(5, 1, [_span("graph.copy_in", 9.0, True),
                     _span("graph.replay", 9.0, True),
                     _span("graph.clone_out", 9.0, True)]),
        _unit(6, 1, [_span("graph.copy_in", 9.0), _span("graph.replay", 9.0)]),
        _unit(7, 1, [_span("vo.pose", 40.0), _span("sys.output", 1.0)]),
        _unit(8, 1, [_span("vo.pose", 100.0, True),
                     _span("sys.output", 9.0, True)]),
        _unit(9, 1, [_span("vo.pose", 42.0), _span("sys.output", 3.0)]),
    ]


def stand_in_reading():
    trace = SimpleNamespace(
        spans={"graph.replay": (4, 0.01), "bench.call": (4, 0.4)},
        gaps={"graph.replay": 0.02, "graph.clone_out": 0.004,
              "bench.call": 0.5, "outside any span": 0.1})
    return SimpleNamespace(trace=trace, traced_units=4, traced_frames=32)


READERS = {"pose_device_ms.replay": 5.5,      # 5, 6, 7 and 16 / 16 lanes
           "graph_host_ms.replay": 4.0,       # 6 and 2: profiled, part out
           "graph_gap_ms.replay": 6.0,        # 24 ms of gaps, 4 units
           "pose_span_ms.live": 41.0,         # 40 and 42: profiled out
           "output_host_ms.live": 2.0}


def _reader(name):
    from vobench import run
    return run.load_module(ROOT / "vobench" / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_stand_in_ring(name, monkeypatch):
    monkeypatch.setattr(obs, "units", stand_in_ring)
    assert _reader(name).read(stand_in_reading()) == \
        pytest.approx(READERS[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_the_programs_ring(name, monkeypatch):
    """A program without obs (the benchmark laid over an older one), or
    a trace without its spans: nothing to read, and no error."""
    monkeypatch.delattr(rebvo_tpu_torch, "obs")
    monkeypatch.setitem(sys.modules, "rebvo_tpu_torch.obs", None)
    r = stand_in_reading()
    r.trace.spans.pop("graph.replay")
    assert _reader(name).read(r) is None


def test_benchmark_lists_the_readers():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert (ROOT / "vobench" / "metrics" / f"{name}.py").exists()
        assert per[name]["workloads"] == (
            ["euroc_mono.live"] if name.endswith(".live")
            else ["euroc_mono.replay", "euroc_mono.batch16"])
