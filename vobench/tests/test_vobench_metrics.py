"""The metric arithmetic: tails over all frames, rates over the window,
the spread of runs, the trace reduction and K1's byte count."""

import statistics
from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from vobench import peaks, stats, trace
from vobench.metrics import _read


def test_percentiles_over_all_frames():
    rng = np.random.default_rng(3)
    lat = list(rng.gamma(4.0, 25.0, 257))
    assert stats.percentile(lat, 50) == pytest.approx(np.percentile(lat, 50))
    assert stats.percentile(lat, 95) == pytest.approx(np.percentile(lat, 95))
    assert stats.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_rate_and_spread():
    assert stats.rate(700, 10.0) == 70.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    v = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_k1_bytes_at_euroc_size():
    assert peaks.k1_bytes(1, 480, 752) == 9_024_000
    assert peaks.k1_bytes(16, 480, 752) == 16 * 9_024_000
    assert peaks.k1_bound_s(1, 480, 752) == pytest.approx(
        9_024_000 / 3.35e12)


class Ev:
    """A kineto event stand-in."""

    def __init__(self, name, dev, a, b, ann=False):
        self._n, self._d, self._a, self._b, self._ann = name, dev, a, b, ann

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._ann

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a


def synthetic_trace():
    """A 1,000 ns window: device busy 100-300, 250-400 (overlapping) and
    600-700, plus one activity outside the window; host spans bench.unit
    over the window, vo.pose 50-450 and vo.keyframe 500-900 inside it."""
    C, G = DeviceType.CPU, DeviceType.CUDA
    return [
        Ev(trace.WINDOW_SPAN, C, 0, 1000, ann=True),
        Ev("bench.unit", C, 0, 1000, ann=True),
        Ev("vo.pose", C, 50, 450, ann=True),
        Ev("vo.keyframe", C, 500, 900, ann=True),
        Ev("vo.pose", G, 100, 400, ann=True),     # device-side range
        Ev("detect_kernel<true>", G, 100, 300),
        Ev("gemm", G, 250, 400),
        Ev("memcpy", G, 600, 700),
        Ev("late", G, 1200, 1300),
        Ev("aten::add", C, 60, 70),
    ]


def test_trace_summary_busy_idle_and_gaps():
    s = trace.summarize(synthetic_trace())
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy_s == pytest.approx(400e-9)           # 100-400, 600-700
    assert s.activities == 3
    assert s.ops["detect_kernel<true>"] == pytest.approx(200e-9)
    assert s.spans["vo.pose"] == (1, pytest.approx(400e-9))
    # idle 0-100 (vo.pose open at 50), 400-600 (mid 500: vo.keyframe),
    # 700-1000 (mid 850: vo.keyframe)
    assert s.gaps["vo.pose"] == pytest.approx(100e-9)
    assert s.gaps["vo.keyframe"] == pytest.approx(500e-9)
    assert trace.top(s.gaps, 1) == [["vo.keyframe", pytest.approx(5e-7)]]


def test_readers_on_the_synthetic_trace():
    s = trace.summarize(synthetic_trace())
    r = SimpleNamespace(trace=s, traced_frames=2, traced_units=1,
                        height=480, width=752, extras={})
    assert _read.idle_pct(r) == pytest.approx(60.0)
    assert _read.busy_ms_per_frame(r) == pytest.approx(200e-9 * 1e3)
    assert _read.launches_per_frame(r) == 1.5
    assert _read.span_ms_per_frame(r, "vo.pose") == pytest.approx(2e-4)
    assert _read.span_ms_per_frame(r, "vo.imu_filter") is None
    assert _read.k1_roofline_pct(r) == pytest.approx(
        100 * peaks.k1_bound_s(2, 480, 752) / 200e-9)
    empty = r.__class__(**{**r.__dict__, "trace": None})
    assert _read.idle_pct(empty) is None
    assert _read.k1_roofline_pct(empty) is None


def test_merge_and_innermost_segments():
    assert trace.merge([(5, 9), (1, 3), (2, 4), (9, 10)]) == [(1, 4), (5, 10)]
    starts, segs = trace.innermost_segments(
        [(0, 10, "a"), (2, 5, "b"), (3, 4, "c")])
    assert [s[2] for s in segs] == ["a", "b", "c", "b", "a"]
    assert starts == [0, 2, 3, 4, 5]
