"""The arithmetic the per-layer readers share, over the traced units of
a --trace 1 run (vobench.trace.TraceSummary)."""

from vobench import peaks


def traced(r):
    """The trace, when it saw the device work."""
    t = r.trace
    return t if t is not None and t.busy_s > 0 and r.traced_frames else None


def idle_pct(r):
    t = traced(r)
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)


def busy_ms_per_frame(r):
    t = traced(r)
    return None if t is None else t.busy_s / r.traced_frames * 1e3


def launches_per_frame(r):
    t = traced(r)
    return None if t is None else t.activities / r.traced_frames


def span_ms_per_frame(r, name):
    """Host milliseconds a frame inside the program's span `name`."""
    t = r.trace
    if t is None or name not in t.spans or not r.traced_frames:
        return None
    return t.spans[name][1] / r.traced_frames * 1e3


def k1_roofline_pct(r, kernel="detect_kernel"):
    """K1's byte bound for the traced frames over K1's device time."""
    t = traced(r)
    if t is None:
        return None
    k1_s = sum(s for n, s in t.ops.items() if kernel in n)
    if k1_s <= 0:
        return None
    return 100.0 * peaks.k1_bound_s(r.traced_frames, r.height,
                                    r.width) / k1_s
