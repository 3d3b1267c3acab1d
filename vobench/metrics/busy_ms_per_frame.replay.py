"""Device busy time (union of its activities) a lane-frame in the
traced window (ms)."""

from vobench.metrics._read import busy_ms_per_frame as read  # noqa: F401
