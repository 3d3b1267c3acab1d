"""Device activities (kernels, copies, fills) a lane-frame in the
traced window."""

from vobench.metrics._read import launches_per_frame as read  # noqa: F401
