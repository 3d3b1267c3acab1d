"""Share of the traced window in which no device activity ran (%).

The profiler stretches the host's side of the traced units (its
records of every launch), so this reads well above the idle share of an
untraced run: on an H100, 26.9-37.1% traced against 7-9% that 11.4 ms
of busy time a frame leaves in the 12.2-12.5 ms of an untraced replay
frame, and 41.6-46.2% against 18-27% in the 16-lane batch. Compare it
between traced runs only."""

from vobench.metrics._read import idle_pct as read  # noqa: F401
