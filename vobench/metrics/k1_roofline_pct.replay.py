"""K1's share of its roofline: the least time the card could take to
move K1's bytes for the traced lane-frames (vobench.peaks) over K1's
device time in the trace (%)."""

from vobench.metrics._read import k1_roofline_pct as read  # noqa: F401
