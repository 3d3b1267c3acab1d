"""Median over all frames of the window of the time from handing a host
frame to the system until its nav Pos is on the host (ms)."""

from vobench.stats import percentile


def read(r):
    return percentile(r.latencies, 50) * 1e3 if r.latencies else None
