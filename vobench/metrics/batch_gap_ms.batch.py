"""Wall time a batched call minus the device's busy time a call: the
host's staging copies, clones and launches the device waits on (ms)."""

from vobench.metrics._read import traced


def read(r):
    t = traced(r)
    if t is None or not r.traced_units:
        return None
    return (t.window_s - t.busy_s) / r.traced_units * 1e3
