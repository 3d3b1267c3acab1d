"""Frames per second completed: every lane-frame whose nav state
reached the host in the window, over the window (its first unit handed
over to its last unit's outputs on the host)."""

from vobench.stats import rate


def read(r):
    return rate(r.frames, r.window_s) if r.frames else None
