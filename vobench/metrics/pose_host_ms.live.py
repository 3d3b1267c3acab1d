"""Host time a frame inside the program's `vo.pose` span (ms)."""

from vobench.metrics._read import span_ms_per_frame


def read(r):
    return span_ms_per_frame(r, "vo.pose")
