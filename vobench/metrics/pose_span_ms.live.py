"""Host time of the program's `vo.pose` span a frame, the median over
the frames outside the profiler (ms): the dispatch of the pose stage's
ops, unstretched by the profiler's records of each of them."""

from vobench.metrics._spans import span_ms


def read(r):
    return span_ms("vo.pose")
