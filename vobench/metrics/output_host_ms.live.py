"""Host time of `VOSystem`'s output section of a frame (the program's
span `sys.output`: the logger, the keyframe push, the pose-log entry and
the one host read of the frame, `sys.read`), the median over the frames
outside the profiler (ms)."""

from vobench.metrics._spans import span_ms


def read(r):
    return span_ms("sys.output")
