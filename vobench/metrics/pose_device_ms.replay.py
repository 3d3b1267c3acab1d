"""Device time of the pose stage a lane-frame: the program's stage
events (`vo.pose`: the LM solver over its warm starts; one CUDA event at
each stage boundary, inside the graph replays too), the median over the
run's steps of the stage's device time over the step's lanes (ms)."""

from vobench.metrics._spans import stage_ms_per_lane_frame


def read(r):
    return stage_ms_per_lane_frame("vo.pose")
