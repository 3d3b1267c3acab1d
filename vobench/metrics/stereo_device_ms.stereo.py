"""Device time of the stereo stage a lane-frame: the program's stage
events `vo.stereo` (the pair's detection, K1 on cam1; the velocity-scale
carry and observers; the epipolar stereo match, the re-gauge and the
depth fusion; one CUDA event at each boundary, inside the graph replays
too), summed a step, the median over the run's steps (ms)."""

from vobench.metrics._spans import stage_ms_per_lane_frame


def read(r):
    return stage_ms_per_lane_frame("vo.stereo")
