"""Device time of the visual-inertial stages a frame: the program's
stage events `vo.imu` (the window's integration, the gyro-bias init,
the map's pre-rotation) and `vo.imu_filter` (ext_rot_vel, bias_correct
and the scale/gravity filter), summed a step and taken over the step's
lanes, the median over the run's steps (ms; inside the graph replays
too)."""

import statistics

from vobench.runners import _obs

STAGES = ("vo.imu", "vo.imu_filter")


def read(r):
    per = {}
    for rec in _obs.records():
        if rec["name"] in STAGES and rec["device_ms"] is not None:
            step = (rec["unit"], rec["frame"])
            per[step] = per.get(step, 0.0) + rec["device_ms"] / rec["lanes"]
    return statistics.median(per.values()) if per else None
