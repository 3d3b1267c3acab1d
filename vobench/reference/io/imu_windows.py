"""The per-frame IMU windows, as the program's dataset reader packs them:
a frozen copy of rebvo_tpu_torch/io/dataset.py's `slice_imu_windows`
and `imu_window_size`."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from vobench.reference.frontend.imu import ImuWindow


def slice_imu_windows(imu: np.ndarray, frame_times: List[float],
                      window_size: int = 32,
                      time_desinc: float = 0.0) -> List[ImuWindow]:
    """Pack per-frame IMU windows (CPU tensors) using the reference's
    search semantics (SeachByTimeStamp, imugrabber.cpp:174-210): samples
    with t_prev < t <= t_frame, both offset by `time_desinc`, at most
    `window_size` of them; `tsample` is the median sample spacing, in
    float32."""
    ts = np.median(np.diff(imu[:, 0])) if imu.shape[0] > 1 else 0.005
    windows = []
    t_prev = -np.inf
    for tf in frame_times:
        lo = imu[:, 0] > (t_prev + time_desinc)
        hi = imu[:, 0] <= (tf + time_desinc + 1e-12)
        sel = imu[lo & hi]
        n = min(sel.shape[0], window_size)
        gyro = np.zeros((window_size, 3), np.float32)
        accel = np.zeros((window_size, 3), np.float32)
        gyro[:n] = sel[:n, 1:4]
        accel[:n] = sel[:n, 4:7]
        windows.append(ImuWindow(
            gyro=torch.from_numpy(gyro), accel=torch.from_numpy(accel),
            count=torch.tensor(n, dtype=torch.int32),
            tsample=torch.tensor(ts, dtype=torch.float32)))
        t_prev = tf
    return windows


def imu_window_size(params) -> int:
    """Static per-frame IMU window capacity: samples per frame interval
    (SampleTime vs FPS) padded with 50% slack, at least 8."""
    per_frame = (1.0 / max(params.config_fps, 1e-6)) / \
        max(params.SampleTime, 1e-6)
    return max(8, int(np.ceil(per_frame * 1.5)))
