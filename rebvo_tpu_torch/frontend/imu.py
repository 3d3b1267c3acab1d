"""Visual-inertial filter state (PyTorch counterpart of the state
containers of rebvo_tpu/frontend/imu.py).

Only `ScaleWindows` is here, so that `VOState` carries the same fields as
the JAX package's and a state converts across whole. The filter itself
(integrate_window, ext_rot_vel, bias_correct, the scale estimator) is
ROADMAP item M10.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class ScaleWindows(NamedTuple):
    """Explicit state for the reference's ScaleEstimator statics
    (scaleestimator.cpp:41-44, 95-97)."""

    v_hist: Tensor   # [5, 3] rotated velocity window (newest first)
    dt_hist: Tensor  # [4]
    a_hist: Tensor   # [4, 3] rotated accel window (newest first)

    @staticmethod
    def init(dtype=torch.float32, device="cuda") -> "ScaleWindows":
        return ScaleWindows(
            v_hist=torch.zeros((5, 3), dtype=dtype, device=device),
            dt_hist=torch.zeros((4,), dtype=dtype, device=device),
            a_hist=torch.zeros((4, 3), dtype=dtype, device=device))
