"""Offline visual-inertial replay through `run_vo --imu --chunk N`'s
path: the mono replay runner (`runners/scan.py`), with each unit's N
frames handed to `VOFrontend.step_scan` together with their IMU
windows, cut on the host from the recording's imu0 rows and stacked (N
donated `step_imu` steps as one CUDA graph, captured at the first
call).

Frame i's window holds the rows after frame i - 1's time and up to its
own (vobench.check.Reference.window, the same cut), packed by the
program's own packer. The rows end after the traffic's `max_frames`: a
run that outlasts them stops with an error rather than step frames
without IMU."""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from vobench.runners._base import read_nav
from vobench.runners.scan import Runner as _Scan


class Runner(_Scan):
    def setup(self):
        from rebvo_tpu_torch.frontend.imu import stack_windows
        from rebvo_tpu_torch.io.dataset import (imu_window_size,
                                                slice_imu_windows)
        c = self.ctx
        p = c.params
        times = c.imu_rows[:, 0]
        size = imu_window_size(p)

        def window(i):
            # rows in (t_prev, t], both shifted by TimeDesinc; the times
            # rise, so the cut is two searches
            lo = np.searchsorted(times, c.t(i - 1) + p.TimeDesinc, "right")
            hi = np.searchsorted(times, c.t(i) + p.TimeDesinc + 1e-12,
                                 "right")
            if hi >= len(times):
                raise RuntimeError(
                    f"frame {i} outlasts the IMU rows (t {c.t(i):.3f} s): "
                    f"the traffic's max_frames is too small for this run")
            return slice_imu_windows(c.imu_rows[lo:hi], [c.t(i)], size,
                                     p.TimeDesinc)[0]
        self.windows = lambda i0, i1: stack_windows(
            [window(i) for i in range(i0, i1)])
        super().setup()

    def _unit(self):
        c, i0 = self.ctx, self.next
        with record_function("bench.inputs"):
            wins = self.windows(i0, i0 + self.n)
        frames = torch.stack([self.frame(i) for i in range(i0, i0 + self.n)])
        ts = np.asarray([c.t(i) for i in range(i0, i0 + self.n)], np.float32)
        with record_function("bench.call"):
            self.st, self.outs = self.fe.step_scan(self.st, frames, ts, wins)
        self.next += self.n
        return read_nav(self.outs.nav)

    def close(self):
        super().close()
        del self.windows
