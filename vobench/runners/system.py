"""A live camera through the embedded system, `VOSystem.process_frame`
(its keyframe store, pose-graph log and logger), in a closed loop: the
next frame is handed over once the last frame's position is on the
host. Each frame's latency runs from the host frame being handed over
(copied to the card and undistorted there) to its nav `Pos` on the
host.

The state compared is the step's and the system's own: the keyframe
store, the lengths of the pose-graph log and of the logger, the frames
processed (vobench.reference.system); the outputs add the newest entry
of the pose-graph log."""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from vobench.check import snapshot
from vobench.runners._base import (outs_one, setup_parts, state_one,
                                   to_device)


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self):
        t0 = time.perf_counter()
        from rebvo_tpu_torch.io.undistort import (apply_undistort,
                                                  build_undistort_map)
        from rebvo_tpu_torch.system import VOSystem
        c = self.ctx
        self.sys = VOSystem(c.params, device=c.device)
        umap = (build_undistort_map(self.sys.frontend.cam, device=c.device)
                if c.params.useUndistort else None)
        self.frame = ((lambda i: apply_undistort(umap, to_device(c, 0, i)))
                      if umap is not None else (lambda i: to_device(c, 0, i)))
        t1 = time.perf_counter()
        self.sys.process_frame(self.frame(0), c.t(0))
        t2 = time.perf_counter()
        self.next = 1
        for _ in range(c.traffic["warm_units"]):
            self.run_unit(None)
        self.first = self.next
        self.rows0 = len(self.sys.logger)
        self.parts = setup_parts(t0, t1, t2)

    def run_unit(self, it):
        i = self.next
        t_hand = time.perf_counter()
        frame = self.frame(i)
        with record_function("bench.call"):
            self.out = self.sys.process_frame(frame, self.ctx.t(i))
        with record_function("bench.read"):
            pos = self.out.nav.Pos.cpu()
        lat = time.perf_counter() - t_hand
        self.next += 1
        return 1, int(torch.isfinite(pos).all()), [lat]

    def unit(self, it):
        i = self.first + it
        return [[(self.ctx.idx(0, i), self.ctx.t(i))]], [self.ctx.t(i - 1)]

    def start_frames(self):
        return [[(self.ctx.idx(0, i), self.ctx.t(i))
                 for i in range(self.first)]]

    def state(self):
        s = self.sys
        out = state_one(s.state)
        out.update(snapshot(s.kf_store, "sys.kf", None))
        for k, n in (("sys.log.n", len(s.pose_log.meas)),
                     ("sys.logger.n", len(s.logger)),
                     ("sys.frames", s.frame_count)):
            out[k] = torch.tensor([n], dtype=torch.int64)
        return out

    def outputs(self):
        out = outs_one(self.out)
        m = self.sys.pose_log.meas[-1]
        for k, v in (("rel_pose", m.rel_pose), ("W", m.W),
                     ("g_est", m.g_est), ("K", m.K), ("kf_id", m.kf_id)):
            out[f"out.sys.meas.{k}"] = torch.as_tensor(np.asarray(v))[None, None]
        return out

    def extras(self, units):
        """The system's own host stage times (its logger's `tproc`: prep,
        step dispatch, the previous frame's output section) of the
        frames of `units`."""
        rows = self.sys.logger.rows
        return {"tproc": [rows[self.rows0 + u]["tproc"] for u in units]}

    def close(self):
        del self.sys, self.out, self.frame
