"""Offline replay through `run_vo --chunk N`'s path: each unit hands N
host frames to the card (each undistorted there, as run_vo does), runs
`VOFrontend.step_scan` (N donated steps as one CUDA graph, captured at
the first call) and reads the N frames' nav outputs back to the host."""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from vobench.runners._base import (outs_frames, read_nav, setup_parts,
                                   state_one, to_device)


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.n = ctx.traffic["chunk"]

    def setup(self):
        t0 = time.perf_counter()
        from rebvo_tpu_torch.frontend.step import VOFrontend
        from rebvo_tpu_torch.io.undistort import (apply_undistort,
                                                  build_undistort_map)
        c = self.ctx
        self.fe = VOFrontend(c.params, device=c.device)
        umap = (build_undistort_map(self.fe.cam, device=c.device)
                if c.params.useUndistort else None)
        self.frame = ((lambda i: apply_undistort(umap, to_device(c, 0, i)))
                      if umap is not None else (lambda i: to_device(c, 0, i)))
        t1 = time.perf_counter()
        self.st = self.fe.bootstrap(self.fe.init(), self.frame(0), c.t(0))
        t2 = time.perf_counter()
        self.next = 1
        self.warm = c.traffic["warm_units"]
        for _ in range(self.warm):
            self._unit()
        self.first = self.next
        self.parts = setup_parts(t0, t1, t2)

    def _unit(self):
        c, i0 = self.ctx, self.next
        frames = torch.stack([self.frame(i) for i in range(i0, i0 + self.n)])
        ts = np.asarray([c.t(i) for i in range(i0, i0 + self.n)], np.float32)
        with record_function("bench.call"):
            self.st, self.outs = self.fe.step_scan(self.st, frames, ts)
        self.next += self.n
        return read_nav(self.outs.nav)

    def run_unit(self, it):
        n, ok = self._unit()
        return n, ok, None

    def _frames(self, i0, i1):
        return [(self.ctx.idx(0, i), self.ctx.t(i)) for i in range(i0, i1)]

    def unit(self, it):
        i0 = self.first + it * self.n
        return [self._frames(i0, i0 + self.n)], [self.ctx.t(i0 - 1)]

    def start_frames(self):
        return [self._frames(0, self.first)]

    def state(self):
        return state_one(self.st)

    def outputs(self):
        return outs_frames(self.outs, lane_axis=False)

    def extras(self, units):
        return {}

    def close(self):
        del self.fe, self.st, self.outs, self.frame
