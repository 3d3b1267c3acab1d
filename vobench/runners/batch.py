"""Many recordings replayed at once through `run_batch`'s path: every
lane's next host frame stacked into one [B, H, W] batch, handed to the
card (undistorted there in one call), and one vmapped step over the
lanes (`parallel.mesh.shard_sequences`: one CUDA graph per input
signature, captured at the first call); each unit reads every lane's
nav outputs back to the host."""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from vobench.runners._base import outs_frames, read_nav, setup_parts


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.B = ctx.traffic["lanes"]

    def setup(self):
        t0 = time.perf_counter()
        from rebvo_tpu_torch.frontend.step import VOFrontend
        from rebvo_tpu_torch.io.undistort import (apply_undistort,
                                                  build_undistort_map)
        from rebvo_tpu_torch.parallel.mesh import (shard_batch,
                                                   shard_sequences,
                                                   stack_lanes)
        c = self.ctx
        self.mesh = [c.device]
        self.shard = shard_batch
        self.fe = VOFrontend(c.params, device=c.device)
        self.umap = (build_undistort_map(self.fe.cam, device=c.device)
                     if c.params.useUndistort else None)
        self.undistort = apply_undistort
        bootv = shard_sequences(self.fe.bootstrap, self.mesh)
        t1 = time.perf_counter()
        self.stepv = shard_sequences(self.fe.step_donated, self.mesh)
        self.st = bootv(shard_batch(stack_lanes(self.fe.init(), self.B),
                                    self.mesh), *self._inputs(0))
        t2 = time.perf_counter()
        self.next = 1
        for _ in range(c.traffic["warm_units"]):
            self._unit()
        self.first = self.next
        self.parts = setup_parts(t0, t1, t2)

    def _inputs(self, i):
        """The lanes' frames of run frame i as one sharded block on the
        card (undistorted there), and their time stamps."""
        c = self.ctx
        with record_function("bench.inputs"):
            fb = torch.stack([c.host[b, c.idx(b, i)] for b in range(self.B)])
            fb = self.shard(fb, self.mesh)
            tb = self.shard(torch.full((self.B,), c.t(i),
                                       dtype=torch.float32), self.mesh)
        if self.umap is not None:
            fb = [self.undistort(self.umap, f) for f in fb]
        return fb, tb

    def _unit(self):
        inputs = self._inputs(self.next)
        with record_function("bench.call"):
            self.st, outs = self.stepv(self.st, *inputs)
        self.outs = outs[0]
        self.next += 1
        return read_nav(self.outs.nav)

    def run_unit(self, it):
        n, ok = self._unit()
        return n, ok, None

    def _frames(self, i0, i1):
        c = self.ctx
        return [[(c.idx(b, i), c.t(i)) for i in range(i0, i1)]
                for b in range(self.B)]

    def unit(self, it):
        i = self.first + it
        return self._frames(i, i + 1), [self.ctx.t(i - 1)] * self.B

    def start_frames(self):
        return self._frames(0, self.first)

    def state(self):
        from vobench.check import snapshot
        return snapshot(self.st[0], "state", self.B)

    def outputs(self):
        return outs_frames(self.outs, lane_axis=True)

    def extras(self, units):
        return {}

    def close(self):
        del self.fe, self.st, self.outs, self.stepv
