"""Offline stereo replay through `run_vo --stereo`'s path as it runs
today: each frame and its cam1 frame are copied to the card and
undistorted there, each through its own camera's map, and stepped one
at a time by `VOFrontend.step_donated(state, frame, t, pair)`; the
bootstrap takes the first pair too. (`run_vo` steps stereo frames one
by one: it leaves `--chunk` unused with `--stereo`.) A unit is the
traffic's `chunk` frames, their nav outputs stacked and read back to
the host in one transfer.

The configuration has to state StereoAvaiable=1, which makes the run
render cam1 (vobench.run.make_inputs)."""

from __future__ import annotations

import time

from torch.profiler import record_function

from vobench.runners._base import (outs_frames, read_nav, setup_parts,
                                   to_device, to_device_pair)
from vobench.runners.scan import Runner as _Scan


class Runner(_Scan):
    def setup(self):
        t0 = time.perf_counter()
        from rebvo_tpu_torch.frontend.step import VOFrontend
        from rebvo_tpu_torch.graphs import stack_trees
        from rebvo_tpu_torch.io.undistort import (apply_undistort,
                                                  build_undistort_map)
        c = self.ctx
        if not c.params.StereoAvaiable or c.host_pair is None:
            raise ValueError("the stereo runner needs a configuration with "
                             "StereoAvaiable=1 and cam1's frames")
        self.stack = stack_trees
        self.fe = VOFrontend(c.params, device=c.device)

        def undistorted(cam, get):
            if not c.params.useUndistort:
                return get
            umap = build_undistort_map(cam, device=c.device)
            return lambda i: apply_undistort(umap, get(i))
        self.frame = undistorted(self.fe.cam, lambda i: to_device(c, 0, i))
        self.pair = undistorted(self.fe.cam_pair,
                                lambda i: to_device_pair(c, 0, i))
        t1 = time.perf_counter()
        self.st = self.fe.bootstrap(self.fe.init(), self.frame(0), c.t(0),
                                    self.pair(0))
        t2 = time.perf_counter()
        self.next = 1
        self.warm = c.traffic["warm_units"]
        for _ in range(self.warm):
            self._unit()
        self.first = self.next
        self.parts = setup_parts(t0, t1, t2)

    def _unit(self):
        c, i0 = self.ctx, self.next
        self.outs = []
        for i in range(i0, i0 + self.n):
            frame, pair = self.frame(i), self.pair(i)
            with record_function("bench.call"):
                self.st, out = self.fe.step_donated(self.st, frame, c.t(i),
                                                    pair)
            self.outs.append(out)
        self.next += self.n
        return read_nav(self.stack([o.nav for o in self.outs]))

    def outputs(self):
        return outs_frames(self.stack(self.outs), lane_axis=False)

    def close(self):
        super().close()
        del self.pair, self.stack
