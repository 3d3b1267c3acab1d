"""Offline stereo replay through `run_vo --stereo --chunk N`'s path: each
unit hands N host frames of cam0 and their N cam1 frames to the card,
each undistorted there through its own camera's map, stacks the two sets
and runs `VOFrontend.step_scan(..., frames_pair=...)` (N donated stereo
steps as one CUDA graph, captured at the first call), then reads the N
frames' nav outputs back to the host. The set-up is the eager stereo
runner's (`runners/stereo.py`): both maps, and the bootstrap with the
first pair.

The configuration has to state StereoAvaiable=1, which makes the run
render cam1 (vobench.run.make_inputs)."""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from vobench.runners._base import read_nav
from vobench.runners.scan import Runner as _Scan
from vobench.runners.stereo import Runner as _Stereo


class Runner(_Stereo):
    def _unit(self):
        c, i0 = self.ctx, self.next
        idx = range(i0, i0 + self.n)
        frames = torch.stack([self.frame(i) for i in idx])
        pairs = torch.stack([self.pair(i) for i in idx])
        ts = np.asarray([c.t(i) for i in idx], np.float32)
        with record_function("bench.call"):
            self.st, self.outs = self.fe.step_scan(self.st, frames, ts,
                                                   frames_pair=pairs)
        self.next += self.n
        return read_nav(self.outs.nav)

    outputs = _Scan.outputs
