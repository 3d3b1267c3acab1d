"""Raw frame recording and deterministic replay.

The reference builds raw recording into every camera
(VideoCam::PushFrame/RecordNFrames, src/VideoLib/videocam.cpp:101-146)
and replays the resulting file with `simcam` under a simulated clock
(src/VideoLib/simcam.cpp + TTimer::TurnSimuOn,
src/UtilLib/ttimer.cpp:111-180) for time-deterministic runs. Here: a
simple length-prefixed binary format (header + per-frame timestamp and
float32 payload) written incrementally, replayed via an iterator, in
three clock modes — free-running, paced (wall clock), or fully
simulated (`SimClock`, deterministic across runs and machines).

PyTorch counterpart of rebvo_tpu/io/recorder.py, the same file format;
`FrameRecorder.push` also takes a tensor on any device.
"""

from __future__ import annotations

import struct
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


class SimClock:
    """The TTimer/GlobalTimer role (ttimer.h:31, ttimer.cpp:30-180):
    a process clock that is wall time by default and, after
    `turn_simu_on`, a DETERMINISTIC simulated clock that only moves when
    `tick()`/`wait_until()` advance it — so replays are
    time-deterministic regardless of host speed.

    `sweep` scales simulated seconds per tick-step (SimuTimeSweep);
    `step` is the tick quantum (SimuTimeStep, in the same units as the
    recorded timestamps); `start` is SimuTimeStart."""

    def __init__(self):
        self._simu = False
        self._epoch = time.perf_counter()
        self._t = 0.0
        self._step = 1e-3
        self._sweep = 1.0

    def turn_simu_on(self, start: float = 0.0, sweep: float = 1.0,
                     step: float = 1e-3) -> None:
        self._simu = True
        self._t = float(start)
        self._sweep = float(sweep)
        self._step = float(step)

    @property
    def simulated(self) -> bool:
        return self._simu

    def now(self) -> float:
        if self._simu:
            return self._t
        return time.perf_counter() - self._epoch

    def tick(self, n: int = 1) -> float:
        """Advance the simulated clock n quanta (the TimerThread role,
        ttimer.cpp:142, without the thread: replay drives time)."""
        if self._simu:
            self._t += n * self._step * self._sweep
        return self.now()

    def wait_until(self, t: float) -> float:
        """Block (wall mode) or advance (simu mode) until `t`."""
        if self._simu:
            if t > self._t:
                self._t = float(t)
            return self._t
        delta = t - self.now()
        if delta > 0:
            time.sleep(delta)
        return self.now()

_MAGIC = b"RVSIM01\x00"
_HDR = struct.Struct("<8sII")        # magic, width, height
_FRAME = struct.Struct("<dI")        # t, payload bytes


class FrameRecorder:
    """Append frames to a raw recording file."""

    def __init__(self, path: str, width: int, height: int):
        self.fh = open(path, "wb")
        self.fh.write(_HDR.pack(_MAGIC, width, height))
        self.width = width
        self.height = height
        self.count = 0

    def push(self, t: float, frame) -> None:
        if isinstance(frame, torch.Tensor):
            frame = frame.to(torch.float32).cpu().numpy()
        arr = np.ascontiguousarray(np.asarray(frame, np.float32))
        assert arr.shape == (self.height, self.width)
        raw = arr.tobytes()
        self.fh.write(_FRAME.pack(float(t), len(raw)))
        self.fh.write(raw)
        self.count += 1

    def close(self) -> None:
        self.fh.close()


class SimReplay:
    """Replay a recording (the simcam role, simcam.cpp:57-96):

    * default: frames stream as fast as the consumer takes them;
    * `paced=True`: sleeps to reproduce the original inter-frame wall
      timing (scaled by `time_sweep`);
    * `clock=SimClock()` with the clock in simulated mode: each frame
      ADVANCES the shared simulated clock to its timestamp — fully
      deterministic end-to-end replay (TTimer::TurnSimuOn semantics),
      every consumer of `clock.now()` sees identical times every run."""

    def __init__(self, path: str, paced: bool = False,
                 time_sweep: float = 1.0, clock: SimClock = None):
        self.fh = open(path, "rb")
        magic, self.width, self.height = _HDR.unpack(
            self.fh.read(_HDR.size))
        if magic != _MAGIC:
            raise ValueError(f"not a recording: {path}")
        self.paced = paced
        self.time_sweep = time_sweep
        self.clock = clock

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray]]:
        wall0 = time.perf_counter()
        t0: Optional[float] = None
        while True:
            hdr = self.fh.read(_FRAME.size)
            if len(hdr) < _FRAME.size:
                break
            t, nbytes = _FRAME.unpack(hdr)
            raw = self.fh.read(nbytes)
            frame = np.frombuffer(raw, np.float32).reshape(
                self.height, self.width).copy()
            if self.clock is not None:
                self.clock.wait_until(t)
            elif self.paced:
                if t0 is None:
                    t0 = t
                target = (t - t0) / self.time_sweep
                sleep = target - (time.perf_counter() - wall0)
                if sleep > 0:
                    time.sleep(sleep)
            yield t, frame

    def close(self) -> None:
        self.fh.close()
