"""What every runner shares: moving a period frame (and a stereo run's
cam1 frame) to the card as the program's dataset path does, reading nav
outputs back to the host, and the canonical layout of states and
outputs (vobench.check)."""

from __future__ import annotations

import time
from typing import Dict

import torch
from torch.profiler import record_function

from vobench.check import snapshot

Tensor = torch.Tensor


def setup_parts(t0: float, t1: float, t2: float) -> Dict[str, float]:
    """Seconds of a runner's set-up: the program's objects, the first
    (bootstrap) frame, which loads or builds the kernels, and the
    warm-up units, which capture the CUDA graphs."""
    now = time.perf_counter()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        now = time.perf_counter()
    return {"objects_s": t1 - t0, "bootstrap_s": t2 - t1, "warm_s": now - t2}


def to_device(ctx, lane: int, i: int) -> Tensor:
    """Run frame i of lane `lane` as a float32 tensor on the card (the
    host frame copied in, as run_vo copies a decoded frame)."""
    with record_function("bench.inputs"):
        return torch.as_tensor(ctx.host[lane, ctx.idx(lane, i)],
                               dtype=torch.float32).to(ctx.device)


def to_device_pair(ctx, lane: int, i: int) -> Tensor:
    """cam1's frame of run frame i of lane `lane` on the card, as
    `to_device` moves cam0's (the same period index)."""
    with record_function("bench.inputs"):
        return torch.as_tensor(ctx.host_pair[lane, ctx.idx(lane, i)],
                               dtype=torch.float32).to(ctx.device)


def read_nav(nav) -> tuple:
    """Each frame's Pos, Vel and PoseLie on the host in one transfer:
    (frames read, frames whose position is finite)."""
    with record_function("bench.read"):
        host = torch.cat([nav.Pos, nav.Vel, nav.PoseLie], -1).cpu()
    rows = host.reshape(-1, 9)
    return rows.shape[0], int(torch.isfinite(rows[:, :3]).all(-1).sum())


def state_one(state) -> Dict[str, Tensor]:
    """A one-sequence state in the canonical layout [1, ...]."""
    return snapshot(state, "state", None)


def outs_frames(outs, lane_axis: bool) -> Dict[str, Tensor]:
    """Outputs in the canonical layout [L, F, ...]: `outs` stacked over
    frames ([F, ...], lane_axis False) or over lanes ([L, ...], one
    frame each)."""
    named = snapshot(outs, "out", 0)
    return {k: (v.unsqueeze(1) if lane_axis else v.unsqueeze(0))
            for k, v in named.items()}


def outs_one(out) -> Dict[str, Tensor]:
    """One frame's outputs in the canonical layout [1, 1, ...]."""
    return {k: v[None, None] for k, v in snapshot(out, "out", 0).items()}
