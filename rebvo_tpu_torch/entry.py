"""Entry points of the port: the one-card step and a multi-device dry run
(PyTorch counterparts of the repo root's `__graft_entry__.py`, which
drives the JAX package).

`entry()` returns the flagship computation, the full per-frame VO step at
EuRoC resolution, with example arguments.

`dryrun_multichip(n)` builds an n-device mesh (n CPU shards when fewer
CUDA devices are visible), shards a batch of n tiny sequences over it,
and runs one batched bootstrap and step through
`parallel.mesh.shard_sequences`.

    python -m rebvo_tpu_torch.entry 4
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def _make_inputs(params, seed=0) -> np.ndarray:
    """A textured frame at the configured size: a sign-of-sines
    checkerboard plus seeded noise (values 0..765)."""
    H, W = params.ImageHeight, params.ImageWidth
    rng = np.random.RandomState(seed)
    xx, yy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    img = 300.0 + 250.0 * np.sign(np.sin(xx / 17.0) * np.sin(yy / 13.0))
    return (img + rng.rand(H, W) * 8.0).astype(np.float32)


def entry(device="cuda"):
    """(fn, example_args): fn(state, frame, t) -> (state, Pos), the full
    step at 752x480 with KeylineMax=16384, from the state after the
    bootstrap frame."""
    from rebvo_tpu_torch.config import REBVOParameters
    from rebvo_tpu_torch.frontend.step import VOFrontend

    params = REBVOParameters()
    fe = VOFrontend(params, device=device)
    frame = torch.as_tensor(_make_inputs(params), device=device)
    state = fe.bootstrap(fe.init(), frame, 0.0)
    t = torch.tensor(0.05, device=device)

    def fn(state, frame, t):
        new_state, out = fe.step(state, frame, t)
        return new_state, out.nav.Pos

    return fn, (state, frame, t)


def dryrun_multichip(n_devices: int) -> np.ndarray:
    """One batched bootstrap and step of n tiny sequences sharded over an
    n-device mesh; returns their positions [n, 3], checked finite."""
    from rebvo_tpu_torch.config import REBVOParameters
    from rebvo_tpu_torch.frontend.step import VOFrontend
    from rebvo_tpu_torch.parallel.mesh import (data_mesh, gather,
                                               shard_batch, shard_sequences,
                                               stack_lanes)

    # tiny shapes: the sharding structure is what is checked
    params = REBVOParameters().replace(
        ImageWidth=64, ImageHeight=48, PPx=32.0, PPy=24.0,
        ZfX=40.0, ZfY=40.0, KcR2=0.0, KcR4=0.0, KcP1=0.0, KcP2=0.0,
        KeylineMax=256, MaxPoints=256, ReferencePoints=128, TrackPoints=256,
        SearchRange=8, MatchMaxSteps=12, GlobalMatchThreshold=2)
    mesh = data_mesh(n_devices, allow_cpu_fallback=True)
    B = n_devices
    fes = [VOFrontend(params, device=d) for d in mesh]
    frames = torch.as_tensor(np.stack([_make_inputs(params, seed=i)
                                       for i in range(B)]))
    ts = torch.full((B,), 0.05)
    states = shard_batch(stack_lanes(fes[0].init(), B), mesh)
    frames_s, ts_s = shard_batch(frames, mesh), shard_batch(ts, mesh)
    boot = shard_sequences([fe.bootstrap for fe in fes], mesh)
    step = shard_sequences([fe.step for fe in fes], mesh)
    states = boot(states, frames_s, shard_batch(torch.zeros(B), mesh))
    states, outs = step(states, frames_s, ts_s)
    pos = gather(outs).nav.Pos.numpy()
    assert pos.shape == (B, 3), pos.shape
    assert np.all(np.isfinite(pos)), pos
    print(f"dryrun_multichip: OK on {n_devices} devices, mesh="
          f"{[str(d) for d in mesh]}, pos finite")
    return pos


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
