"""The embedded system's host layer, plain: a frozen copy of what the
measured program's `VOSystem` does after each step (its keyframe store
and pose-graph log, rebvo_tpu_torch/system.py `_keyframe_and_log`,
backend/keyframe.py `push_keyframe`), on named leaves.

The system's part of a state is a dict of named leaves with a lane axis
of 1:

    sys.kf.<leaf>      the keyframe store: a ring of KF_SLOTS keyframes
                       (valid, t, K_scale, Pose, Pos, Vel, klm.<field>,
                       next_slot, count)
    sys.log.n          entries in the pose-graph log
    sys.logger.n       rows in the run logger
    sys.frames         frames the system has processed

and each stepped frame adds the pose-graph log's new entry as outputs
`out.sys.meas.<field>` (rel_pose, W, g_est, K, kf_id).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from vobench.reference.frontend.state import KeylineMap

Tensor = torch.Tensor

KF_SLOTS = 64            # the keyframe store's ring capacity
_STORE = ("t", "K_scale", "Pose", "Pos", "Vel")


def empty(K: int) -> Dict[str, Tensor]:
    """A system that has processed no frame (host tensors, lane axis 1)."""
    F = KF_SLOTS
    f32 = torch.float32
    out = {"sys.kf.valid": torch.zeros((F,), dtype=torch.bool),
           "sys.kf.t": torch.zeros((F,), dtype=f32),
           "sys.kf.K_scale": torch.ones((F,), dtype=f32),
           "sys.kf.Pose": torch.eye(3, dtype=f32).repeat(F, 1, 1),
           "sys.kf.Pos": torch.zeros((F, 3), dtype=f32),
           "sys.kf.Vel": torch.zeros((F, 3), dtype=f32)}
    klm = KeylineMap.empty(K, batch_shape=(F,), device="cpu")
    for name, v in klm._asdict().items():
        out[f"sys.kf.klm.{name}"] = v
    out["sys.kf.next_slot"] = torch.zeros((), dtype=torch.int32)
    out["sys.kf.count"] = torch.zeros((), dtype=torch.int32)
    for k in ("sys.log.n", "sys.logger.n", "sys.frames"):
        out[k] = torch.zeros((), dtype=torch.int64)
    return {k: v[None] for k, v in out.items()}


def counters_from(sysd: Dict[str, Tensor], kf_count: int,
                  frame_count: int) -> Dict[str, Tensor]:
    """`sysd` with its counters as a sound system holds them after
    `frame_count` frames (the bootstrap first) of which the step saved
    `kf_count` keyframes: every saved keyframe pushed, every frame after
    the bootstrap logged once. Slot contents are kept as given."""
    out = dict(sysd)
    live = min(kf_count, KF_SLOTS)
    out["sys.kf.valid"] = (torch.arange(KF_SLOTS) < live)[None]
    out["sys.kf.count"] = torch.tensor([live], dtype=torch.int32)
    out["sys.kf.next_slot"] = torch.tensor([kf_count % KF_SLOTS],
                                           dtype=torch.int32)
    steps = max(frame_count - 1, 0)
    for k in ("sys.log.n", "sys.logger.n"):
        out[k] = torch.tensor([steps], dtype=torch.int64)
    out["sys.frames"] = torch.tensor([frame_count], dtype=torch.int64)
    return out


def after_bootstrap(sysd: Dict[str, Tensor]) -> Dict[str, Tensor]:
    out = dict(sysd)
    out["sys.frames"] = sysd["sys.frames"] + 1
    return out


def transported_meas(rot, vel, rot_lie, W_X) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    """The pose-graph measurement of one frame: rel_pose = [-R V; log R]
    and the information W_X on x = [V; W] pushed through the
    pseudo-inverse of J = d rel_pose / d x, in float64."""
    rel_t = -rot @ vel
    rel = np.concatenate([rel_t, rot_lie])
    J = np.zeros((6, 6))
    J[3:, 3:] = -np.eye(3)
    J[:3, :3] = -rot
    J[:3, 3:] = np.array([[0.0, -rel_t[2], rel_t[1]],
                          [rel_t[2], 0.0, -rel_t[0]],
                          [-rel_t[1], rel_t[0], 0.0]])
    Jinv = np.linalg.pinv(J)
    return rel, Jinv.T @ W_X @ Jinv


def after_step(sysd: Dict[str, Tensor], state, out):
    """The system after one stepped frame (`state` the step's new state,
    `out` its outputs): the keyframe pushed into the ring when the step
    saved one, the frame logged. Returns (system, {out.sys.meas.*})."""
    nav = out.nav
    dt = state.Vel.dtype
    host = torch.cat([
        out.kf_saved.to(dt).reshape(1), out.kf_id.to(dt).reshape(1),
        nav.scale.reshape(1), nav.Rot.reshape(-1), state.Vel, nav.RotLie,
        nav.g, out.W_X.reshape(-1)]).cpu().numpy().astype(np.float64)
    saved, kf_id, scale = bool(host[0] > 0), int(host[1]), float(host[2])
    rot, vel, rot_lie = host[3:12].reshape(3, 3), host[12:15], host[15:18]
    g, W_X = host[18:21], host[21:57].reshape(6, 6)
    new = dict(sysd)
    if saved:
        slot = int(sysd["sys.kf.next_slot"][0])
        vals = dict(zip(_STORE, (state.t, state.K_scale, state.Pose,
                                 state.Pos, state.Vel)))
        vals.update({f"klm.{k}": v for k, v in state.klm._asdict().items()})
        for name, v in vals.items():
            key = f"sys.kf.{name}"
            buf = sysd[key].clone()
            buf[0, slot] = v.detach().cpu().to(buf.dtype).reshape(
                buf.shape[2:])
            new[key] = buf
        valid = sysd["sys.kf.valid"].clone()
        valid[0, slot] = True
        new["sys.kf.valid"] = valid
        new["sys.kf.next_slot"] = (sysd["sys.kf.next_slot"] + 1) % KF_SLOTS
        new["sys.kf.count"] = torch.clamp(sysd["sys.kf.count"] + 1,
                                          max=KF_SLOTS)
    rel, W = transported_meas(rot, vel, rot_lie, W_X)
    for k in ("sys.log.n", "sys.logger.n", "sys.frames"):
        new[k] = sysd[k] + 1
    meas = {"out.sys.meas.rel_pose": torch.from_numpy(rel),
            "out.sys.meas.W": torch.from_numpy(W),
            "out.sys.meas.g_est": torch.from_numpy(g),
            "out.sys.meas.K": torch.tensor(scale, dtype=torch.float64),
            "out.sys.meas.kf_id": torch.tensor(kf_id, dtype=torch.int64)}
    return new, meas
