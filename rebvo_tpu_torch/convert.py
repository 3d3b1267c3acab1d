"""Carry parameters and VO state between the JAX package and the port.

This system has no weights; what a run carries is its parameters and
its state. With these, both packages start from the same state and a
single step can be compared:

    p_t = params_from_jax(p)
    st_t = state_from_numpy(jax.tree_util.tree_map(np.asarray, st_jax))
    st_np = state_to_numpy(st_t)

`state_from_numpy` takes any nested NamedTuple (or dict) whose node names
and field names match the port's VOState (VOState, KeylineMap, ImuCarry,
ScaleWindows, KFCarry) and whose leaves are numpy arrays, so it never
needs the JAX package itself. `imu_window_from_numpy` does the same for
one IMU window (gyro, accel, count, tsample), so a JAX window and a port
window carry the same samples:

    win_t = imu_window_from_numpy(jax.tree_util.tree_map(np.asarray, win))

The system's records carry over the same way: `keyframe_store_from_numpy`
takes a numpy KeyframeStore tree, and `pose_log_from_jax` copies any
pose log whose measurements are dataclasses with OdometryMeas's fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rebvo_tpu_torch.backend.keyframe import KeyframeStore
from rebvo_tpu_torch.backend.posegraph import OdometryMeas, PoseGraphLog
from rebvo_tpu_torch.config import REBVOParameters
from rebvo_tpu_torch.frontend.imu import ImuWindow, ScaleWindows
from rebvo_tpu_torch.frontend.kf_tracking import KFCarry
from rebvo_tpu_torch.frontend.state import KeylineMap
from rebvo_tpu_torch.frontend.step import ImuCarry, VOState

# NamedTuple fields of the state tree that are themselves nodes
_NODES = {
    VOState: {"klm": KeylineMap, "imu": ImuCarry, "kf": KFCarry},
    ImuCarry: {"windows": ScaleWindows},
    KFCarry: {"klm": KeylineMap},
    KeyframeStore: {"klm": KeylineMap},
}


def params_from_jax(p) -> REBVOParameters:
    """A port REBVOParameters from the JAX package's (any dataclass with
    the same fields)."""
    return REBVOParameters(**dataclasses.asdict(p))


def _get(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _build(cls, tree, device):
    nodes = _NODES.get(cls, {})
    vals = {}
    for name in cls._fields:
        sub = _get(tree, name)
        if name in nodes:
            vals[name] = _build(nodes[name], sub, device)
        else:
            vals[name] = torch.as_tensor(np.array(sub)).to(device)
    return cls(**vals)


def state_from_numpy(tree, device="cuda") -> VOState:
    """A port VOState from a numpy state tree (see the module note)."""
    return _build(VOState, tree, device)


def imu_window_from_numpy(tree, device="cuda") -> ImuWindow:
    """A port ImuWindow from a numpy window (see the module note)."""
    return _build(ImuWindow, tree, device)


def keyframe_store_from_numpy(tree, device="cuda") -> KeyframeStore:
    """A port KeyframeStore from a numpy keyframe-store tree."""
    return _build(KeyframeStore, tree, device)


def pose_log_from_jax(log) -> PoseGraphLog:
    """A port PoseGraphLog with the same measurements (copies)."""
    return PoseGraphLog(meas=[OdometryMeas(**dataclasses.asdict(m))
                              for m in log.meas])


def state_to_numpy(state):
    """The same NamedTuple structure with numpy leaves (host copies)."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    return type(state)(*[state_to_numpy(v) for v in state])
