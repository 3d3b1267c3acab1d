"""Keyframe store (PyTorch counterpart of rebvo_tpu/backend/keyframe.py;
reference keyframe, include/mtracklib/keyframe.h:33-118 and
keyframe.cpp:73-169).

Keyframes live as a fixed-capacity ring of stacked keyline SoAs on the
system's device, the slot the leading axis of every tensor. A push
writes one slot in place. The `.npz` snapshot has the JAX package's
keys, shapes and dtypes, so either package reads the other's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rebvo_tpu_torch.frontend.state import KeylineMap

Tensor = torch.Tensor


class KeyframeStore(NamedTuple):
    """Ring buffer of keyframes; all tensors lead with the slot axis [F]."""

    valid: Tensor      # [F] bool
    t: Tensor          # [F]
    K_scale: Tensor    # [F] scale at capture
    Pose: Tensor       # [F, 3, 3] global rotation at capture
    Pos: Tensor        # [F, 3] global position at capture
    Vel: Tensor        # [F, 3]
    klm: KeylineMap    # leaves [F, K]
    next_slot: Tensor  # int32 ring cursor
    count: Tensor      # int32 number of live keyframes

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    @staticmethod
    def empty(F: int, K: int, dtype=torch.float32,
              device="cuda") -> "KeyframeStore":
        kw = dict(dtype=dtype, device=device)
        return KeyframeStore(
            valid=torch.zeros((F,), dtype=torch.bool, device=device),
            t=torch.zeros((F,), **kw),
            K_scale=torch.ones((F,), **kw),
            Pose=torch.eye(3, **kw).repeat(F, 1, 1),
            Pos=torch.zeros((F, 3), **kw),
            Vel=torch.zeros((F, 3), **kw),
            klm=KeylineMap.empty(K, dtype=dtype, batch_shape=(F,),
                                 device=device),
            next_slot=torch.zeros((), dtype=torch.int32, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device))


def push_keyframe(store: KeyframeStore, klm: KeylineMap, t: Tensor,
                  K_scale: Tensor, Pose: Tensor, Pos: Tensor,
                  Vel: Tensor) -> KeyframeStore:
    """Write a keyframe into the slot at the ring cursor, in place (no
    host sync); returns the store."""
    idx = store.next_slot.to(torch.int64).reshape(1)
    for buf, val in zip((store.t, store.K_scale, store.Pose, store.Pos,
                         store.Vel) + tuple(store.klm),
                        (t, K_scale, Pose, Pos, Vel) + tuple(klm)):
        buf.index_copy_(0, idx, val.to(buf.dtype).reshape((1,) +
                                                         buf.shape[1:]))
    store.valid.index_fill_(0, idx, True)
    store.next_slot.copy_((store.next_slot + 1) % store.capacity)
    store.count.copy_(torch.clamp(store.count + 1, max=store.capacity))
    return store


def save_keyframes(path: str, store: KeyframeStore) -> None:
    """Serialise to npz (the analogue of the reference's kf_list.kf,
    keyframe.cpp:129-169), with the JAX package's keys."""
    flat = {name: getattr(store, name).detach().cpu().numpy()
            for name in ("valid", "t", "K_scale", "Pose", "Pos", "Vel",
                         "next_slot", "count")}
    for name, arr in store.klm._asdict().items():
        flat[f"klm_{name}"] = arr.detach().cpu().numpy()
    np.savez_compressed(path, **flat)


def load_keyframes(path: str, device="cuda") -> KeyframeStore:
    """Read a store written by either package; a KeylineMap field the
    file lacks loads as its `empty()` default."""
    z = np.load(path)
    n_kf, K = z["klm_valid"].shape
    defaults = KeylineMap.empty(K, batch_shape=(n_kf,), device=device)

    def dev(a):
        return torch.as_tensor(np.array(a)).to(device)

    klm = KeylineMap(**{
        name: (dev(z[f"klm_{name}"]) if f"klm_{name}" in z.files
               else getattr(defaults, name))
        for name in KeylineMap._fields})
    return KeyframeStore(
        valid=dev(z["valid"]), t=dev(z["t"]), K_scale=dev(z["K_scale"]),
        Pose=dev(z["Pose"]), Pos=dev(z["Pos"]), Vel=dev(z["Vel"]), klm=klm,
        next_slot=dev(z["next_slot"]), count=dev(z["count"]))
