"""State containers for the VO front end (PyTorch counterpart of
rebvo_tpu/frontend/state.py).

The reference keeps keylines as an array-of-structs sized KEYLINE_MAX
with a live count (include/mtracklib/edge_finder.h:45-91); here, as in
the JAX package, they are a fixed-size structure-of-arrays with a
validity mask, so every per-keyline stage is a masked vectorised op.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

# Inverse-depth limits and init point (edge_finder.h:38-43).
RHO_MAX = 20.0
RHO_MIN = 1e-3
RHO_INIT = 1.0

# f32-safe stand-in for the reference's 1e50 "infinite variance" priors.
BIG = 1e18


class KeylineMap(NamedTuple):
    """Fixed-size masked SoA of keylines; every tensor has shape [..., K].
    Field meanings as in rebvo_tpu/frontend/state.py."""

    valid: Tensor    # bool
    x: Tensor        # subpixel image coords (KeyLine::c_p)
    y: Tensor
    gx: Tensor       # DoG gradient (KeyLine::m_m)
    gy: Tensor
    n_m: Tensor      # |m_m|
    ux: Tensor       # m_m / n_m
    uy: Tensor
    px: Tensor       # homogeneous coords (KeyLine::p_m)
    py: Tensor
    p0x: Tensor      # matched keyline's hom coords
    p0y: Tensor
    g0x: Tensor      # matched keyline's gradient
    g0y: Tensor
    n_m0: Tensor
    rho: Tensor      # inverse depth
    s_rho: Tensor
    rho0: Tensor     # EKF-predicted inverse depth
    s_rho0: Tensor
    m_num: Tensor    # int32 consecutive-match count
    m_id: Tensor     # int32 backward match id (-1 = none)
    m_id_f: Tensor   # int32 forward match id
    m_id_kf: Tensor  # int32 match id in the last keyframe
    p_id: Tensor     # int32 previous keyline on the edge chain
    n_id: Tensor     # int32 next keyline on the chain
    anchored: Tensor  # bool, stereo only (False in mono)
    rho_st: Tensor
    ax: Tensor
    ay: Tensor
    arho: Tensor

    @property
    def K(self) -> int:
        return self.valid.shape[-1]

    @property
    def count(self) -> Tensor:
        return torch.sum(self.valid, dim=-1).to(torch.int32)

    @staticmethod
    def empty(K: int, dtype=torch.float32, batch_shape=(),
              device="cuda") -> "KeylineMap":
        shape = tuple(batch_shape) + (K,)

        def f(fill=0.0):
            return torch.full(shape, fill, dtype=dtype, device=device)

        def i(fill=-1):
            return torch.full(shape, fill, dtype=torch.int32, device=device)

        def b():
            return torch.zeros(shape, dtype=torch.bool, device=device)

        return KeylineMap(
            valid=b(),
            x=f(), y=f(), gx=f(), gy=f(), n_m=f(1.0), ux=f(), uy=f(),
            px=f(), py=f(), p0x=f(), p0y=f(), g0x=f(), g0y=f(), n_m0=f(1.0),
            rho=f(RHO_INIT), s_rho=f(RHO_MAX), rho0=f(RHO_INIT),
            s_rho0=f(RHO_MAX),
            m_num=i(0), m_id=i(), m_id_f=i(), m_id_kf=i(), p_id=i(), n_id=i(),
            anchored=b(),
            rho_st=f(0.0), ax=f(0.0), ay=f(0.0), arho=f(0.0),
        )


def keylines_to_host(klm: KeylineMap, fields, extra=()) -> dict:
    """The named fields of a KeylineMap as numpy arrays, and any `extra`
    values flattened into one float32 array under "extra". Tensors move to
    the host in one transfer: every field rides in one float32 buffer, the
    integer ones bit for bit in a float32 view, the booleans as 0/1. numpy
    fields are copied."""
    if not isinstance(klm.valid, Tensor):
        out = {f: np.array(getattr(klm, f)) for f in fields}
        out["extra"] = np.concatenate(
            [np.asarray(e, np.float32).reshape(-1) for e in extra]) \
            if extra else np.zeros(0, np.float32)
        return out
    parts = [getattr(klm, f) for f in fields]
    K = klm.valid.shape[-1]
    dev = klm.valid.device

    def as_f32(t):
        if t.dtype == torch.bool:
            return t.to(torch.float32)
        if t.is_floating_point():
            return t.to(torch.float32)
        return t.to(torch.int32).view(torch.float32)

    host = torch.cat([as_f32(t).reshape(-1) for t in parts] + [
        torch.as_tensor(e, dtype=torch.float32, device=dev).reshape(-1)
        for e in extra]).cpu().numpy()
    out = {}
    for i, (f, t) in enumerate(zip(fields, parts)):
        a = host[i * K:(i + 1) * K]
        out[f] = (a != 0 if t.dtype == torch.bool else
                  a if t.is_floating_point() else a.view(np.int32))
    out["extra"] = host[len(parts) * K:]
    return out


def select_map(cond: Tensor, a: KeylineMap, b: KeylineMap) -> KeylineMap:
    """Field-wise where(cond, a, b) (the reference's tree_map of where)."""
    return KeylineMap(*[torch.where(cond, x, y) for x, y in zip(a, b)])


class NavData(NamedTuple):
    """Per-frame navigation output (reference rebvo.h:292-308)."""

    t: Tensor
    dt: Tensor
    Rot: Tensor        # frame-to-frame rotation (backward)
    RotLie: Tensor
    Vel: Tensor        # scaled velocity estimate (-V*K/dt)
    Pose: Tensor       # global rotation [3,3]
    PoseLie: Tensor
    Pos: Tensor        # global position [3]
    g: Tensor          # gravity estimate in camera frame
    scale: Tensor      # visual-to-metric scale K
    estimation_ok: Tensor
    kl_num: Tensor     # detected keylines this frame
    klm_num: Tensor    # matched keylines this frame
