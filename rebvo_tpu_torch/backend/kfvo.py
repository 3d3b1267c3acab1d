"""Keyframe-relative VO toolkit (PyTorch counterpart of the part of
rebvo_tpu/backend/kfvo.py that the online keyframe tracker uses;
reference src/mtracklib/kfvo.cpp): relative poses, SE(3) transport of an
edge map, and keyframe-to-frame alignment. The offline refinement
(refine_keyframe_depths, optimize_scale, ...) waits for the backend
slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rebvo_tpu_torch.core.geometry import rotate_gradients, so3_exp
from rebvo_tpu_torch.frontend.state import RHO_MAX, RHO_MIN, KeylineMap
from rebvo_tpu_torch.kernels.pose_solver import FieldView, minimizer_rv

Tensor = torch.Tensor


def relative_pose(Pose_a: Tensor, Pos_a: Tensor, Pose_b: Tensor,
                  Pos_b: Tensor):
    """(R, t) mapping frame-a camera points into frame b (X_b = R X_a + t)
    from the global camera-to-world poses."""
    R = Pose_b.T @ Pose_a
    t = Pose_b.T @ (Pos_a - Pos_b)
    return R, t


def transform_map(klm: KeylineMap, R: Tensor, t: Tensor, zfm: float,
                  scale: Tensor = None) -> KeylineMap:
    """SE(3) transform of an edge map's geometry (translateDepth_*,
    kfvo.cpp:607-686, generalised); `scale` first rescales the source
    map's depth gauge."""
    rho = klm.rho
    s_rho = klm.s_rho
    if scale is not None:
        rho = rho / scale
        s_rho = s_rho / scale
    rho_c = torch.clamp(rho, RHO_MIN, RHO_MAX)
    z = 1.0 / rho_c
    X = klm.px * z / zfm
    Y = klm.py * z / zfm
    Px = R[0, 0] * X + R[0, 1] * Y + R[0, 2] * z + t[0]
    Py = R[1, 0] * X + R[1, 1] * Y + R[1, 2] * z + t[1]
    Pz = R[2, 0] * X + R[2, 1] * Y + R[2, 2] * z + t[2]
    ok = torch.abs(Pz) > 1e-6
    Pz_s = torch.where(ok, Pz, torch.ones_like(Pz))
    px2 = torch.where(ok, Px * zfm / Pz_s, klm.px)
    py2 = torch.where(ok, Py * zfm / Pz_s, klm.py)
    rho2 = torch.where(ok, 1.0 / Pz_s, rho)
    # first-order uncertainty transport: s' ~ s * (rho'/rho)
    s2 = torch.where(ok, s_rho * torch.abs(rho2 / rho_c), s_rho)
    gx2, gy2 = rotate_gradients(R, klm.gx, klm.gy)
    return klm._replace(px=px2, py=py2, rho=rho2, s_rho=s2, gx=gx2, gy=gy2)


class KFAlignResult(NamedTuple):
    R: Tensor      # refined rotation (kf -> frame)
    t: Tensor      # refined translation
    Vel: Tensor    # minimiser increment
    W0: Tensor
    m_id_f: Tensor
    score: Tensor
    RVel: Tensor   # [3,3] covariance of the translation increment
    RW0: Tensor    # [3,3] covariance of the rotation increment


def align_to_keyframe(kf_klm: KeylineMap, frame_fv: FieldView,
                      R_prior: Tensor, t_prior: Tensor, *, zfm: float,
                      cx: float, cy: float, width: int, height: int,
                      max_s_rho: Tensor, match_thresh: float = 0.5,
                      k_huber: float = 2.0, iter_max: int = 5,
                      init_iter: int = 2) -> KFAlignResult:
    """Refine the keyframe->frame pose by edge alignment against the
    current frame's match field (Minimizer_RV_KF role, kfvo.cpp:1677):
    the keyframe map is pre-transformed by the prior and the residual
    rototranslation is composed back."""
    pre = transform_map(kf_klm, R_prior, t_prior, zfm)
    z3 = torch.zeros(3, dtype=kf_klm.px.dtype, device=kf_klm.px.device)
    res = minimizer_rv(
        z3, z3, pre, frame_fv, zfm=zfm, cx=cx, cy=cy, width=width,
        height=height, match_thresh=match_thresh, max_s_rho=max_s_rho,
        match_num_min=torch.zeros((), dtype=torch.int32,
                                  device=kf_klm.px.device),
        k_huber=k_huber, iter_max=iter_max, init_iter=init_iter,
        init_type=2)
    dR = so3_exp(res.W0)
    return KFAlignResult(R=dR @ R_prior, t=dR @ t_prior + res.Vel,
                         Vel=res.Vel, W0=res.W0, m_id_f=res.m_id_f,
                         score=res.score, RVel=res.RVel, RW0=res.RW0)
