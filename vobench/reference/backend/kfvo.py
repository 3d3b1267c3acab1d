"""Keyframe-relative VO toolkit (PyTorch counterpart of
rebvo_tpu/backend/kfvo.py; reference src/mtracklib/kfvo.cpp): relative
poses, SE(3) transport of an edge map, keyframe-to-frame alignment, and
the keyframe map refinement (depth EKF through the frame, the
depth-gauge ratio, the round-trip match filter, match and
field-of-view counts). The match-chain heuristics of kfvo.cpp:790-1041
are superseded by the Schur BA in backend/ba.py.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from vobench.reference.core.geometry import rotate_gradients, so3_exp
from vobench.reference.core.numerics import matmul, sum64
from vobench.reference.frontend.state import RHO_MAX, RHO_MIN, KeylineMap
from vobench.reference.kernels.depth_filter import depth_ekf
from vobench.reference.kernels.pose_solver import FieldView, minimizer_rv

Tensor = torch.Tensor


def relative_pose(Pose_a: Tensor, Pos_a: Tensor, Pose_b: Tensor,
                  Pos_b: Tensor):
    """(R, t) mapping frame-a camera points into frame b (X_b = R X_a + t)
    from the global camera-to-world poses."""
    R = matmul(Pose_b.T, Pose_a)
    t = matmul(Pose_b.T, Pos_a - Pos_b)
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
    return KFAlignResult(R=matmul(dR, R_prior), t=matmul(dR, t_prior) + res.Vel,
                         Vel=res.Vel, W0=res.W0, m_id_f=res.m_id_f,
                         score=res.score, RVel=res.RVel, RW0=res.RW0)


def refine_keyframe_depths(kf_klm: KeylineMap, R: Tensor, t: Tensor,
                           vel_equiv: Tensor, zfm: float, *,
                           reshape_q_abs: float = 1e-4,
                           loc_uncertainty: float = 1.0) -> KeylineMap:
    """EKF-refine the keyframe's inverse depths from current-frame
    matches (mapKFUsingIDK role, kfvo.cpp:1147-1360): transform to the
    frame, run the batched scalar EKF, transform back. Only the depth
    statistics return; positions and gradients stay the keyframe's.

    The caller first sets the matched measurement fields (px/py the
    observed frame positions, p0 the predicted ones) as the front end's
    matching stage does."""
    fwd = transform_map(kf_klm, R, t, zfm)
    upd = depth_ekf(fwd, vel_equiv, zfm, reshape_q_abs=reshape_q_abs,
                    loc_uncertainty=loc_uncertainty)
    back = transform_map(upd, R.T, -matmul(R.T, t), zfm)
    return kf_klm._replace(rho=back.rho, s_rho=back.s_rho,
                           rho0=back.rho0, s_rho0=back.s_rho0)


def _proj_inv_depth(px: Tensor, py: Tensor, rho: Tensor, R: Tensor,
                    t: Tensor, zfm: float, pre_scale=1.0) -> Tensor:
    """Inverse depth of each keyline after SE(3) transport into the
    partner frame (the q1[2] of kfvo.h:42-81's unProject/project pair);
    -1 marks a point behind the camera."""
    rho_c = torch.clamp(rho, RHO_MIN, RHO_MAX)
    z = pre_scale / rho_c
    X = px * z / zfm
    Y = py * z / zfm
    Pz = R[2, 0] * X + R[2, 1] * Y + R[2, 2] * z + t[2]
    return torch.where(Pz > 1e-9, 1.0 / torch.clamp(Pz, min=1e-9),
                       torch.full_like(Pz, -1.0))


def optimize_scale(klm: KeylineMap, kf_klm: KeylineMap, m_id: Tensor,
                   R: Tensor, t: Tensor, zfm: float, *, mode: str = "fwd",
                   pre_scale=1.0, init=1.0) -> Tuple[Tensor, Tensor]:
    """Information-weighted depth-gauge ratio between a frame map and a
    keyframe map (optimizeScale / optimizeScaleF2KF / optimizeScaleBack,
    kfvo.cpp:222-330), batched. Frame keylines go into the keyframe
    camera by (R, t); their inverse depths q1z meet the matched keyframe
    depths rho_b under per-pair information weights:

      "fwd":  v = s^2 + s_b^2;  Kr = sum(q1z^2/v) / sum(q1z rho_b/v)
      "f2kf": v = s^2 (q1z/rho)^2 + s_b^2;
              Kr = sum(rho_b^2/v) / sum(q1z^2/v)
      "back": v = (s q1z/rho init)^2 + s_b^2 (the caller swaps roles and
              passes the frame gauge as `pre_scale`, the KF's as `init`);
              Kr = sum(q1z rho_b/v) / sum(q1z^2/v)

    Returns (Kr, weight): the weight is the denominator sum (W_Kp for
    "f2kf"); 0 means no usable pair, and Kr then falls back to 1 (to
    `init` for "back"), as the reference's guards do."""
    ok = klm.valid & (m_id >= 0)
    ms = torch.clamp(m_id, min=0).long()
    rho_b = kf_klm.rho[ms]
    s_b = kf_klm.s_rho[ms]
    q1z = _proj_inv_depth(klm.px, klm.py, klm.rho, R, t, zfm,
                          pre_scale=pre_scale)
    ok = ok & (q1z > 0)
    rho_c = torch.clamp(klm.rho, RHO_MIN, RHO_MAX)
    if mode == "fwd":
        v = klm.s_rho ** 2 + s_b ** 2
        num = q1z * q1z / v
        den = q1z * rho_b / v
        fallback = 1.0
    elif mode == "f2kf":
        v = (klm.s_rho * q1z / rho_c) ** 2 + s_b ** 2
        den = q1z * q1z / v
        num = rho_b * rho_b / v
        fallback = 1.0
    elif mode == "back":
        v = (klm.s_rho * q1z / rho_c * init) ** 2 + s_b ** 2
        num = q1z * rho_b / v
        den = q1z * q1z / v
        fallback = init
    else:
        raise ValueError(mode)
    zero = torch.zeros_like(num)
    num_s = sum64(torch.where(ok, num, zero))
    den_s = sum64(torch.where(ok, den, zero))
    good = (num_s > 0) & (den_s > 0)
    fb = torch.as_tensor(fallback, dtype=q1z.dtype, device=q1z.device)
    Kr = torch.where(good, num_s / torch.where(good, den_s,
                                               torch.ones_like(den_s)), fb)
    return Kr, den_s


def mutual_exclusion(m_fwd: Tensor, valid: Tensor, m_back: Tensor,
                     px: Tensor, py: Tensor, ux: Tensor, uy: Tensor, *,
                     dist_thresh: float, discard_non_mutual: bool = True,
                     along_normal: bool = False
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Round-trip match filter (mutualExclusionSimple, kfvo.cpp:423-525):
    a forward match whose partner's back match lands farther than
    `dist_thresh` from the keyline (euclidean, or along the keyline
    normal with `along_normal`), or that has no back match while
    `discard_non_mutual`, is cleared.

    Returns (filtered m_fwd, matches checked, mutual survivors)."""
    has = valid & (m_fwd >= 0)
    mb = m_back[torch.clamp(m_fwd, min=0).long()]
    mb_ok = mb >= 0
    mbs = torch.clamp(mb, min=0).long()
    dx = px - px[mbs]
    dy = py - py[mbs]
    if along_normal:
        d = torch.abs(dx * ux + dy * uy)
    else:
        d = torch.sqrt(dx * dx + dy * dy)
    far = mb_ok & (d > dist_thresh)
    drop = has & (far | ((~mb_ok) & discard_non_mutual))
    keep = has & mb_ok & ~far
    out = torch.where(drop, torch.full_like(m_fwd, -1), m_fwd)
    return (out, torch.sum(has).to(torch.int32),
            torch.sum(keep).to(torch.int32))


def count_kf_matches(klm: KeylineMap) -> Tensor:
    """countMatches role (kfvo.cpp:18-55)."""
    return torch.sum(klm.valid & (klm.m_id_kf >= 0)).to(torch.int32)


def keylines_in_fov(klm: KeylineMap, R: Tensor, t: Tensor, zfm: float,
                    cx: float, cy: float, width: int, height: int) -> Tensor:
    """kls_on_fov role (kfvo.cpp:688-712): how many keylines project
    inside the target frame."""
    m = transform_map(klm, R, t, zfm)
    x = m.px + cx
    y = m.py + cy
    inside = (klm.valid & (x >= 0) & (x < width) & (y >= 0) & (y < height)
              & (m.rho > 0))
    return torch.sum(inside).to(torch.int32)
