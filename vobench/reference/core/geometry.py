"""Geometry primitives: SO(3), pinhole camera with radial-tangential
distortion, batched keyline-coordinate transforms.

PyTorch counterpart of rebvo_tpu/core/geometry.py (the reference's TooN
usage and `cam_model`, include/UtilLib/cam_model.h:33-180): plain
functions on tensors that batch over leading / keyline axes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vobench.reference.core.numerics import matmul

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------


def skew(w: Tensor) -> Tensor:
    """Cross-product matrix [w]x (reference toon_util.h:93)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: Tensor) -> Tensor:
    """Rodrigues' formula, Taylor-safe near zero (replaces TooN::SO3).
    Evaluated in float64 and rounded once to w's dtype: sin and cos
    differ by an ulp between the card and the CPU in float32
    (core/numerics' module note)."""
    dt = w.dtype
    w = w.double()
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-12
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return (eye + a[..., None, None] * K +
            b[..., None, None] * matmul(K, K)).to(dt)


def so3_log(R: Tensor) -> Tensor:
    """Logarithm map of a rotation matrix -> axis-angle vector, robust
    near 0 and near pi (the reference relies on TooN::SO3::ln())."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = torch.sin(theta)
    small = theta < 1e-6
    one = torch.ones_like(theta)
    scale_small = 0.5 + theta * theta / 12.0
    scale = torch.where(small, scale_small,
                        theta / torch.where(small, one, 2.0 * sin_t))
    w_generic = v * scale[..., None]

    # Near pi: the axis from the diagonal, signs from the symmetric part.
    near_pi = theta > math.pi - 1e-3
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    omc = 1.0 - cos_t[..., None]
    axis2 = torch.clamp(
        (diag - cos_t[..., None])
        / torch.where(torch.abs(omc) < 1e-12, torch.ones_like(omc), omc),
        min=0.0)
    axis_abs = torch.sqrt(axis2)
    sx = torch.sign(torch.where(torch.abs(v[..., 0]) > 1e-9, v[..., 0], one))
    sy = torch.sign(R[..., 0, 1] + R[..., 1, 0]) * sx
    sz = torch.sign(R[..., 0, 2] + R[..., 2, 0]) * sx
    axis = axis_abs * torch.stack([sx, sy, sz], dim=-1)
    nrm = torch.linalg.norm(axis, dim=-1, keepdim=True)
    axis = axis / torch.where(nrm < 1e-12, torch.ones_like(nrm), nrm)
    w_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def rotation_to_quaternion(R: Tensor) -> Tensor:
    """Rotation matrix -> quaternion (x, y, z, w), TUM trajectory order."""
    w = so3_log(R)
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)
    axis = w / torch.where(theta < 1e-12, torch.ones_like(theta), theta)
    half = 0.5 * theta
    xyz = axis * torch.sin(half)
    qw = torch.cos(half)[..., 0]
    return torch.cat([xyz, qw[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# Camera model
# ---------------------------------------------------------------------------


class CameraModel(NamedTuple):
    """Pinhole camera with radial-tangential distortion (cam_model.h:33).

    `zfm` is the mean focal length used by all VO math; homogeneous
    ("Hom") coordinates are principal-point-subtracted pixel coordinates
    on the zfm focal plane. Every field is a Python number, so the step
    carries no device constants for them."""

    fx: float
    fy: float
    cx: float
    cy: float
    zfm: float
    kc2: float
    kc4: float
    kc6: float
    p1: float
    p2: float
    width: int
    height: int

    @staticmethod
    def make(fx, fy, cx, cy, kc2=0.0, kc4=0.0, kc6=0.0, p1=0.0, p2=0.0,
             width=752, height=480) -> "CameraModel":
        c = float
        return CameraModel(
            fx=c(fx), fy=c(fy), cx=c(cx), cy=c(cy),
            zfm=c(0.5 * (float(fx) + float(fy))),
            kc2=c(kc2), kc4=c(kc4), kc6=c(kc6), p1=c(p1), p2=c(p2),
            width=int(width), height=int(height),
        )

    @staticmethod
    def from_params(params, stereo: bool = False) -> "CameraModel":
        if stereo:
            return CameraModel.make(
                params.StereoZfX, params.StereoZfY, params.StereoPPx,
                params.StereoPPy, params.StereoKcR2, params.StereoKcR4,
                params.StereoKcR6, params.StereoKcP1, params.StereoKcP2,
                params.ImageWidth, params.ImageHeight)
        return CameraModel.make(
            params.ZfX, params.ZfY, params.PPx, params.PPy,
            params.KcR2, params.KcR4, params.KcR6, params.KcP1, params.KcP2,
            params.ImageWidth, params.ImageHeight)

    def hom_to_img(self, hx: Tensor, hy: Tensor):
        return hx + self.cx, hy + self.cy

    def img_to_hom(self, ix: Tensor, iy: Tensor):
        return ix - self.cx, iy - self.cy

    def distort_hom(self, hx: Tensor, hy: Tensor):
        """Ideal hom coords -> distorted hom coords (distortHom2Hom)."""
        xp = hx / self.zfm
        yp = hy / self.zfm
        r2 = xp * xp + yp * yp
        radial = 1.0 + r2 * (self.kc2 + r2 * (self.kc4 + r2 * self.kc6))
        xpp = xp * radial + 2.0 * self.p1 * xp * yp + \
            self.p2 * (r2 + 2.0 * xp * xp)
        ypp = yp * radial + self.p1 * (r2 + 2.0 * yp * yp) + \
            2.0 * self.p2 * xp * yp
        return xpp * self.fx, ypp * self.fy

    def undistort_hom(self, hx: Tensor, hy: Tensor, newton_iters: int = 5):
        """Distorted hom coords -> ideal hom coords via Newton on the
        radial model (undistortHom2Hom, cam_model.h:57-73)."""
        rd = torch.sqrt((hx / self.fx) ** 2 + (hy / self.fy) ** 2)
        rn = rd
        for _ in range(newton_iters):
            f = rn * (1.0 + rn * rn * (self.kc2 + self.kc4 * rn * rn)) - rd
            df = 1.0 + rn * rn * (3.0 * self.kc2 + 5.0 * self.kc4 * rn * rn)
            rn = rn - f / df
        ok = rd > 1e-12
        scale = torch.where(ok, rn / torch.where(ok, rd, torch.ones_like(rd)),
                            torch.ones_like(rd))
        return hx * scale * self.zfm / self.fx, hy * scale * self.zfm / self.fy

    def unproject_i3p(self, px: Tensor, py: Tensor, rho: Tensor):
        """(hom x, hom y, inverse depth) -> 3D point
        (Ne10::ProyI3Pto3PMatrix, ne10wrapper.h:415-425)."""
        z = 1.0 / rho
        return px * z / self.zfm, py * z / self.zfm, z

    def project_i3p(self, X: Tensor, Y: Tensor, Z: Tensor):
        """3D point -> (hom x, hom y, inverse depth)
        (Ne10::ProyP3toI3PMatrix, ne10wrapper.h:430-447)."""
        rho = 1.0 / Z
        return X * self.zfm * rho, Y * self.zfm * rho, rho


# ---------------------------------------------------------------------------
# Batched keyline transforms
# ---------------------------------------------------------------------------


def rotate_hom_points(R: Tensor, px: Tensor, py: Tensor, rho: Tensor,
                      s_rho: Tensor, zfm: float):
    """Rotate homogeneous keyline positions + inverse depth by R
    (edge_tracker::rotate_keylines, edge_tracker.cpp:42-76)."""
    qx = R[0, 0] * px / zfm + R[0, 1] * py / zfm + R[0, 2]
    qy = R[1, 0] * px / zfm + R[1, 1] * py / zfm + R[1, 2]
    qz = R[2, 0] * px / zfm + R[2, 1] * py / zfm + R[2, 2]
    ok = torch.abs(qz) > 0
    safe_qz = torch.where(ok, qz, torch.ones_like(qz))
    px2 = torch.where(ok, qx / safe_qz * zfm, px)
    py2 = torch.where(ok, qy / safe_qz * zfm, py)
    rho2 = torch.where(ok, rho / safe_qz, rho)
    s_rho2 = torch.where(ok, s_rho / safe_qz, s_rho)
    return px2, py2, rho2, s_rho2


def rotate_gradients(R: Tensor, gx: Tensor, gy: Tensor):
    """(gx', gy') = (R @ (gx, gy, 0)).xy (edge_tracker.cpp:66-71)."""
    gx2 = R[0, 0] * gx + R[0, 1] * gy
    gy2 = R[1, 0] * gx + R[1, 1] * gy
    return gx2, gy2
