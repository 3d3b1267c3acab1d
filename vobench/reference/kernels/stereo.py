"""Stereo keyline matching and depth (PyTorch counterpart of
rebvo_tpu/kernels/stereo.py; reference edge_tracker's stereo path,
src/mtracklib/edge_tracker.cpp:453-688).

* `directed_matching_stereo` — the epipolar search of each cam0 keyline
  along its projected depth-range segment in the cam1 id mask, as an
  integer ladder [K, max_steps]; `top_k` shortlists the first 16 hits,
  the attribute tests run on them, two accepted candidates further apart
  than the location uncertainty void the match, else the last accepted
  one wins;
* `stereo_depth` — the closed-form inverse depth of a matched pair;
* `fuse_stereo_depth` — information-weighted fusion with the mono EKF;
* `velocity_scale_refine` / `anchor_scale_measure` — the pair-anchored
  translation-scale observers of the stereo step (beyond the reference).

Every division by a Python constant goes through `div_const`, so the
card divides as the CPU does; the 6x6 solve is `solve_ex` (no host
sync).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.core.numerics import div_const, matmul, round_int
from vobench.reference.core.stats import masked_median
from vobench.reference.frontend.state import (RHO_INIT, RHO_MAX, RHO_MIN,
                                            KeylineMap)
from vobench.reference.kernels.matching import _grad_ok, _shortlist

Tensor = torch.Tensor

HIT_CAP = 16             # shortlist slots along each stereo ladder


class StereoMatchResult(NamedTuple):
    klm: KeylineMap       # the cam0 map (queries)
    stereo_m_id: Tensor   # [K] match ids into the cam1 map (-1 = none)
    stereo_rho: Tensor    # [K] stereo inverse depth
    stereo_s_rho: Tensor  # [K]
    nmatch: Tensor


def _rot_rows(R: Tensor, x, y, z):
    """R @ (x, y, z) row by row, in the same order on every device."""
    return tuple(R[i, 0] * x + R[i, 1] * y + R[i, 2] * z for i in range(3))


def stereo_depth(px0, py0, ux1, uy1, pm1x, pm1y, R01, t01, zf0: float,
                 zf1: float, loc_uncertainty: float):
    """Closed-form inverse depth of a matched pair (getDepthFromStereo,
    edge_tracker.cpp:623-668). Returns (rho, I_rho)."""
    q0, q1, q2 = _rot_rows(R01, div_const(px0, zf0), div_const(py0, zf0),
                           torch.ones_like(px0))
    div = ux1 * (zf1 * t01[0] - pm1x * t01[2]) + \
        uy1 * (zf1 * t01[1] - pm1y * t01[2])
    mul = -ux1 * (zf1 * q0 - pm1x * q2) - uy1 * (zf1 * q1 - pm1y * q2)
    rho = mul / torch.where(torch.abs(div) > 1e-12, div,
                            torch.full_like(div, 1e-12))

    den = torch.square(q2 + t01[2] * rho)
    den = torch.where(den > 1e-12, den, torch.full_like(den, 1e-12))
    df = ux1 * zf1 * (t01[0] * (q2 + t01[2] * rho) -
                      t01[2] * (q0 + t01[0] * rho)) / den + \
        uy1 * zf1 * (t01[1] * (q2 + t01[2] * rho) -
                     t01[2] * (q1 + t01[1] * rho)) / den
    I_rho = torch.square(div_const(df, loc_uncertainty))
    bad = ~(torch.isfinite(rho) & torch.isfinite(df))
    rho = torch.where(bad, torch.ones_like(rho), rho)
    I_rho = torch.where(bad, torch.full_like(I_rho, 1e-10), I_rho)
    return rho, I_rho


def directed_matching_stereo(
        klm0: KeylineMap, klm1: KeylineMap, mask1: Tensor, t01: Tensor,
        R01: Tensor, *, zf0: float, zf1: float, cx1: float, cy1: float,
        width: int, height: int, max_steps: int, min_thr_mod: float,
        min_thr_ang: float, max_radius: float, loc_uncertainty: float,
        prior_window: bool = False) -> StereoMatchResult:
    """Match every cam0 keyline against the cam1 id mask `mask1` along
    its epipolar segment: the mono prior's +-sigma band when
    `prior_window` (the reference), else the full inverse-depth range
    (the JAX package's default; the ambiguity rejection guards it)."""
    dt = klm0.x.dtype
    dev = klm0.x.device

    if prior_window:
        min_rho = torch.clamp(klm0.rho - klm0.s_rho, RHO_MIN, RHO_MAX)
        max_rho = torch.clamp(klm0.rho + klm0.s_rho, RHO_MIN, RHO_MAX)
    else:
        min_rho = torch.full_like(klm0.rho, RHO_MIN)
        max_rho = torch.full_like(klm0.rho, RHO_MAX)

    def proj1(rho):
        z = 1.0 / rho
        Px, Py, Pz = _rot_rows(R01, div_const(klm0.px * z, zf0),
                               div_const(klm0.py * z, zf0), z)
        Px, Py, Pz = Px + t01[0], Py + t01[1], Pz + t01[2]
        Pz = torch.where(torch.abs(Pz) > 1e-9, Pz, torch.full_like(Pz, 1e-9))
        return Px * zf1 / Pz, Py * zf1 / Pz

    qminx, qminy = proj1(min_rho)
    qmaxx, qmaxy = proj1(max_rho)
    dqx = qmaxx - qminx
    dqy = qmaxy - qminy
    norm_t = torch.sqrt(dqx * dqx + dqy * dqy)
    moving = norm_t > 1e-6
    safe_n = torch.where(moving, norm_t, torch.ones_like(norm_t))
    tx = torch.where(moving, dqx / safe_n, klm0.gx / klm0.n_m)
    ty = torch.where(moving, dqy / safe_n, klm0.gy / klm0.n_m)
    dq_min = torch.where(moving, torch.full_like(norm_t, -loc_uncertainty),
                         torch.full_like(norm_t, -max_radius / 2
                                         - loc_uncertainty))
    dq_max = torch.where(moving,
                         torch.clamp(norm_t + loc_uncertainty,
                                     max=max_radius),
                         torch.full_like(norm_t, max_radius / 2
                                         + loc_uncertainty))
    pi0x = qminx + cx1
    pi0y = qminy + cy1

    # integer ladder t = dq_min .. dq_max (edge_tracker.cpp:553: int t)
    steps = torch.arange(max_steps, dtype=dt, device=dev)
    cand_t = torch.floor(dq_min)[:, None] + steps[None, :]
    cand_ok = (cand_t >= dq_min[:, None]) & (cand_t < dq_max[:, None]) & \
        klm0.valid[:, None]

    qx = round_int(tx[:, None] * cand_t + pi0x[:, None])
    qy = round_int(ty[:, None] * cand_t + pi0y[:, None])
    inb = (qx >= 0) & (qx < width) & (qy >= 0) & (qy < height)
    lin = torch.clamp(qy, 0, height - 1) * width + \
        torch.clamp(qx, 0, width - 1)
    j = mask1.reshape(-1)[lin]
    j = torch.where(cand_ok & inb, j, torch.full_like(j, -1))

    # shortlist of the first hits: the prior-free walk crosses up to
    # ~max_radius px of texture, so a second incompatible edge further
    # along can still void the match
    j_sel, _ = _shortlist(j, HIT_CAP)
    js = torch.clamp(j_sel, min=0)
    o_px, o_py = klm1.px[js], klm1.py[js]
    accept = (j_sel >= 0) & _grad_ok(klm0, klm1.gx[js], klm1.gy[js],
                                     klm1.n_m[js], min_thr_mod, min_thr_ang)

    # two-candidate ambiguity rejection (edge_tracker.cpp:594-603): any
    # two accepted candidates further apart than loc_uncertainty void
    # the match; otherwise the LAST accepted one wins
    big = torch.full_like(o_px, 1e9)
    minx = torch.amin(torch.where(accept, o_px, big), dim=-1)
    maxx = torch.amax(torch.where(accept, o_px, -big), dim=-1)
    miny = torch.amin(torch.where(accept, o_py, big), dim=-1)
    maxy = torch.amax(torch.where(accept, o_py, -big), dim=-1)
    spread2 = torch.square(maxx - minx) + torch.square(maxy - miny)
    any_acc = torch.any(accept, dim=-1)
    ambiguous = any_acc & (spread2 > loc_uncertainty * loc_uncertainty)

    # argmax over the flipped row: the first maximum, as jnp.argmax
    last = (HIT_CAP - 1) - torch.argmax(
        torch.flip(accept, dims=(-1,)).to(torch.int32), dim=-1)
    m_last = torch.gather(j_sel, -1, last[:, None])[:, 0]
    m_id = torch.where(any_acc & ~ambiguous, m_last,
                       torch.full_like(m_last, -1))
    ms = torch.clamp(m_id, min=0)

    # closed-form depth for the matched pairs
    rho_st, I_rho = stereo_depth(
        klm0.px, klm0.py, klm1.ux[ms], klm1.uy[ms], klm1.px[ms],
        klm1.py[ms], R01, t01, zf0, zf1, loc_uncertainty)
    s_st = torch.rsqrt(torch.clamp(I_rho, min=1e-12))
    neg = rho_st < 0
    m_id = torch.where(neg, torch.full_like(m_id, -1), m_id)
    rho_st = torch.where(neg | (m_id < 0), torch.full_like(rho_st, RHO_INIT),
                         rho_st)
    s_st = torch.where(neg, torch.full_like(s_st, 1e3),
                       torch.where(m_id < 0, torch.full_like(s_st, RHO_MAX),
                                   s_st))
    nmatch = torch.sum((m_id >= 0) & klm0.valid, dtype=torch.int32)
    return StereoMatchResult(klm=klm0, stereo_m_id=m_id, stereo_rho=rho_st,
                             stereo_s_rho=s_st, nmatch=nmatch)


def velocity_scale_refine(new: KeylineMap, old: KeylineMap, V: Tensor,
                          zfm: float, k_px: float = 1.0):
    """Per-frame translation-scale reading against the pair-anchored
    depths (see the JAX package): the median of b/a over the informative
    half of the directed-matching correspondences whose old keyline is
    anchored, one trim round at k_px. Returns (s, n_used); s = 1 when
    too few are used or s leaves (0.05, 50)."""
    j = new.m_id
    has = (j >= 0) & new.valid
    js = torch.clamp(j, min=0)
    # the pure pair-geometry depth, not the fused one
    rho = old.rho_st[js]
    use = has & old.anchored[js] & old.valid[js] & (rho > RHO_MIN)

    rho = torch.clamp(rho, min=RHO_MIN)
    Pz = 1.0 / rho
    q0x = old.px[js]
    q0y = old.py[js]
    Px = div_const(q0x * Pz, zfm)
    Py = div_const(q0y * Pz, zfm)
    tz = Pz + V[2]
    tz = torch.where(torch.abs(tz) > 1e-9, tz, torch.full_like(tz, 1e-9))
    qVx = (Px + V[0]) * zfm / tz
    qVy = (Py + V[1]) * zfm / tz
    a = (qVx - q0x) * new.ux + (qVy - q0y) * new.uy
    b = (new.px - q0x) * new.ux + (new.py - q0y) * new.uy

    abs_a = torch.abs(a)
    a_med = masked_median(abs_a, use, fallback=0.0)
    inform = use & (abs_a > torch.clamp(a_med, min=0.02))
    ratio = b / torch.where(abs_a > 1e-6, a, torch.ones_like(a))
    s = masked_median(ratio, inform)
    inl = inform & (torch.abs(b - s * a) <= k_px)
    s = masked_median(ratio, inl, fallback=1.0)
    n_used = torch.sum(inl, dtype=torch.int32)
    ok = (n_used > 20) & (s > 0.05) & (s < 50.0)
    return torch.where(ok, s, torch.ones_like(s)), n_used


def anchor_scale_measure(klm: KeylineMap, aR: Tensor, aV: Tensor, zfm: float,
                         k_px: float = 2.5):
    """Long-baseline translation-scale measurement against the keylines'
    scale anchors (KeylineMap.ax/ay/arho; see the JAX package): a 6-dof
    normal-projected PnP correction around the accumulated motion (aR,
    aV), 3 IRLS rounds of a 6x6 normal solve, of which only the
    translation-magnitude ratio |aV + dt| / |aV| is used. Returns
    (s, n_used, b_med); s = 1 when the solve is not excited enough."""
    dt = aV.dtype
    use = klm.valid & (klm.arho > RHO_MIN)
    rho = torch.clamp(klm.arho, min=RHO_MIN)
    Pz = 1.0 / rho
    Px = div_const(klm.ax * Pz, zfm)
    Py = div_const(klm.ay * Pz, zfm)
    r0x, r0y, r0z = _rot_rows(aR, Px, Py, Pz)
    z0 = torch.where(torch.abs(r0z) > 1e-9, r0z, torch.full_like(r0z, 1e-9))
    q0x = r0x * zfm / z0
    q0y = r0y * zfm / z0
    z1 = r0z + aV[2]
    z1 = torch.where(torch.abs(z1) > 1e-9, z1, torch.full_like(z1, 1e-9))
    q1x = (r0x + aV[0]) * zfm / z1
    q1y = (r0y + aV[1]) * zfm / z1

    a = (q1x - q0x) * klm.ux + (q1y - q0y) * klm.uy
    b = (klm.px - q0x) * klm.ux + (klm.py - q0y) * klm.uy

    jx_wx = div_const(-q0x * q0y, zfm)
    jx_wy = zfm + div_const(q0x * q0x, zfm)
    jx_wz = -q0y
    jy_wx = -(zfm + div_const(q0y * q0y, zfm))
    jy_wy = div_const(q0x * q0y, zfm)
    jy_wz = q0x
    # w columns scaled by 1/zf, t columns by the median inverse depth:
    # conditions the 6x6 normal system for float32
    c1 = div_const(jx_wx * klm.ux + jy_wx * klm.uy, zfm)
    c2 = div_const(jx_wy * klm.ux + jy_wy * klm.uy, zfm)
    c3 = div_const(jx_wz * klm.ux + jy_wz * klm.uy, zfm)
    invz = 1.0 / z1
    rho_med = masked_median(rho, use, fallback=1.0)
    tsc = 1.0 / (zfm * torch.clamp(rho_med, min=RHO_MIN))
    t1 = zfm * invz * klm.ux * tsc
    t2 = zfm * invz * klm.uy * tsc
    t3 = -(q1x * klm.ux + q1y * klm.uy) * invz * tsc
    A = torch.stack([t1, t2, t3, c1, c2, c3], dim=-1)      # [K, 6]
    r0 = b - a

    w = use.to(dt)
    eye6 = torch.eye(6, dtype=dt, device=aV.device)
    for _ in range(3):
        Aw = A * w[:, None]
        AtA = matmul(Aw.T, A) + 1e-4 * eye6
        Atb = matmul(Aw.T, r0)
        x = torch.linalg.solve_ex(AtA, Atb[:, None])[0][:, 0]
        resid = r0 - matmul(A, x)
        w = (use & (torch.abs(resid) <= k_px)).to(dt)
    t_new = aV + x[:3] * tsc         # undo the column scaling: metres
    s = torch.linalg.norm(t_new) / torch.clamp(torch.linalg.norm(aV),
                                               min=1e-12)
    n_used = torch.sum(w > 0, dtype=torch.int32)
    # excitation guard: without enough translation signal the solve is
    # rotation-dominated
    sig = torch.sum(w * a * a)
    ok = (n_used > 50) & (s > 0.05) & (s < 50.0) & (sig > 1.0)
    b_med = masked_median(torch.abs(b), use, fallback=0.0)
    return torch.where(ok, s, torch.ones_like(s)), n_used, b_med


def fuse_stereo_depth(klm: KeylineMap, stereo_m_id: Tensor,
                      stereo_rho: Tensor,
                      stereo_s_rho: Tensor) -> KeylineMap:
    """Information-weighted product of the mono EKF depth and the stereo
    depth (fuseStereoDepth, edge_tracker.cpp:670-688); the mono estimate
    is backed up into rho0/s_rho0."""
    has = (stereo_m_id >= 0) & klm.valid
    s0 = klm.s_rho
    r0 = klm.rho
    i0 = 1.0 / torch.square(torch.clamp(s0, min=1e-6))
    i1 = 1.0 / torch.square(torch.clamp(stereo_s_rho, min=1e-6))
    s_new = torch.rsqrt(i0 + i1)
    r_new = (r0 * i0 + stereo_rho * i1) * torch.square(s_new)
    return klm._replace(rho0=r0, s_rho0=s0,
                        rho=torch.where(has, r_new, klm.rho),
                        s_rho=torch.where(has, s_new, klm.s_rho))
