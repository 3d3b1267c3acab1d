"""Per-keyline inverse-depth filtering: EKF update, chain regularisation,
global rescaling, uncertainty quantile (PyTorch counterpart of
rebvo_tpu/kernels/depth_filter.py; reference edge_tracker,
src/mtracklib/edge_tracker.cpp:87-148, 695-834, 954-1186) as masked
elementwise ops over the KeylineMap SoA.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vobench.reference.core.numerics import sum64, to_int32
from vobench.reference.frontend.state import (RHO_INIT, RHO_MAX, RHO_MIN,
                                            KeylineMap)

Tensor = torch.Tensor


def depth_ekf(klm: KeylineMap, vel: Tensor, zfm: float, *,
              reshape_q_abs: float, loc_uncertainty: float) -> KeylineMap:
    """Batched scalar EKF on inverse depth for matched keylines
    (UpdateInverseDepthKalmanARLU, edge_tracker.cpp:954-1055)."""
    active = klm.valid & (klm.m_id >= 0)

    s_rho_prior = klm.s_rho
    v_rho = klm.s_rho * klm.s_rho
    u_x = klm.g0x / klm.n_m0
    u_y = klm.g0y / klm.n_m0

    Y = u_x * (klm.px - klm.p0x) + u_y * (klm.py - klm.p0y)
    H = u_x * (vel[0] * zfm - vel[2] * klm.p0x) + \
        u_y * (vel[1] * zfm - vel[2] * klm.p0y)

    rho_p = 1.0 / (1.0 / klm.rho + vel[2])
    F = 1.0 / (1.0 + klm.rho * vel[2])
    F2 = F * F
    p_p = F2 * v_rho * F2 + reshape_q_abs * reshape_q_abs

    e = Y - H * rho_p
    S = H * p_p * H + loc_uncertainty * loc_uncertainty
    Kk = p_p * H / S
    rho_new = rho_p + Kk * e
    s_new = torch.sqrt((1.0 - Kk * H) * p_p)

    # limit corrections (edge_tracker.cpp:1035-1055)
    below = rho_new < RHO_MIN
    s_new = torch.where(below, s_new + (RHO_MIN - rho_new), s_new)
    rho_new = torch.clamp(rho_new, RHO_MIN, RHO_MAX)
    bad = (~torch.isfinite(rho_new)) | (~torch.isfinite(s_new)) | (s_new < 0)
    rho_new = torch.where(bad, torch.full_like(rho_new, RHO_INIT), rho_new)
    s_new = torch.where(bad, torch.full_like(s_new, RHO_MAX), s_new)

    return klm._replace(
        rho=torch.where(active, rho_new, klm.rho),
        s_rho=torch.where(active, s_new, klm.s_rho),
        rho0=torch.where(active, rho_p, klm.rho0),
        s_rho0=torch.where(active, s_rho_prior, klm.s_rho0),
    )


def regularize_1_iter(klm: KeylineMap, thresh: float
                      ) -> Tuple[KeylineMap, Tensor]:
    """One smoothing pass of (rho, s_rho) along edge chains
    (Regularize_1_iter, edge_tracker.cpp:87-148); all neighbour values are
    read before any is written."""
    has_nb = klm.valid & (klm.n_id >= 0) & (klm.p_id >= 0)
    ni = torch.clamp(klm.n_id, min=0)
    pi = torch.clamp(klm.p_id, min=0)

    rho_n, rho_p = klm.rho[ni], klm.rho[pi]
    s_n, s_p = klm.s_rho[ni], klm.s_rho[pi]

    sigma_ok = torch.square(rho_n - rho_p) <= (s_n * s_n + s_p * s_p)

    alpha0 = (klm.gx[ni] * klm.gx[pi] + klm.gy[ni] * klm.gy[pi]) / \
        (klm.n_m[ni] * klm.n_m[pi])
    angle_ok = (alpha0 - thresh) >= 0
    alpha = (alpha0 - thresh) / (1.0 - thresh)
    alpha = alpha / (torch.abs(rho_n - rho_p) / (s_n + s_p) + 1.0)

    wr = 1.0 / (klm.s_rho * klm.s_rho)
    wrn = alpha / (s_n * s_n)
    wrp = alpha / (s_p * s_p)
    wsum = wr + wrn + wrp
    r = (klm.rho * wr + rho_n * wrn + rho_p * wrp) / wsum
    s = (klm.s_rho * wr + s_n * wrn + s_p * wrp) / wsum

    apply = has_nb & sigma_ok & angle_ok
    out = klm._replace(rho=torch.where(apply, r, klm.rho),
                       s_rho=torch.where(apply, s, klm.s_rho))
    return out, torch.sum(apply, dtype=torch.int32)


def estimate_rescaling_opt(klm: KeylineMap, *, s_rho_min: float = RHO_MAX,
                           match_num_min: int = 1, apply=False,
                           iters: int = 5
                           ) -> Tuple[KeylineMap, Tensor, Tensor]:
    """Iterated ratio Kp between updated and predicted inverse depth
    (EstimateReScalingOpt, edge_tracker.cpp:1104-1140); returns
    (map, Kp, RKp), the map rescaled when `apply` (a bool or a device
    bool)."""
    use = klm.valid & (klm.m_num >= match_num_min) & (klm.s_rho0 > 0) & \
        (klm.s_rho <= s_rho_min)
    zero = torch.zeros_like(klm.rho)
    rho2 = torch.where(use, klm.rho * klm.rho, zero)
    rho02 = torch.where(use, klm.rho0 * klm.rho0, zero)
    s2 = klm.s_rho * klm.s_rho
    s02 = klm.s_rho0 * klm.s_rho0

    one = torch.ones((), dtype=klm.rho.dtype, device=klm.rho.device)
    Kp = one
    RKp = one
    for _ in range(iters):
        w = torch.where(use, 1.0 / (s2 + Kp * Kp * s02), zero)
        rTr = sum64(rho2 * w)
        rTr0 = sum64(rho02 * w)
        pos = rTr0 > 0
        safe = torch.where(pos, rTr0, one)
        Kp = torch.where(pos, torch.sqrt(rTr / safe), one)
        RKp = 1.0 / safe

    if isinstance(apply, bool):
        div = Kp if apply else one
    else:
        div = torch.where(apply, Kp, one)
    klm = klm._replace(rho=klm.rho / div, s_rho=klm.s_rho / div)
    return klm, Kp, RKp


def estimate_quantile(klm: KeylineMap, *, s_rho_min: float = RHO_MIN,
                      s_rho_max: float = RHO_MAX, percentile: float = 0.9,
                      nbins: int = 100) -> Tensor:
    """Histogram quantile of s_rho over the valid keylines (EstimateQuantile,
    edge_tracker.cpp:1148-1186): the pose minimiser's uncertainty cut-off."""
    dev = klm.s_rho.device
    kn = torch.sum(klm.valid, dtype=torch.int32)
    span = s_rho_max - s_rho_min
    i = to_int32(nbins * (klm.s_rho - s_rho_min) / span)
    i = torch.clamp(i, 0, nbins - 1)
    i_eff = torch.where(klm.valid, i, torch.full_like(i, nbins)).to(torch.int64)
    hist = torch.zeros(nbins + 1, dtype=torch.int32, device=dev)
    hist = hist.scatter_add(0, i_eff, torch.ones_like(i))[:nbins]
    shifted = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(hist, dim=0, dtype=torch.int32)[:-1]])
    reached = shifted.to(torch.float32) > percentile * kn.to(torch.float32)
    idx = torch.argmax(reached.to(torch.int32))
    s = idx.to(klm.s_rho.dtype) * span / nbins + s_rho_min
    return torch.where(torch.any(reached), s, torch.full_like(s, 1e3))
