"""Keyline matching: forward transfer and directed epipolar search
(PyTorch counterpart of rebvo_tpu/kernels/matching.py; reference
edge_tracker, src/mtracklib/edge_tracker.cpp:158-436).

* `forward_match` — depth transfer new <- old along the pose minimiser's
  forward matches, front surface (larger rho) winning, as a scatter-max
  tournament on (rho, source id);
* `directed_matching` / `directed_matching_field` — the per-keyline
  epipolar walk as a fixed candidate ladder in the reference's priority
  order, all tests evaluated at once and the first accepted candidate
  chosen; `top_k` shortlists the earliest hits (their priorities are
  distinct, so the order does not depend on the sort's tie rule).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from rebvo_tpu_torch.core.numerics import matmul, round_int
from rebvo_tpu_torch.frontend.state import KeylineMap

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Forward matching (FordwardMatch, edge_tracker.cpp:380-436)
# ---------------------------------------------------------------------------


def forward_match(old: KeylineMap, new: KeylineMap,
                  m_id_f: Tensor) -> Tuple[KeylineMap, Tensor]:
    """Transfer depth old -> new along forward matches; on double matches
    the larger rho wins, ties to the larger source index. Returns the
    updated new map and the number of matches."""
    K = old.K
    dev = old.rho.device
    src_ok = old.valid & (m_id_f >= 0)
    tgt = torch.where(src_ok, m_id_f, torch.full_like(m_id_f, K))
    tgt64 = tgt.to(torch.int64)

    neg_inf = torch.full_like(old.rho, -float("inf"))
    best_rho = torch.full((K + 1,), -float("inf"), dtype=old.rho.dtype,
                          device=dev)
    best_rho = best_rho.scatter_reduce(
        0, tgt64, torch.where(src_ok, old.rho, neg_inf), reduce="amax",
        include_self=True)
    src_idx = torch.arange(K, dtype=torch.int32, device=dev)
    is_best = src_ok & (old.rho == best_rho[torch.clamp(tgt64, max=K - 1)])
    winner = torch.full((K + 1,), -1, dtype=torch.int32, device=dev)
    winner = winner.scatter_reduce(
        0, torch.where(is_best, tgt64, torch.full_like(tgt64, K)), src_idx,
        reduce="amax", include_self=True)[:K]

    has = winner >= 0
    w = torch.clamp(winner, min=0)

    def sel(a_old, a_new):
        return torch.where(has, a_old[w], a_new)

    new2 = new._replace(
        rho=sel(old.rho, new.rho),
        s_rho=sel(old.s_rho, new.s_rho),
        m_num=torch.where(has, old.m_num[w] + 1, new.m_num),
        m_id=torch.where(has, winner, new.m_id),
        p0x=sel(old.px, new.p0x),
        p0y=sel(old.py, new.p0y),
        g0x=sel(old.gx, new.g0x),
        g0y=sel(old.gy, new.g0y),
        n_m0=sel(old.n_m, new.n_m0),
        m_id_kf=sel(old.m_id_kf, new.m_id_kf),
        ax=sel(old.ax, new.ax),
        ay=sel(old.ay, new.ay),
        arho=sel(old.arho, new.arho),
    )
    nmatch = torch.sum(has & new.valid, dtype=torch.int32)
    return new2, nmatch


# ---------------------------------------------------------------------------
# Directed epipolar matching (edge_tracker.cpp:158-374)
# ---------------------------------------------------------------------------


class DirectedMatchResult(NamedTuple):
    new: KeylineMap
    nmatch: Tensor
    kf_matches: Tensor


def _search_line(new: KeylineMap, Vel, RVel, BackRot, zfm, cx, cy,
                 max_radius, loc_uncertainty):
    """Back-rotated query positions, the displacement direction and its
    uncertainty, and the search interval (shared by both matchers)."""
    Vel = matmul(BackRot, Vel)
    RVel = matmul(matmul(BackRot, RVel), BackRot.T)
    p3x = BackRot[0, 0] * new.px + BackRot[0, 1] * new.py + BackRot[0, 2] * zfm
    p3y = BackRot[1, 0] * new.px + BackRot[1, 1] * new.py + BackRot[1, 2] * zfm
    p3z = BackRot[2, 0] * new.px + BackRot[2, 1] * new.py + BackRot[2, 2] * zfm
    pmx = p3x * zfm / p3z
    pmy = p3y * zfm / p3z
    k_rho = new.rho * zfm / p3z
    pi0x = pmx + cx
    pi0y = pmy + cy

    t_x = -(Vel[0] * zfm - Vel[2] * pmx)
    t_y = -(Vel[1] * zfm - Vel[2] * pmy)
    norm_t0 = torch.sqrt(t_x * t_x + t_y * t_y)

    DrDv = torch.stack([torch.full_like(pmx, zfm), torch.full_like(pmx, zfm),
                        -pmx - pmy], dim=-1)                    # [K,3]
    sigma2_t = torch.sum(matmul(DrDv, RVel) * DrDv, dim=-1)

    moving = norm_t0 > 1e-6
    one = torch.ones_like(norm_t0)
    norm_t = torch.where(moving, norm_t0, one)
    inv_n = 1.0 / torch.where(moving, norm_t0, one)
    ux = torch.where(moving, t_x * inv_n, new.gx / new.n_m)
    uy = torch.where(moving, t_y * inv_n, new.gy / new.n_m)

    dq_rho_m = norm_t0 * k_rho
    dq_min_m = torch.clamp(norm_t0 * (k_rho - new.s_rho), min=0.0) \
        - loc_uncertainty
    dq_max_m = torch.clamp(norm_t0 * (k_rho + new.s_rho), max=max_radius) \
        + loc_uncertainty
    over = dq_rho_m > dq_max_m
    dq_rho_m = torch.where(over, (dq_max_m + dq_min_m) * 0.5, dq_rho_m)
    return dict(pi0x=pi0x, pi0y=pi0y, norm_t0=norm_t0, norm_t=norm_t,
                sigma2_t=sigma2_t, moving=moving, ux=ux, uy=uy,
                dq_rho_m=dq_rho_m, dq_min_m=dq_min_m, dq_max_m=dq_max_m,
                over=over)


def _shortlist(j: Tensor, hit_cap: int):
    """The first `hit_cap` hits along each ladder, earliest first."""
    nc = j.shape[-1]
    hit = j >= 0
    order = nc - torch.arange(nc, dtype=torch.int32, device=j.device)
    prio = torch.where(hit, order[None, :], torch.zeros_like(j))
    top_val, sel_idx = torch.topk(prio, hit_cap, dim=-1, largest=True,
                                  sorted=True)
    j_sel = torch.where(top_val > 0, torch.gather(j, -1, sel_idx),
                        torch.full_like(top_val, -1))
    return j_sel, sel_idx


def _first_accepted(j_sel: Tensor, accept: Tensor) -> Tuple[Tensor, Tensor]:
    """(matched, m_id): the first accepted shortlist entry per keyline."""
    any_acc = torch.any(accept, dim=-1)
    first = torch.argmax(accept.to(torch.int32), dim=-1)
    m_id = torch.gather(j_sel, -1, first[:, None])[:, 0]
    return any_acc, torch.where(any_acc, m_id, torch.full_like(m_id, -1))


def _apply_matches(new: KeylineMap, old: KeylineMap, matched: Tensor,
                   m_id: Tensor) -> DirectedMatchResult:
    """Clone the matched old keylines' depth and ids into `new`."""
    ms = torch.clamp(m_id, min=0)

    def sel(a_old, a_new):
        return torch.where(matched, a_old[ms], a_new)

    # clear=false semantics (the pipeline's call site): unmatched keylines
    # keep their forward-match state (edge_tracker.cpp:325)
    new2 = new._replace(
        rho=sel(old.rho, new.rho),
        s_rho=sel(old.s_rho, new.s_rho),
        m_id=torch.where(matched, m_id, new.m_id),
        m_num=torch.where(matched, old.m_num[ms] + 1, new.m_num),
        p0x=sel(old.px, new.p0x),
        p0y=sel(old.py, new.p0y),
        g0x=sel(old.gx, new.g0x),
        g0y=sel(old.gy, new.g0y),
        n_m0=sel(old.n_m, new.n_m0),
        m_id_kf=sel(old.m_id_kf, new.m_id_kf),
        ax=sel(old.ax, new.ax),
        ay=sel(old.ay, new.ay),
        arho=sel(old.arho, new.arho),
    )
    nmatch = torch.sum(matched, dtype=torch.int32)
    kf_matches = torch.sum(matched & (new2.m_id_kf >= 0), dtype=torch.int32)
    return DirectedMatchResult(new=new2, nmatch=nmatch, kf_matches=kf_matches)


@functools.cache
def cang_min_of(min_thr_ang: float) -> float:
    """The gradient test's cosine bound, evaluated in float32 like the
    reference's cos(deg2rad(f32))."""
    return float(torch.cos(torch.deg2rad(
        torch.tensor(min_thr_ang, dtype=torch.float32))))


def _grad_ok(new: KeylineMap, o_gx, o_gy, o_nm, min_thr_mod, min_thr_ang):
    cang_min = cang_min_of(min_thr_ang)
    cang = (o_gx * new.gx[:, None] + o_gy * new.gy[:, None]) / \
        (o_nm * new.n_m[:, None])
    return (cang >= cang_min) & \
        (torch.abs(o_nm / new.n_m[:, None] - 1.0) <= min_thr_mod)


def directed_matching(new: KeylineMap, old: KeylineMap, old_mask: Tensor,
                      Vel: Tensor, RVel: Tensor, BackRot: Tensor, *,
                      zfm: float, cx: float, cy: float, width: int,
                      height: int, max_steps: int, min_thr_mod: float,
                      min_thr_ang: float, max_radius: float,
                      loc_uncertainty: float) -> DirectedMatchResult:
    """Match every new keyline against the old map's 1-px id mask along
    its epipolar displacement direction (the `MatchFieldStride=0` path)."""
    dt = new.x.dtype
    dev = new.x.device
    K = new.K
    L = _search_line(new, Vel, RVel, BackRot, zfm, cx, cy, max_radius,
                     loc_uncertainty)
    moving, over = L["moving"], L["over"]
    dq_rho_m, dq_min_m, dq_max_m = L["dq_rho_m"], L["dq_min_m"], L["dq_max_m"]
    t_steps_m = torch.where(
        over, torch.floor(dq_rho_m + 0.5),
        torch.floor(torch.maximum(dq_max_m - dq_rho_m, dq_rho_m - dq_min_m)
                    + 0.5))
    full = torch.full_like(dq_rho_m, max_radius + loc_uncertainty)
    dq_min = torch.where(moving, dq_min_m, -full)
    dq_max = torch.where(moving, dq_max_m, full)
    dq_rho = torch.where(moving, dq_rho_m, torch.zeros_like(dq_rho_m))
    t_steps = torch.where(moving, t_steps_m, full)

    i_idx = torch.arange(max_steps, dtype=dt, device=dev)
    cand_dn = dq_rho[:, None] - i_idx[None, :]
    cand_up = dq_rho[:, None] + 1.0 + i_idx[None, :]
    cand_t = torch.stack([cand_dn, cand_up], dim=-1).reshape(K, -1)
    step_ok = i_idx[None, :, None] < t_steps[:, None, None]
    dir_ok = torch.stack([cand_dn >= dq_min[:, None],
                          cand_up <= dq_max[:, None]], dim=-1)
    cand_ok = (step_ok & dir_ok).reshape(K, -1)

    qx = round_int(L["ux"][:, None] * cand_t + L["pi0x"][:, None])
    qy = round_int(L["uy"][:, None] * cand_t + L["pi0y"][:, None])
    inb = (qx >= 0) & (qx < width) & (qy >= 0) & (qy < height)
    lin = torch.clamp(qy, 0, height - 1) * width + \
        torch.clamp(qx, 0, width - 1)
    j = old_mask.reshape(-1)[lin]
    j = torch.where(cand_ok & inb, j, torch.full_like(j, -1))

    j_sel, sel_idx = _shortlist(j, 12)
    t_sel = torch.gather(cand_t, -1, sel_idx)
    js = torch.clamp(j_sel, min=0)
    o_gx, o_gy, o_nm = old.gx[js], old.gy[js], old.n_m[js]
    o_rho, o_srho = old.rho[js], old.s_rho[js]

    grad_ok = _grad_ok(new, o_gx, o_gy, o_nm, min_thr_mod, min_thr_ang)
    norm_t = L["norm_t"]
    v_rho_dr = (loc_uncertainty * loc_uncertainty
                + o_srho * o_srho * (norm_t * norm_t)[:, None]
                + L["sigma2_t"][:, None] * o_rho * o_rho)
    consistent = torch.square(t_sel - norm_t[:, None] * o_rho) <= v_rho_dr
    accept = (j_sel >= 0) & grad_ok & consistent & new.valid[:, None]
    return _apply_matches(new, old, *_first_accepted(j_sel, accept))


def directed_matching_field(new: KeylineMap, old: KeylineMap,
                            old_field: Tensor, Vel: Tensor, RVel: Tensor,
                            BackRot: Tensor, *, zfm: float, cx: float,
                            cy: float, width: int, height: int,
                            max_steps: int, stride: int, min_thr_mod: float,
                            min_thr_ang: float, max_radius: float,
                            loc_uncertainty: float) -> DirectedMatchResult:
    """Field-sampled variant: the ladder samples the old map's match
    field at `stride`-pixel spacing; the chi^2 test uses the matched
    keyline's exact projection onto the search line."""
    dt = new.x.dtype
    dev = new.x.device
    K = new.K
    L = _search_line(new, Vel, RVel, BackRot, zfm, cx, cy, max_radius,
                     loc_uncertainty)
    moving = L["moving"]
    full = torch.full_like(L["dq_rho_m"], max_radius + loc_uncertainty)
    dq_min = torch.where(moving, L["dq_min_m"], -full)
    dq_max = torch.where(moving, L["dq_max_m"], full)
    dq_rho = torch.where(moving, L["dq_rho_m"],
                         torch.zeros_like(L["dq_rho_m"]))

    i_idx = torch.arange(max_steps, dtype=dt, device=dev) * stride
    cand_dn = dq_rho[:, None] - i_idx[None, :]
    cand_up = dq_rho[:, None] + i_idx[None, :] + 0.5 * stride
    cand_t = torch.stack([cand_dn, cand_up], dim=-1).reshape(K, -1)
    pad = 0.5 * stride
    cand_ok = (cand_t >= dq_min[:, None] - pad) & \
        (cand_t <= dq_max[:, None] + pad)

    pi0x, pi0y, ux, uy = L["pi0x"], L["pi0y"], L["ux"], L["uy"]
    qx = round_int(ux[:, None] * cand_t + pi0x[:, None])
    qy = round_int(uy[:, None] * cand_t + pi0y[:, None])
    inb = (qx >= 0) & (qx < width) & (qy >= 0) & (qy < height)
    lin = torch.clamp(qy, 0, height - 1) * width + \
        torch.clamp(qx, 0, width - 1)
    j = old_field.reshape(-1)[lin]
    j = torch.where(cand_ok & inb, j, torch.full_like(j, -1))

    j_sel, _ = _shortlist(j, 8)
    js = torch.clamp(j_sel, min=0)
    o_gx, o_gy, o_nm = old.gx[js], old.gy[js], old.n_m[js]
    o_rho, o_srho = old.rho[js], old.s_rho[js]
    o_x, o_y = old.x[js], old.y[js]

    grad_ok = _grad_ok(new, o_gx, o_gy, o_nm, min_thr_mod, min_thr_ang)
    t_exact = (o_x - pi0x[:, None]) * ux[:, None] + \
        (o_y - pi0y[:, None]) * uy[:, None]
    range_ok = (t_exact >= dq_min[:, None]) & (t_exact <= dq_max[:, None])
    norm_t = L["norm_t"]
    v_rho_dr = (loc_uncertainty * loc_uncertainty
                + o_srho * o_srho * (norm_t * norm_t)[:, None]
                + L["sigma2_t"][:, None] * o_rho * o_rho)
    consistent = torch.square(t_exact - norm_t[:, None] * o_rho) <= v_rho_dr
    accept = (j_sel >= 0) & grad_ok & range_ok & consistent & \
        new.valid[:, None]
    return _apply_matches(new, old, *_first_accepted(j_sel, accept))
