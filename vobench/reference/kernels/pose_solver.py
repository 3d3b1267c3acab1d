"""Frame-to-frame pose estimation by direct edge alignment (PyTorch
counterpart of rebvo_tpu/kernels/pose_solver.py; reference
global_tracker TryVelRot / Minimizer_RV / Minimizer_V,
src/mtracklib/global_tracker.cpp:285-1093).

The robust cost, the analytic Jacobian and the Levenberg-Marquardt
loop are the JAX package's (see its module docstring for the cost's
deviation from the reference). Here:
  * every function also takes a leading batch of states X [..., 6], which
    replaces the reference's `vmap` over warm-start candidates;
  * the LM loops have fixed iteration counts and select with `where`, and
    the linear solves are `solve_ex` / `inv_ex` (no error check, so no
    host sync; a singular system still gives non-finite values, which the
    step's nan_fail test relies on);
  * the LM's sums (J^T J, J^T F, the score, the predicted gain) are
    accumulated in float64 and rounded once to float32, its 6x6 solves
    and the in-plane rotation's sin and cos run in float64: its accept
    tests and rung choice compare these numbers, and a float32 sum in
    another order (the card's against the CPU's) flips them on a few
    frames of a long run, which the stereo scale carry then amplifies
    (core/numerics' module note).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.core.geometry import so3_exp
from vobench.reference.core.numerics import matmul, round_int, sum64
from vobench.reference.frontend.state import KeylineMap

Tensor = torch.Tensor


class FieldView(NamedTuple):
    """What TryVelRot needs about the *new* edge map: the field image and
    the per-keyline attributes packed as [K, 8] rows."""

    ikl: Tensor     # [H, W] int32 field image (build_field output)
    attrs: Tensor   # [K, 8]: x, y, ux, uy, gx, gy, n_m, pad

    @staticmethod
    def from_map(field_img: Tensor, klm: KeylineMap) -> "FieldView":
        attrs = torch.stack(
            [klm.x, klm.y, klm.ux, klm.uy, klm.gx, klm.gy, klm.n_m,
             torch.zeros_like(klm.x)], dim=-1)
        return FieldView(ikl=field_img, attrs=attrs)


class TryVelRotResult(NamedTuple):
    score: Tensor     # [...] total robust cost
    JtJ: Tensor       # [..., 6, 6]
    JtF: Tensor       # [..., 6]
    residual: Tensor  # [..., K]
    m_id_f: Tensor    # [..., K] forward match ids (-1 = none)
    q_rho: Tensor     # [..., K] noise shaping at this state


def _solve64(A: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.solve_ex(A.double(), b.double())[0].to(A.dtype)


def _inv64(A: Tensor) -> Tensor:
    return torch.linalg.inv_ex(A.double())[0].to(A.dtype)


def try_vel_rot(X: Tensor, old: KeylineMap, fv: FieldView,
                q_frozen: Tensor = None, *, zfm: float, cx: float,
                cy: float, width: int, height: int, max_r=None,
                match_thresh: float, max_s_rho: Tensor,
                match_num_min: Tensor, k_huber: float,
                min_mod: Tensor = None,
                vote_mask: Tensor = None) -> TryVelRotResult:
    """One robust residual/Jacobian evaluation at state(s) X [..., 6]."""
    V = X[..., :3]
    W = X[..., 3:]
    R0 = so3_exp(W)                                   # [..., 3, 3]

    def e(a):                                         # [...] -> [..., 1]
        return a[..., None]

    one = torch.ones_like(old.rho)
    zero = torch.zeros_like(old.rho)
    rho_safe = torch.where(old.valid, old.rho, one)
    Z0 = 1.0 / rho_safe
    X0 = torch.where(old.valid, old.px, zero) * Z0 / zfm
    Y0 = torch.where(old.valid, old.py, zero) * Z0 / zfm

    ptx = e(R0[..., 0, 0]) * X0 + e(R0[..., 0, 1]) * Y0 + \
        e(R0[..., 0, 2]) * Z0 + e(V[..., 0])
    pty = e(R0[..., 1, 0]) * X0 + e(R0[..., 1, 1]) * Y0 + \
        e(R0[..., 1, 2]) * Z0 + e(V[..., 1])
    ptz = e(R0[..., 2, 0]) * X0 + e(R0[..., 2, 1]) * Y0 + \
        e(R0[..., 2, 2]) * Z0 + e(V[..., 2])
    rho_p = 1.0 / ptz
    qx = ptx * zfm * rho_p
    qy = pty * zfm * rho_p
    pix = qx + cx
    piy = qy + cy

    gated = (old.s_rho > max_s_rho) | (old.m_num < match_num_min) | \
        (~old.valid)
    if min_mod is not None:
        gated = gated | (old.n_m < min_mod)

    xr = round_int(pix)
    yr = round_int(piy)
    oob = (xr < 1) | (yr < 1) | (xr >= width - 1) | (yr >= height - 1)

    lin = torch.clamp(yr, 0, height - 1) * width + \
        torch.clamp(xr, 0, width - 1)
    j = fv.ikl.reshape(-1)[lin]
    j_safe = torch.clamp(j, min=0)
    no_kl = j < 0
    fa = fv.attrs[j_safe]                             # [..., K, 8]

    c = e(torch.cos(W[..., 2].double()).to(W.dtype))
    s = e(torch.sin(W[..., 2].double()).to(W.dtype))
    gmx = c * old.gx - s * old.gy
    gmy = s * old.gx + c * old.gy
    f_gx = fa[..., 4]
    f_gy = fa[..., 5]
    p_n2 = old.n_m * old.n_m
    p_esc = gmx * f_gx + gmy * f_gy
    grad_fail = torch.abs(p_esc - p_n2) > match_thresh * p_n2
    miss = no_kl | grad_fail

    dx = pix - fa[..., 0]
    dy = piy - fa[..., 1]
    fux = fa[..., 2]
    fuy = fa[..., 3]
    fi = dx * fux + dy * fuy

    matched = (~gated) & (~oob) & (~miss)
    zk = torch.zeros_like(fi)
    dfx = torch.where(matched, fux, zk)
    dfy = torch.where(matched, fuy, zk)

    s_shape = torch.clamp(old.s_rho, max=1.0)
    qvel = zfm * dfx * e(V[..., 0]) + zfm * dfy * e(V[..., 1]) + \
        (qx * dfx + qy * dfy) * e(V[..., 2])
    q_self = torch.sqrt(torch.square(s_shape * qvel) + 1.0)
    q = q_self if q_frozen is None else q_frozen
    inv_q = 1.0 / q

    r = torch.where(matched, fi * inv_q, zk)
    abs_r = torch.abs(r)
    k = float(k_huber)
    inlier = matched & (abs_r <= k)
    cost_m = torch.clamp(r * r, max=k * k)
    w = torch.where(inlier, torch.ones_like(r), zk)

    cost = torch.where(gated, zk, torch.where(matched, cost_m,
                                              torch.full_like(r, k * k)))
    voter = old.valid if vote_mask is None else (old.valid & vote_mask)
    score = sum64(torch.where(voter, cost, zk), dim=-1)

    m_id_f = torch.where(matched, j, torch.full_like(j, -1))

    a = rho_p * zfm * dfx
    b = rho_p * zfm * dfy
    ct = rho_p * (qx * dfx + qy * dfy)
    sw = torch.sqrt(w) * inv_q
    J = torch.stack([a, b, -ct, -b * ptz - ct * pty, a * ptz + ct * ptx,
                     -a * pty + b * ptx], dim=-1) * sw[..., None]
    vm = voter & matched
    J = torch.where(vm[..., None], J, torch.zeros_like(J))
    fw = torch.where(vm, r * torch.sqrt(w), zk)

    JtJ = matmul(J.transpose(-1, -2), J)
    JtF = matmul(J.transpose(-1, -2), fw[..., None])[..., 0]
    return TryVelRotResult(score=score, JtJ=JtJ, JtF=JtF,
                           residual=torch.where(matched, fi, zk),
                           m_id_f=m_id_f, q_rho=q_self)


def _lm_damping_update(u, v, gain):
    fac = torch.clamp(1.0 - (2.0 * gain - 1.0) ** 3, min=0.33)
    return u * fac, torch.full_like(v, 2.0)


def _solve_lm(JtJ: Tensor, JtF: Tensor, u: Tensor) -> Tensor:
    eye = torch.eye(JtJ.shape[-1], dtype=JtJ.dtype, device=JtJ.device)
    A = JtJ + u[..., None, None] * eye
    return _solve64(A, -JtF)


def _pick(a: Tensor, i: Tensor) -> Tensor:
    """a[i] for a 0-d device index without a host read of i (indexing
    with a 0-d tensor converts it to a Python int)."""
    return torch.index_select(a, 0, i.reshape(1))[0]


def _where(c: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """where() of a per-batch condition [...] over [..., *] values."""
    return torch.where(c.reshape(c.shape + (1,) * (a.ndim - c.ndim)), a, b)


class MinimizerRVResult(NamedTuple):
    Vel: Tensor
    W0: Tensor
    RVel: Tensor      # covariance of V (slice of JtJ^-1)
    RW0: Tensor
    W_X: Tensor       # [6,6] information matrix (final JtJ)
    m_id_f: Tensor    # forward matches at the final state
    score: Tensor
    rel_error: Tensor
    rel_error_score: Tensor


def _lm_phase(ev, X0: Tensor, n_iter: int, tau: float):
    """LM over a batch of start states X0 [..., 6] with fixed iterations;
    returns (X, F, JtJ, JtF, m_id_f, eff, h, F_init)."""
    r = ev(X0)
    F_init = r.score
    F = r.score
    JtJ, JtF, m_id_f = r.JtJ, r.JtF, r.m_id_f
    u = tau * torch.amax(JtJ, dim=(-2, -1))
    v = torch.full_like(u, 2.0)
    X = X0
    eff = torch.zeros(F.shape, dtype=torch.int32, device=F.device)
    h = torch.zeros_like(X0)
    for _ in range(n_iter):
        h_new = _solve_lm(JtJ, JtF, u)
        Xn = X + h_new
        rn = ev(Xn)
        pred = 0.5 * sum64(h_new * (u[..., None] * h_new - JtF), dim=-1)
        gain = (F - rn.score) / pred
        acc = gain > 0
        X = _where(acc, Xn, X)
        F = torch.where(acc, rn.score, F)
        JtJ = _where(acc, rn.JtJ, JtJ)
        JtF = _where(acc, rn.JtF, JtF)
        m_id_f = _where(acc, rn.m_id_f, m_id_f)
        u_acc, v_acc = _lm_damping_update(u, v, gain)
        u = torch.where(acc, u_acc, u * v)
        v = torch.where(acc, v_acc, v * 2.0)
        eff = eff + acc.to(torch.int32)
        h = _where(acc, h_new, h)
    return X, F, JtJ, JtF, m_id_f, eff, h, F_init


def minimizer_rv(Vel: Tensor, W0: Tensor, old: KeylineMap, fv: FieldView,
                 *, zfm: float, cx: float, cy: float, width: int,
                 height: int, max_r=None, match_thresh: float,
                 max_s_rho: Tensor, match_num_min: Tensor, k_huber: float,
                 iter_max: int, init_iter: int, init_type: int = 2,
                 vote_mask: Tensor = None) -> MinimizerRVResult:
    """Levenberg-Marquardt over [V; W] (Minimizer_RV,
    global_tracker.cpp:578-819), noise shaping frozen at the prior."""
    tau = 1e-3
    kw = dict(zfm=zfm, cx=cx, cy=cy, width=width, height=height,
              match_thresh=match_thresh, max_s_rho=max_s_rho,
              match_num_min=match_num_min, k_huber=k_huber,
              vote_mask=vote_mask)

    prior_X = torch.cat([Vel, W0])
    q_frame = try_vel_rot(prior_X, old, fv, None, **kw).q_rho

    def ev(X):
        return try_vel_rot(X, old, fv, q_frame, **kw)

    if init_type == 0:
        X = torch.zeros_like(prior_X)
    elif init_type == 1:
        X = prior_X
    else:
        # warm start over a candidate batch: zero and prior inits
        # (global_tracker.cpp:644-751), then a 2x/4x/8x velocity ladder on
        # the refined base (see the JAX package for why)
        cands = torch.stack([torch.zeros_like(prior_X), prior_X])
        Xs, Fs = _lm_phase(ev, cands, init_iter, tau)[:2]
        base_X = torch.where(Fs[1] <= Fs[0], Xs[1], Xs[0])
        base_F = torch.where(Fs[1] <= Fs[0], Fs[1], Fs[0])
        rungs = torch.stack([torch.cat([base_X[:3] * sc, base_X[3:]])
                             for sc in (2.0, 4.0, 8.0)])
        Xr, Fr = _lm_phase(ev, rungs, init_iter, tau)[:2]
        rung_i = torch.argmin(Fr)
        take = _pick(Fr, rung_i) < 0.98 * base_F
        X = torch.where(take, _pick(Xr, rung_i), base_X)

    X, F, JtJ, JtF, m_id_f, eff, h, F0 = _lm_phase(ev, X, iter_max, tau)

    RRV = _inv64(JtJ)
    any_eff = eff > 0
    rel_error = torch.where(
        any_eff, torch.linalg.norm(h) / (torch.linalg.norm(X) + 1e-30),
        torch.full_like(F, 1e20))
    rel_error_score = torch.where(
        any_eff, F / torch.where(F0 > 0, F0, torch.ones_like(F0)),
        torch.full_like(F, 1e20))
    return MinimizerRVResult(
        Vel=X[:3], W0=X[3:], RVel=RRV[:3, :3], RW0=RRV[3:, 3:], W_X=JtJ,
        m_id_f=m_id_f, score=F, rel_error=rel_error,
        rel_error_score=rel_error_score)


class MinimizerVResult(NamedTuple):
    Vel: Tensor
    RVel: Tensor
    m_id_f: Tensor
    score: Tensor


def minimizer_v(Vel: Tensor, old: KeylineMap, fv: FieldView, *,
                zfm: float, cx: float, cy: float, width: int, height: int,
                max_r=None, match_thresh: float, max_s_rho: Tensor,
                match_num_min: Tensor, k_huber: float, min_mod: Tensor,
                iter_max: int, vote_mask: Tensor = None
                ) -> MinimizerVResult:
    """Translation-only LM (Minimizer_V / TryVel,
    global_tracker.cpp:829-1093), restricted to the V block."""
    tau = 1e-3
    kw = dict(zfm=zfm, cx=cx, cy=cy, width=width, height=height,
              match_thresh=match_thresh, max_s_rho=max_s_rho,
              match_num_min=match_num_min, k_huber=k_huber, min_mod=min_mod,
              vote_mask=vote_mask)
    prior_X = torch.cat([Vel, torch.zeros_like(Vel)])
    q_frame = try_vel_rot(prior_X, old, fv, None, **kw).q_rho

    def ev(V):
        return try_vel_rot(torch.cat([V, torch.zeros_like(V)], dim=-1),
                           old, fv, q_frame, **kw)

    def lm_phase(V0, n_iter):
        r = ev(V0)
        F = r.score
        JtJ = r.JtJ[..., :3, :3]
        JtF = r.JtF[..., :3]
        m_id_f = r.m_id_f
        u = tau * torch.amax(JtJ, dim=(-2, -1))
        v = torch.full_like(u, 2.0)
        V = V0
        for _ in range(n_iter):
            h = _solve_lm(JtJ, JtF, u)
            Vn = V + h
            rn = ev(Vn)
            pred = 0.5 * sum64(h * (u[..., None] * h - JtF), dim=-1)
            gain = (F - rn.score) / pred
            acc = gain > 0
            V = _where(acc, Vn, V)
            F = torch.where(acc, rn.score, F)
            JtJ = _where(acc, rn.JtJ[..., :3, :3], JtJ)
            JtF = _where(acc, rn.JtF[..., :3], JtF)
            m_id_f = _where(acc, rn.m_id_f, m_id_f)
            u_acc, v_acc = _lm_damping_update(u, v, gain)
            u = torch.where(acc, u_acc, u * v)
            v = torch.where(acc, v_acc, v * 2.0)
        return V, F, JtJ, JtF, m_id_f

    V0, F0_, *_ = lm_phase(Vel, 2)
    rungs = torch.stack([V0 * sc for sc in (2.0, 4.0, 8.0)])
    Vr, Fr = lm_phase(rungs, 2)[:2]
    rung_i = torch.argmin(Fr)
    take = _pick(Fr, rung_i) < 0.98 * F0_
    V = torch.where(take, _pick(Vr, rung_i), V0)
    V, F, JtJ, JtF, m_id_f = lm_phase(V, iter_max)
    RVel = _inv64(JtJ)
    return MinimizerVResult(Vel=V, RVel=RVel, m_id_f=m_id_f, score=F)
