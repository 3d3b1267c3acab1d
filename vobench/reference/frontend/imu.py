"""Visual-inertial fusion: IMU integration and the two-stage Bayesian
filter (PyTorch counterpart of rebvo_tpu/frontend/imu.py).

As in the JAX package, pure functions over explicit state:

  * inter-frame IMU integration (ImuGrabber::GrabAndIntegrate, reference
    src/UtilLib/imugrabber.cpp:217-250) over a fixed-size sample window;
  * the 6-dof linear correction from forward matches (ExtRotVel,
    src/mtracklib/edge_tracker.cpp:1207-1301) as one weighted LS;
  * gyro fusion + bias random walk (BiasCorrect, edge_tracker.cpp:1308);
  * the 7-state scale/gravity/accel-bias filter (ScaleEstimator,
    src/mtracklib/scaleestimator.cpp): EstAcelLsq4, MeanAcel4 and
    estKaGMEKBias's 11-equation Gauss-Newton update.

None of them reads a device value on the host, so the step that calls
them runs under `torch.cuda.set_sync_debug_mode("error")`: inverses and
solves are `inv_ex` / `solve_ex`, the pseudo-inverse is a fixed-sweep
Jacobi eigensolver (`pinv_sym`), and constant vectors are built on the
device rather than copied from the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from vobench.reference.core.geometry import skew, so3_exp

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Inter-frame IMU integration
# ---------------------------------------------------------------------------


class ImuWindow(NamedTuple):
    """Fixed-size window of IMU samples covering one frame interval.

    Samples beyond `count` are padding. `tsample` is the IMU sample
    period (the reference's ImuGrabber tsamp)."""

    gyro: Tensor     # [S, 3]
    accel: Tensor    # [S, 3]
    count: Tensor    # int32 — valid samples
    tsample: Tensor  # scalar


class IntegratedImu(NamedTuple):
    """Equivalent of the reference's IntegratedImuData (imugrabber.h:56)."""

    n: Tensor
    dt: Tensor
    Rot: Tensor      # [3,3] integrated inter-frame rotation
    giro: Tensor     # [3] mean gyro
    acel: Tensor     # [3] mean accel
    dgiro: Tensor    # [3] finite-difference angular acceleration
    cacel: Tensor    # [3] tangential-compensated acceleration


def integrate_window(win: ImuWindow, R_cam2imu: Tensor,
                     T_cam2imu: Tensor) -> IntegratedImu:
    """GrabAndIntegrate semantics: rotate samples into the camera frame,
    average, integrate rotation on SO(3) sample by sample, estimate
    angular acceleration, compensate tangential acceleration.

    The S increments are one batched so3_exp; their ordered product runs
    in the JAX package's order, a padding slot contributing the identity
    (R @ I = R)."""
    S = win.gyro.shape[0]
    dev, dt = win.gyro.device, win.gyro.dtype
    idx = torch.arange(S, device=dev)
    valid = idx < win.count
    mask = valid[:, None]
    Rt = R_cam2imu.T
    gyro_c = (win.gyro @ Rt.T) * mask
    accel_c = (win.accel @ Rt.T) * mask

    n = torch.clamp(win.count, min=1)
    nf = n.to(dt)
    mean_g = torch.sum(gyro_c, dim=0) / nf
    mean_a = torch.sum(accel_c, dim=0) / nf

    eye = torch.eye(3, dtype=dt, device=dev)
    dR = torch.where(valid[:, None, None], so3_exp(gyro_c * win.tsample), eye)
    Rot = eye
    for i in range(S):
        Rot = Rot @ dR[i]

    dtw = win.count.to(dt) * win.tsample
    # dgiro only with >1 sample (imugrabber.cpp:239-244).
    last = torch.clamp(win.count - 1, 0, S - 1).to(torch.int64).reshape(1)
    g_last = torch.index_select(gyro_c, 0, last)[0]
    dgiro = torch.where(
        win.count > 1,
        (g_last - gyro_c[0]) / torch.where(dtw > 0, dtw, torch.ones_like(dtw)),
        torch.zeros(3, dtype=dt, device=dev))
    arm = -(Rt @ T_cam2imu)
    cacel = mean_a + torch.linalg.cross(dgiro, arm)
    return IntegratedImu(n=win.count, dt=dtw, Rot=Rot, giro=mean_g,
                         acel=mean_a, dgiro=dgiro, cacel=cacel)


# ---------------------------------------------------------------------------
# Pseudo-inverse of a symmetric matrix without a host read
# ---------------------------------------------------------------------------

# 6x6 matrices of condition up to 1e12 reach float64 roundoff in 6 sweeps
JACOBI_SWEEPS = 6


def _round_robin(n: int) -> list:
    """The position permutation of the circle method for pairs
    (0,1), (2,3), ...: applied after each round, it brings every pair of
    indices together once in n-1 rounds. new[i] = old[perm[i]]."""
    ring = [1] + [0] * (n - 2)
    for j in range(1, n // 2):
        ring[j], ring[n - 1 - j] = 2 * j, 2 * j + 1
    perm = list(range(n))
    for j in range(n - 1):
        perm[ring[(j + 1) % (n - 1)]] = ring[j]
    return perm


def eigh_jacobi(A: Tensor, sweeps: int = JACOBI_SWEEPS) -> Tuple[Tensor,
                                                                 Tensor]:
    """(eigenvalues, eigenvectors as columns) of a symmetric [n, n]
    matrix, n even, by cyclic Jacobi in float64: each round rotates n/2
    disjoint pairs at once (Golub & Van Loan's sym.schur2 angle) and then
    permutes positions by the circle method, so a sweep of n-1 rounds
    meets every pair. A fixed number of sweeps, no convergence test: the
    count of kernels is fixed and nothing is read on the host
    (torch.linalg.eigh / svd check their LAPACK status on the host)."""
    n = A.shape[-1]
    if n % 2:
        raise ValueError(f"eigh_jacobi: n must be even, got {n}")
    A = A.to(torch.float64)
    A = 0.5 * (A + A.T)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    PmT = torch.stack([eye[j] for j in _round_robin(n)]).T
    zero = torch.zeros(n // 2, dtype=A.dtype, device=A.device)
    V = eye
    for _ in range(sweeps * (n - 1)):
        d = A.diagonal()
        app, aqq = d[0::2], d[1::2]
        apq = A.diagonal(1)[0::2]
        zeta = (aqq - app) / (2.0 * apq)
        t = torch.copysign(torch.ones_like(zeta), zeta) / (
            torch.abs(zeta) + torch.hypot(torch.ones_like(zeta), zeta))
        t = torch.where(apq == 0, zero, t)
        c = 1.0 / torch.hypot(torch.ones_like(t), t)
        s = t * c
        cc = c[:, None].expand(n // 2, 2).reshape(n)
        sup = torch.stack([s, zero], dim=1).reshape(n)[:-1]
        J = torch.diag_embed(cc) + torch.diag_embed(sup, 1) - \
            torch.diag_embed(sup, -1)
        G = J @ PmT
        A = G.T @ A @ G
        V = V @ G
    return A.diagonal(), V


def pinv_sym(A: Tensor, rtol: float = None) -> Tensor:
    """Pseudo-inverse of a symmetric matrix with jnp.linalg.pinv's cutoff:
    an eigenvalue whose magnitude (a singular value) is at or below
    rtol * the largest magnitude maps to 0, and the default rtol is JAX's
    10 * n * eps of A's dtype (torch.linalg.pinv's default is n * eps).
    A zero matrix gives zero, as in JAX."""
    if rtol is None:
        rtol = 10.0 * A.shape[-1] * torch.finfo(A.dtype).eps
    lam, V = eigh_jacobi(A)
    mag = torch.abs(lam)
    keep = mag > rtol * torch.amax(mag)
    inv = torch.where(keep, 1.0 / torch.where(keep, lam, torch.ones_like(lam)),
                      torch.zeros_like(lam))
    return ((V * inv) @ V.T).to(A.dtype)


# ---------------------------------------------------------------------------
# ExtRotVel — 6-dof linear correction from forward matches
# ---------------------------------------------------------------------------


def ext_rot_vel(klm, vel: Tensor, zfm: float, loc_uncert: float,
                hub_reweight: float):
    """Weighted LS for the 6-dof increment (ExtRotVel,
    edge_tracker.cpp:1207-1301). Returns (ok, Wx, Rx, X)."""
    use = klm.valid & (klm.m_id >= 0)

    u_x = klm.ux
    u_y = klm.uy
    q_x = klm.px
    q_y = klm.py
    q0x = klm.p0x
    q0y = klm.p0y

    rho_t = 1.0 / (1.0 / klm.rho + vel[2])
    qt_x = q0x + rho_t * (vel[0] * zfm - vel[2] * q0x)
    qt_y = q0y + rho_t * (vel[1] * zfm - vel[2] * q0y)

    Phi = torch.stack([
        u_x * rho_t * zfm,
        u_y * rho_t * zfm,
        u_x * (-rho_t * q_x) + u_y * (-rho_t * q_y),
        -u_x * q_x * q_y / zfm - u_y * (zfm + q_y * q_y / zfm),
        +u_y * q_x * q_y / zfm + u_x * (zfm + q_x * q_x / zfm),
        -u_x * q_y + u_y * q_x,
    ], dim=-1)                                            # [K, 6]
    Y = u_x * (q_x - qt_x) + u_y * (q_y - qt_y)

    dqvel = u_x * (vel[0] * zfm - vel[2] * q0x) + \
        u_y * (vel[1] * zfm - vel[2] * q0y)
    s_y = torch.sqrt(klm.s_rho * klm.s_rho * dqvel * dqvel +
                     loc_uncert * loc_uncert)
    weight = torch.where(torch.abs(Y) > hub_reweight,
                         torch.abs(Y) / hub_reweight, torch.ones_like(Y))
    scale = torch.where(use, 1.0 / (s_y * weight), torch.zeros_like(Y))

    Phi_s = Phi * scale[:, None]
    Y_s = Y * scale
    JtJ = Phi_s.T @ Phi_s
    JtF = Phi_s.T @ Y_s

    Rx = pinv_sym(JtJ)
    X = Rx @ JtF
    ok = torch.all(torch.isfinite(X)) & torch.all(torch.isfinite(Rx))
    return ok, JtJ, Rx, X


# ---------------------------------------------------------------------------
# BiasCorrect — gyro fusion with random-walk bias
# ---------------------------------------------------------------------------


def _inv(A: Tensor) -> Tensor:
    return torch.linalg.inv_ex(A)[0]


def _solve(A: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.solve_ex(A, b)[0]


def _add_block(A: Tensor, r: slice, c: slice, B: Tensor) -> Tensor:
    """A copy of A with B added to A[r, c] (jnp's A.at[r, c].add(B))."""
    out = A.clone()
    out[r, c] += B
    return out


def bias_correct(X: Tensor, Wx: Tensor, Gb: Tensor, Wb: Tensor, Rg: Tensor,
                 Rb: Tensor):
    """Information-form fusion of the visual rotation with the gyro
    measurement + gyro-bias random walk (BiasCorrect,
    edge_tracker.cpp:1308-1338). Returns (X', Wx', Gb', Wb')."""
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    Wg = _inv(Rg)
    Wb = _inv(_inv(Wb) + Rb)

    Wxb = _add_block(Wx, slice(3, None), slice(3, None),
                     Wg @ (eye3 - _inv(Wg + Wb) @ Wg))
    iWgWb = _inv(Wg + Wb)

    X1 = Wx @ X
    X1 = torch.cat([X1[:3], X1[3:] + Wg @ iWgWb @ Wb @ Gb])
    Xn = _solve(Wxb, X1)

    Gb_n = iWgWb @ (Wg @ Xn[3:] + Wb @ Gb)
    Wb_n = Wg + Wb
    Wx_n = _add_block(Wx, slice(3, None), slice(3, None), Wg)
    return Xn, Wx_n, Gb_n, Wb_n


# ---------------------------------------------------------------------------
# ScaleEstimator — sliding windows + 7-state scale/gravity/bias filter
# ---------------------------------------------------------------------------


class ScaleWindows(NamedTuple):
    """Explicit state for the reference's ScaleEstimator statics
    (scaleestimator.cpp:41-44, 95-97)."""

    v_hist: Tensor   # [5, 3] rotated velocity window (newest first)
    dt_hist: Tensor  # [4]
    a_hist: Tensor   # [4, 3] rotated accel window (newest first)

    @staticmethod
    def init(dtype=torch.float32, device="cuda") -> "ScaleWindows":
        return ScaleWindows(
            v_hist=torch.zeros((5, 3), dtype=dtype, device=device),
            dt_hist=torch.zeros((4,), dtype=dtype, device=device),
            a_hist=torch.zeros((4, 3), dtype=dtype, device=device))


def est_acel_lsq4(win: ScaleWindows, vel: Tensor, R: Tensor,
                  dt: Tensor) -> Tuple[ScaleWindows, Tensor]:
    """5-frame LS slope of the rotated velocity window (EstAcelLsq4,
    scaleestimator.cpp:37-87). Returns (window', accel estimate)."""
    Rt = R.T
    rot_old = win.v_hist[:4] @ Rt.T          # rotate previous 4 entries
    v_hist = torch.cat([vel[None, :], rot_old], dim=0)
    dt_hist = torch.cat([win.dt_hist[1:], dt.reshape(1)])

    # T[0]=0; T[i+1]=T[i]+Dt[i] (oldest->newest spacing).
    T = torch.cat([torch.zeros(1, dtype=dt_hist.dtype, device=dt.device),
                   torch.cumsum(dt_hist, dim=0)])
    mt = torch.sum(T[1:]) / 5.0               # reference: mean of T[1..4]
    den = torch.sum((T - mt) ** 2)
    # v_hist newest-first pairs with T newest-first: T[4]..T[0].
    Tn = torch.flip(T, dims=(0,))
    vm = torch.mean(v_hist, dim=0)
    num = (v_hist - vm[None, :]).T @ (Tn - mt)
    acel = torch.where(den > 0, num / den, torch.zeros_like(vel))
    return win._replace(v_hist=v_hist, dt_hist=dt_hist), acel


def mean_acel4(win: ScaleWindows, s_acel: Tensor,
               R: Tensor) -> Tuple[ScaleWindows, Tensor]:
    """4-frame mean of rotated measured acceleration (MeanAcel4,
    scaleestimator.cpp:90-104)."""
    Rt = R.T
    rot_old = win.a_hist[:3] @ Rt.T
    a_hist = torch.cat([s_acel[None, :], rot_old], dim=0)
    return win._replace(a_hist=a_hist), torch.mean(a_hist, dim=0)


def _blocks(shape, blocks, like: Tensor) -> Tensor:
    """A fresh zero tensor of `shape` with each (rows, cols, value) of
    `blocks` written in (jnp's zeros(...).at[...].set chains)."""
    out = torch.zeros(shape, dtype=like.dtype, device=like.device)
    for r, c, v in blocks:
        out[r, c] = v
    return out


def _kagmek_problem(x: Tensor, a_s: Tensor, a_v: Tensor, G: float,
                    x_p: Tensor, Rv: Tensor, Rs: Tensor, Rg: Tensor,
                    Pp: Tensor, nll_logdet: bool = False):
    """JtJ/JtF of the 11-equation problem (Problem_KaGMEKBias,
    scaleestimator.cpp:122-190); see the JAX package for the optional
    log-det term."""
    dev, dt = x.device, x.dtype
    a = x[0]
    g = x[1:4]
    b = x[4:7]
    ca = torch.cos(a)
    sa = torch.sin(a)
    eye3 = torch.eye(3, dtype=dt, device=dev)

    da = x[0] - x_p[0]
    da = torch.where(da > math.pi, da - 2 * math.pi,
                     torch.where(da < -math.pi, da + 2 * math.pi, da))
    Rb = so3_exp(b)
    Rg_v = Rb @ g
    F = torch.cat([(a_s + g) * ca - a_v * sa,
                   (torch.dot(g, g) - G * G).reshape(1), da.reshape(1),
                   Rg_v - x_p[1:4], b - x_p[4:7]])

    z1 = torch.zeros(1, dtype=dt, device=dev)
    dFda = torch.cat([-(a_s + g) * sa - a_v * ca, z1, torch.ones_like(z1),
                      torch.zeros(6, dtype=dt, device=dev)])

    # Reference's Gx (transposed cross-product matrix, scaleestimator.cpp:150)
    Gx = -skew(Rg_v)

    dFdx1 = _blocks((11, 6), [
        (slice(0, 3), slice(0, 3), eye3 * ca),
        (3, slice(0, 3), 2.0 * g),
        (slice(5, 8), slice(0, 3), Rb),
        (slice(5, 8), slice(3, 6), Gx),
        (slice(8, 11), slice(3, 6), eye3)], x)

    Pz = sa * sa * Rv + ca * ca * Rs
    P = _blocks((11, 11), [(slice(0, 3), slice(0, 3), Pz), (3, 3, Rg),
                           (slice(4, 11), slice(4, 11), Pp)], x)
    W = _blocks((11, 11), [(slice(0, 3), slice(0, 3), _inv(Pz)),
                           (3, 3, 1.0 / Rg),
                           (slice(4, 11), slice(4, 11), _inv(Pp))], x)
    dPda = _blocks((11, 11), [(slice(0, 3), slice(0, 3),
                               2.0 * sa * ca * (Rv - Rs))], x)
    dWda = -W @ dPda @ W

    if nll_logdet:
        Wz = W[0:3, 0:3]
        dPz = dPda[0:3, 0:3]
        WdP = Wz @ dPz
        logdet_grad = 0.5 * torch.trace(WdP)
        logdet_fisher = 0.5 * torch.trace(WdP @ WdP)
    else:
        logdet_grad = torch.zeros((), dtype=dt, device=dev)
        logdet_fisher = torch.zeros((), dtype=dt, device=dev)

    jtj00 = (0.25 * F @ dWda @ P @ dWda @ F + dFda @ dWda @ F +
             dFda @ W @ dFda + logdet_fisher)
    col = 0.5 * dFdx1.T @ dWda @ F + dFdx1.T @ W @ dFda
    JtJ = torch.cat([
        torch.cat([jtj00.reshape(1), col])[None, :],
        torch.cat([col[:, None], dFdx1.T @ W @ dFdx1], dim=1)])

    JtF = torch.cat([
        (0.5 * F @ dWda @ F + dFda @ W @ F + logdet_grad).reshape(1),
        dFdx1.T @ W @ F])
    return JtJ, JtF


def _jacobi_scale(A: Tensor) -> Tensor:
    return torch.rsqrt(torch.clamp(torch.diagonal(A), min=1e-30))


def _solve_scaled(A: Tensor, b: Tensor) -> Tensor:
    """Jacobi-preconditioned SPD solve: the 7x7 systems here mix priors
    spanning ~9 orders of magnitude (bias info ~1e13 vs scale ~1e4),
    which defeats f32 pinv/solve without scaling."""
    d = _jacobi_scale(A)
    As = A * d[:, None] * d[None, :]
    return _solve(As, b * d) * d


def _inv_scaled(A: Tensor) -> Tensor:
    d = _jacobi_scale(A)
    As = A * d[:, None] * d[None, :]
    return _inv(As) * d[:, None] * d[None, :]


def _kagmek_transform(x: Tensor) -> Tensor:
    """Angle wrap + bias saturation (FunT_KaGMEKBias,
    scaleestimator.cpp:193)."""
    sat = 5e-1 / 25.0
    return torch.cat([
        torch.atan2(torch.sin(x[0]), torch.cos(x[0])).reshape(1),
        x[1:4],
        torch.clamp(x[4:7], -sat, sat),
    ])


def est_ka_gmek_bias(
    s_acel: Tensor, f_acel: Tensor, kP: Tensor, Rot: Tensor,
    X: Tensor, P: Tensor,
    Qg: Tensor, Qrot: Tensor, Qbias: Tensor, QKp: Tensor,
    Rg: Tensor, Rs: Tensor, Rv: Tensor,
    Wvw: Tensor, Xvw: Tensor, g_gravit: float,
    gn_iters: int = 20, nll_logdet: bool = False,
):
    """7-state {atan(scale), g, bias_v} filter (estKaGMEKBias,
    scaleestimator.cpp:200-318).

    Returns (K, X', P', g_est, b_est, Xvw').
    """
    dev, dt = X.device, X.dtype
    eye3 = torch.eye(3, dtype=dt, device=dev)
    # Linear predict.
    F = _blocks((7, 7), [(0, 0, kP), (slice(1, 4), slice(1, 4), Rot.T),
                         (slice(4, 7), slice(4, 7), eye3)], X)

    Gtmp = X[1:4]
    GProd = -skew(Gtmp)   # reference's transposed cross matrix

    Q = _blocks((7, 7), [
        (0, 0, QKp / (1.0 + torch.tan(X[0]) ** 2)),
        (slice(1, 4), slice(1, 4), GProd.T @ Qrot @ GProd + Qg),
        (slice(4, 7), slice(4, 7), Qbias)], X)

    Xp = F @ X
    Pp = F @ P @ F.T + Q

    # Nonlinear Gauss-Newton update, a fixed number of iterations.
    Xn = Xp
    for _ in range(gn_iters):
        JtJ, JtF = _kagmek_problem(Xn, s_acel, f_acel, g_gravit, Xp,
                                   Rv, Rs, Rg, Pp, nll_logdet=nll_logdet)
        h = _solve_scaled(JtJ, -JtF)
        Xn = _kagmek_transform(Xn + h)

    JtJ, _ = _kagmek_problem(Xn, s_acel, f_acel, g_gravit, Xp, Rv, Rs, Rg,
                             Pp, nll_logdet=nll_logdet)
    Pn = _inv_scaled(JtJ)

    # Scale guard (see the JAX package): clamp k = tan(alpha) to a sane
    # band, 1 on non-finite.
    k = torch.tan(Xn[0])
    k = torch.where(torch.isfinite(k) & (k > 0), torch.clamp(k, 1e-2, 1e3),
                    torch.ones_like(k))
    # a non-finite filter state resets to the prediction (NaN gate)
    x_ok = torch.all(torch.isfinite(Xn))
    Xn = torch.where(x_ok, Xn, Xp)
    Pn = torch.where(x_ok & torch.all(torch.isfinite(Pn)), Pn, Pp)
    g_est = Xn[1:4]
    b_est = Xn[4:7]

    # Correct the visual 6-dof state with the bias estimate
    # (scaleestimator.cpp:286-305).
    WVBias = JtJ[4:7, 4:7]
    Wb = _blocks((6, 6), [(slice(3, 6), slice(3, 6), WVBias)], X)
    wc = Xvw[3:] - b_est
    WXc = torch.cat([torch.zeros(3, dtype=dt, device=dev), WVBias @ wc])
    Xc = _solve(Wb + Wvw, Wvw @ Xvw + WXc)
    Xc = torch.where(torch.all(torch.isfinite(Xc)), Xc, Xvw)

    return k, Xn, Pn, g_est, b_est, Xc


def rotation_between(a: Tensor, b: Tensor) -> Tensor:
    """Rotation matrix taking direction a to direction b (the TooN
    SO3(a, b) constructor used for gravity alignment,
    rebvo_second_t.cpp:538-541)."""
    dev, dt = a.device, a.dtype
    an = a / torch.linalg.norm(a)
    bn = b / torch.linalg.norm(b)
    v = torch.linalg.cross(an, bn)
    c = torch.dot(an, bn)
    s2 = torch.dot(v, v)
    Vx = skew(v)
    eye = torch.eye(3, dtype=dt, device=dev)
    # Rodrigues for the rotation aligning an to bn; guarded antiparallel.
    big = s2 > 1e-12
    coef = torch.where(big, (1.0 - c) / torch.where(big, s2,
                                                    torch.ones_like(s2)),
                       torch.zeros_like(s2))
    R = eye + Vx + coef * (Vx @ Vx)
    # Antiparallel: rotate pi about any axis orthogonal to a.
    ortho = torch.where(torch.abs(an[0]) < 0.9, eye[0], eye[1])
    axis = torch.linalg.cross(an, ortho)
    axis = axis / torch.linalg.norm(axis)
    R_pi = so3_exp(axis * math.pi)
    # the JAX package's bound -1.0 + 1e-9 rounds to -1.0 in float32: the
    # test is c < -1, kept as it is
    limit = torch.full((), -1.0 + 1e-9, dtype=dt, device=dev)
    return torch.where(c < limit, R_pi, R)
