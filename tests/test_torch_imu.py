"""The port's visual-inertial filter functions (rebvo_tpu_torch/frontend/
imu.py) against the JAX package's, one function at a time, on seeded
numpy inputs in float32. The port runs them on the CPU here; the same
code runs on the card (no host reads, `inv_ex`/`solve_ex`, and a
fixed-sweep Jacobi pseudo-inverse in place of jnp.linalg.pinv).
"""

from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebvo_tpu.frontend import imu as J
from rebvo_tpu_torch.frontend import imu as T

torch.set_num_threads(2)

F32 = np.float32


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close(a, b, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=atol, err_msg=msg)


def _rot(rng, scale=1.0):
    w = rng.normal(0, scale, size=3)
    K = np.asarray([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    th = np.linalg.norm(w)
    return (np.eye(3) + np.sin(th) / th * K +
            (1 - np.cos(th)) / th ** 2 * K @ K).astype(F32)


def _spd(rng, n, scale):
    A = rng.normal(size=(n, n))
    return ((A @ A.T + n * np.eye(n)) * scale).astype(F32)


# ---------------------------------------------------------------------------
# integrate_window
# ---------------------------------------------------------------------------

S = 12


@pytest.mark.parametrize("count", [0, 1, 7, S])
def test_integrate_window(count):
    """Every field of IntegratedImu within 2e-6 absolute (rates ~0.5
    rad/s, accelerations ~10 m/s^2, rotations O(1)), for an empty, a
    one-sample, a partial and a full window, IMU mounted rotated and
    offset."""
    rng = np.random.default_rng(count)
    gyro = rng.normal(0, 0.5, (S, 3)).astype(F32)
    accel = (rng.normal(0, 1.0, (S, 3)) + [0, -9.8, 0]).astype(F32)
    R, Tc = _rot(rng), rng.normal(0, 0.1, 3).astype(F32)
    cnt, ts = np.int32(count), F32(0.005)
    a = J.integrate_window(J.ImuWindow(*_j(gyro, accel, cnt, ts)),
                           *_j(R, Tc))
    b = T.integrate_window(T.ImuWindow(*_t(gyro, accel, cnt, ts)),
                           *_t(R, Tc))
    for f in a._fields:
        _close(getattr(a, f), getattr(b, f), 0, 2e-6, f)
    if count == 0:
        np.testing.assert_array_equal(b.Rot.numpy(), np.eye(3, dtype=F32))


# ---------------------------------------------------------------------------
# pinv_sym / ext_rot_vel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [6, 4, 0])
def test_pinv_sym_matches_jnp_pinv(rank):
    """The Jacobi pseudo-inverse against jnp.linalg.pinv (SVD, cutoff
    10*n*eps relative): within 1e-3 of the largest entry, for full rank
    (condition ~1e4), rank 4, and the zero matrix (pinv = 0)."""
    rng = np.random.default_rng(rank)
    A = (rng.normal(size=(40, rank)) @ rng.normal(size=(rank, 6))
         * [1e2, 1e2, 1, 10, 10, 3]).astype(F32)
    M = (A.T @ A).astype(F32)
    a = np.asarray(jnp.linalg.pinv(jnp.asarray(M)))
    b = T.pinv_sym(torch.as_tensor(M)).numpy()
    assert b.dtype == np.float32
    tol = 1e-3 * max(np.abs(a).max(), 1e-30)
    np.testing.assert_allclose(b, a, rtol=0, atol=tol)
    if rank == 0:
        np.testing.assert_array_equal(b, np.zeros((6, 6), F32))


def test_eigh_jacobi_reconstructs():
    """Eigenpairs of a symmetric matrix of condition 1e10 reconstruct it,
    and give its eigenvalues, to 1e-12 of the largest in float64 after
    the default sweeps."""
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    lam = np.logspace(0, 10, 6)
    A = (Q * lam) @ Q.T
    w, V = T.eigh_jacobi(torch.as_tensor(A))
    rec = (V.numpy() * w.numpy()) @ V.numpy().T
    assert np.abs(rec - A).max() < 1e-12 * lam.max()
    np.testing.assert_allclose(np.sort(w.numpy()), lam, rtol=0,
                               atol=1e-12 * lam.max())


Klm = namedtuple("Klm", "valid m_id ux uy px py p0x p0y rho s_rho")


def _klm(rng, K, matched):
    ang = rng.uniform(0, 2 * np.pi, K)
    px = rng.uniform(-180, 180, K)
    py = rng.uniform(-120, 120, K)
    return dict(
        valid=np.ones(K, bool),
        m_id=np.where(np.arange(K) < matched, np.arange(K), -1).astype(
            np.int32),
        ux=np.cos(ang).astype(F32), uy=np.sin(ang).astype(F32),
        px=px.astype(F32), py=py.astype(F32),
        p0x=(px + rng.normal(0, 1.5, K)).astype(F32),
        p0y=(py + rng.normal(0, 1.5, K)).astype(F32),
        rho=rng.uniform(0.2, 2.0, K).astype(F32),
        s_rho=rng.uniform(0.01, 0.5, K).astype(F32))


@pytest.mark.parametrize("matched", [900, 0], ids=["matches", "no_matches"])
def test_ext_rot_vel(matched):
    """ok equal; Wx (JtJ) within 1e-5 relative; Rx within 1e-3 of its
    largest entry and X within 1e-3 relative (the pinv's float32 error
    against the SVD's). With no match JtJ = 0, so Rx = 0, X = 0 and
    ok = True in both (an inverse would give inf and flip ok)."""
    d = _klm(np.random.default_rng(matched), 1000, matched)
    vel = np.asarray([0.01, -0.004, 0.002], F32)
    args = (200.0, 1.0, 2.0)
    oa, Wa, Ra, Xa = J.ext_rot_vel(Klm(**{k: jnp.asarray(v) for k, v in
                                          d.items()}),
                                   jnp.asarray(vel), *args)
    ob, Wb, Rb, Xb = T.ext_rot_vel(Klm(**{k: torch.as_tensor(v) for k, v in
                                          d.items()}),
                                   torch.as_tensor(vel), *args)
    assert bool(oa) == bool(ob)
    _close(Wa, Wb, 1e-5, 1e-6 * float(np.abs(np.asarray(Wa)).max()))
    ra = np.asarray(Ra)
    _close(Ra, Rb, 0, 1e-3 * max(np.abs(ra).max(), 1e-30))
    _close(Xa, Xb, 1e-3, 1e-6)
    if matched == 0:
        assert bool(ob)
        np.testing.assert_array_equal(Rb.numpy(), np.zeros((6, 6), F32))
        np.testing.assert_array_equal(Xb.numpy(), np.zeros(6, F32))


# ---------------------------------------------------------------------------
# bias_correct, the scale windows
# ---------------------------------------------------------------------------


def test_bias_correct():
    """All four outputs within 1e-4 relative (information matrices
    spanning 1e2-1e12)."""
    rng = np.random.default_rng(1)
    X = rng.normal(0, 1e-2, 6).astype(F32)
    Wx = _spd(rng, 6, 1e4)
    Gb = rng.normal(0, 1e-4, 3).astype(F32)
    Wb = _spd(rng, 3, 1e8)
    Rg = _spd(rng, 3, 1e-9)
    Rb = _spd(rng, 3, 1e-11)
    a = J.bias_correct(*_j(X, Wx, Gb, Wb, Rg, Rb))
    b = T.bias_correct(*_t(X, Wx, Gb, Wb, Rg, Rb))
    for x, y, name in zip(a, b, ("X", "Wx", "Gb", "Wb")):
        _close(x, y, 1e-4, 1e-7 * float(np.abs(np.asarray(x)).max()), name)


@pytest.mark.parametrize("zero_dt", [False, True], ids=["dt", "den_zero"])
def test_est_acel_lsq4_and_mean_acel4(zero_dt):
    """The velocity-slope window and the accel mean within 1e-5 relative;
    with every dt zero (den = 0) the slope is 0 in both."""
    rng = np.random.default_rng(2)
    win = dict(v_hist=rng.normal(0, 0.3, (5, 3)).astype(F32),
               dt_hist=(np.zeros(4) if zero_dt else
                        rng.uniform(0.04, 0.06, 4)).astype(F32),
               a_hist=rng.normal(0, 1, (4, 3)).astype(F32))
    vel = rng.normal(0, 0.3, 3).astype(F32)
    R = _rot(rng)
    dt = F32(0.0 if zero_dt else 0.05)
    s_acel = rng.normal(0, 1, 3).astype(F32)
    wa = J.ScaleWindows(*_j(*win.values()))
    wb = T.ScaleWindows(*_t(*win.values()))
    wa1, aa = J.est_acel_lsq4(wa, *_j(vel, R, dt))
    wb1, ab = T.est_acel_lsq4(wb, *_t(vel, R, dt))
    _close(aa, ab, 1e-5, 1e-6)
    if zero_dt:
        np.testing.assert_array_equal(ab.numpy(), np.zeros(3, F32))
    wa2, ma = J.mean_acel4(wa1, *_j(s_acel, R))
    wb2, mb = T.mean_acel4(wb1, *_t(s_acel, R))
    _close(ma, mb, 1e-5, 1e-6)
    for f in wa2._fields:
        _close(getattr(wa2, f), getattr(wb2, f), 1e-5, 1e-6, f)


# ---------------------------------------------------------------------------
# The 7-state scale/gravity/bias filter
# ---------------------------------------------------------------------------


def _filter_inputs(seed):
    """Inputs of the size step_imu gives the filter after its start."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 0.5, 3)
    return dict(
        s_acel=(a + [0, -9.8, 0] + rng.normal(0, 0.01, 3)).astype(F32),
        f_acel=(0.8 * a + rng.normal(0, 0.02, 3)).astype(F32),
        kP=F32(1.0), Rot=_rot(rng, 0.01),
        X=np.asarray([0.7, 0.05, 9.79, -0.02, 1e-3, -2e-3, 5e-4], F32),
        P=np.diag([2e-3, 0.5, 0.5, 0.5, 1e-12, 1e-12, 1e-12]).astype(F32),
        Qg=(np.eye(3) * 4e-6).astype(F32),
        Qrot=_spd(rng, 3, 1e-9), Qbias=(np.eye(3) * 1e-14).astype(F32),
        QKp=F32(5e-6), Rg=F32(4e4), Rs=(np.eye(3) * 4e-6).astype(F32),
        Rv=_spd(rng, 3, 0.05),
        Wvw=_spd(rng, 6, 1e5), Xvw=rng.normal(0, 1e-2, 6).astype(F32))


@pytest.mark.parametrize("logdet", [False, True])
def test_kagmek_problem(logdet):
    """JtJ and JtF of the 11-equation problem within 1e-4 relative of
    their largest entry, for both nll_logdet settings."""
    d = _filter_inputs(3)
    x = d["X"] + np.asarray([0.05, 0.1, -0.05, 0.1, 1e-3, 0, -1e-3], F32)
    args = (d["s_acel"], d["f_acel"])
    rest = (d["X"], d["Rv"], d["Rs"], d["Rg"], _spd(np.random.default_rng(4),
                                                    7, 1e-3))
    a = J._kagmek_problem(jnp.asarray(x), *_j(*args), 9.8, *_j(*rest),
                          nll_logdet=logdet)
    b = T._kagmek_problem(torch.as_tensor(x), *_t(*args), 9.8, *_t(*rest),
                          nll_logdet=logdet)
    for x_, y_ in zip(a, b):
        _close(x_, y_, 0, 1e-4 * float(np.abs(np.asarray(x_)).max()))


@pytest.mark.parametrize("logdet", [False, True])
def test_est_ka_gmek_bias(logdet):
    """K within 1e-3 relative, the filter state within 1e-3 absolute
    (alpha, g ~ 9.8) and the bias-corrected 6-dof state within 1e-4
    relative, after 20 Gauss-Newton iterations from the same prediction
    (well-conditioned inputs: the filter's own float32 error grows where
    the scale is barely observable, see test_torch_vi_step)."""
    d = _filter_inputs(5)
    a = J.est_ka_gmek_bias(*_j(*list(d.values())), 9.8, nll_logdet=logdet)
    b = T.est_ka_gmek_bias(*_t(*list(d.values())), 9.8, nll_logdet=logdet)
    k_a, X_a, P_a, g_a, b_a, Xc_a = a
    k_b, X_b, P_b, g_b, b_b, Xc_b = b
    _close(k_a, k_b, 1e-3)
    _close(X_a, X_b, 0, 1e-3)
    _close(g_a, g_b, 0, 1e-3)
    _close(b_a, b_b, 0, 1e-6)
    _close(np.diag(np.asarray(P_a)), np.diag(P_b.numpy()), 2e-2)
    _close(Xc_a, Xc_b, 1e-4, 1e-7)


def test_est_ka_gmek_bias_nonfinite_state_resets():
    """A non-finite Gauss-Newton state resets to the prediction: with a
    NaN accel measurement both give X' = F X (the predicted state) and
    P' = the predicted covariance, within 1e-6 relative, and K = 1."""
    d = _filter_inputs(6)
    d["s_acel"] = np.asarray([np.nan, -9.8, 0.0], F32)
    k_a, X_a, P_a, *_ = J.est_ka_gmek_bias(*_j(*list(d.values())), 9.8)
    k_b, X_b, P_b, *_ = T.est_ka_gmek_bias(*_t(*list(d.values())), 9.8)
    assert float(k_a) == float(k_b) == 1.0
    _close(X_a, X_b, 1e-6)               # F @ X, one float32 rounding
    assert np.all(np.isfinite(X_b.numpy()))
    _close(P_a, P_b, 1e-6, 1e-20)


# ---------------------------------------------------------------------------
# rotation_between
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "parallel", "antiparallel",
                                  "antiparallel_y", "nearly_antiparallel"])
def test_rotation_between(case):
    """The rotation taking a to b within 1e-5 of JAX's. The antiparallel
    branch is taken only where cos(a, b) < -1 in float32 (the JAX
    package's bound -1 + 1e-9 rounds to -1), so an exactly antiparallel
    pair gets the Rodrigues branch with a zero axis: the identity, in
    both packages."""
    rng = np.random.default_rng(7)
    a = rng.normal(size=3).astype(F32)
    b = {"random": rng.normal(size=3), "parallel": 2.0 * a,
         "antiparallel": -3.0 * a,
         "nearly_antiparallel": -a + [0.0, 1e-4, 0.0]}.get(case)
    if case == "antiparallel_y":
        a = np.asarray([0.95, 0.1, 0.0], F32)
        b = -a
    b = np.asarray(b, F32)
    Ra = np.asarray(J.rotation_between(*_j(a, b)))
    Rb = T.rotation_between(*_t(a, b)).numpy()
    np.testing.assert_allclose(Rb, Ra, atol=1e-5)
    an, bn = a / np.linalg.norm(a), b / np.linalg.norm(b)
    if case.startswith("antiparallel"):
        np.testing.assert_allclose(Rb, np.eye(3), atol=1e-6)
    else:
        np.testing.assert_allclose(Rb @ an, bn, atol=2e-3)
