"""Per-module parity of the PyTorch port against the JAX package.

Every case feeds the same numpy inputs to both packages. The inputs are
realistic: the keyline maps, the match field and the pose of a rendered
billboard sequence after the JAX bootstrap and two steps (UsePallas=0,
the XLA chain), at 188x120. Integer outputs (field ids, match ids,
chain links) must be equal unless a case states a counted mismatch
fraction; float outputs meet the stated tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebvo_tpu.backend import kfvo as jkfvo
from rebvo_tpu.config import REBVOParameters
from rebvo_tpu.core import geometry as jgeo
from rebvo_tpu.core import stats as jstats
from rebvo_tpu.frontend import kf_tracking as jkf
from rebvo_tpu.frontend.step import VOFrontend
from rebvo_tpu.io.render import render_billboards_seq
from rebvo_tpu.kernels import depth_filter as jdf
from rebvo_tpu.kernels import field as jfield
from rebvo_tpu.kernels import matching as jmatch
from rebvo_tpu.kernels import pose_solver as jps
from rebvo_tpu_torch.backend import kfvo as tkfvo
from rebvo_tpu_torch.core import geometry as tgeo
from rebvo_tpu_torch.core import stats as tstats
from rebvo_tpu_torch.core.numerics import to_int32
from rebvo_tpu_torch.frontend import kf_tracking as tkf
from rebvo_tpu_torch.frontend.state import KeylineMap
from rebvo_tpu_torch.kernels import depth_filter as tdf
from rebvo_tpu_torch.kernels import field as tfield
from rebvo_tpu_torch.kernels import matching as tmatch
from rebvo_tpu_torch.kernels import pose_solver as tps

torch.set_num_threads(2)

W, H, ZF, CX, CY = 188, 120, 100.0, 94.0, 60.0


def T(a):
    """numpy / JAX array -> CPU torch tensor (same dtype)."""
    return torch.as_tensor(np.array(a))


def TK(klm) -> KeylineMap:
    return KeylineMap(*[T(a) for a in klm])


def N(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def scene():
    """JAX state after bootstrap + 2 steps, plus frame 3's detection."""
    p = REBVOParameters().replace(
        ImageWidth=W, ImageHeight=H, ZfX=ZF, ZfY=ZF, PPx=CX, PPy=CY,
        KcR2=0.0, KcR4=0.0, KcP1=0.0, KcP2=0.0, KeylineMax=2048,
        MaxPoints=2048, ReferencePoints=800, TrackPoints=2048,
        GlobalMatchThreshold=50, DetectorThresh=0.03, DetectorAutoGain=1e-6,
        UsePallas=0)
    n = 4
    pos = np.zeros((n, 3))
    pos[:, 0] = np.arange(n) * 0.02
    frames = render_billboards_seq(n, width=W, height=H, zf=ZF, cx=CX,
                                   cy=CY, cam_positions=pos, ss=1)
    fe = VOFrontend(p)
    st = fe.bootstrap(fe.init(), jnp.asarray(frames[0]), jnp.asarray(0.0))
    for i in (1, 2):
        st, _ = fe.step(st, jnp.asarray(frames[i]), jnp.asarray(i / 20.0))
    det = fe._front(st, jnp.asarray(frames[3]))
    new_klm, _, _, _, retuned, s_rho_q, fv, field_img = det
    cam = fe.cam
    kw = dict(zfm=cam.zfm, cx=cam.cx, cy=cam.cy, width=W, height=H,
              match_thresh=p.TrackerMatchThresh, max_s_rho=s_rho_q,
              match_num_min=jnp.asarray(0, jnp.int32),
              k_huber=p.ReweigthDistance)
    mres = jps.minimizer_rv(st.Vel, st.W0, st.klm, fv, max_r=40.0,
                            iter_max=5, init_iter=2, init_type=2, **kw)
    return dict(p=p, fe=fe, st=st, new=new_klm, retuned=retuned,
                s_rho_q=s_rho_q, fv=fv, field=field_img, kw=kw, mres=mres)


def _tkw(kw):
    return {k: (T(v) if isinstance(v, jax.Array) else v)
            for k, v in kw.items()}


# ---------------------------------------------------------------------------
# geometry and stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-7, 1e-2, 1.0, 3.1405])
def test_so3_roundtrip_matches_jax(scale):
    """Float32 SO(3) maps, atol 2e-6 (transcendental ulp differences)."""
    w = (np.random.default_rng(0).normal(size=(16, 3)) * scale).astype(
        np.float32)
    for fj, ft in ((jgeo.so3_exp, tgeo.so3_exp), (jgeo.skew, tgeo.skew)):
        np.testing.assert_allclose(np.asarray(fj(jnp.asarray(w))),
                                   N(ft(T(w))), atol=2e-6)
    R = np.asarray(jgeo.so3_exp(jnp.asarray(w)))
    for fj, ft in ((jgeo.so3_log, tgeo.so3_log),
                   (jgeo.rotation_to_quaternion,
                    tgeo.rotation_to_quaternion)):
        np.testing.assert_allclose(np.asarray(fj(jnp.asarray(R))),
                                   N(ft(T(R))), atol=2e-5 * max(scale, 1))


def test_keyline_transforms_and_camera_match_jax():
    rng = np.random.default_rng(1)
    px, py = (rng.uniform(-90, 90, 64).astype(np.float32) for _ in range(2))
    rho, s_rho = (rng.uniform(0.1, 2, 64).astype(np.float32)
                  for _ in range(2))
    R = np.asarray(jgeo.so3_exp(jnp.asarray([0.01, -0.02, 0.005],
                                            jnp.float32)))
    a = jgeo.rotate_hom_points(jnp.asarray(R), *map(jnp.asarray,
                                                    (px, py, rho, s_rho)),
                               ZF)
    b = tgeo.rotate_hom_points(T(R), *map(T, (px, py, rho, s_rho)), ZF)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), N(y), rtol=1e-6, atol=1e-5)
    cj = jgeo.CameraModel.make(458.6, 457.3, 367.2, 248.4, -0.28, 0.07,
                               0.0, 2e-4, 2e-5)
    ct = tgeo.CameraModel.make(458.6, 457.3, 367.2, 248.4, -0.28, 0.07,
                               0.0, 2e-4, 2e-5)
    assert tuple(cj) == tuple(ct)
    for m in ("distort_hom", "undistort_hom"):
        for x, y in zip(getattr(cj, m)(jnp.asarray(px), jnp.asarray(py)),
                        getattr(ct, m)(T(px), T(py))):
            np.testing.assert_allclose(np.asarray(x), N(y), rtol=1e-5,
                                       atol=1e-4)


def test_stats_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 101)).astype(np.float32)
    m = rng.uniform(size=(3, 101)) < 0.4
    m[2] = False
    for r in range(3):
        assert float(jstats.masked_median(jnp.asarray(x[r]),
                                          jnp.asarray(m[r]))) == \
            float(tstats.masked_median(T(x[r]), T(m[r])))
    mean = rng.uniform(0.5, 2, 8).astype(np.float32)
    dev = rng.uniform(0.05, 0.3, 8).astype(np.float32)
    for a, b in zip(jstats.eval_reciprocal(jnp.asarray(mean),
                                           jnp.asarray(dev)),
                    tstats.eval_reciprocal(T(mean), T(dev))):
        np.testing.assert_allclose(np.asarray(a), N(b), rtol=1e-5)


def test_float_to_int_matches_xla():
    x = np.asarray([np.nan, 1e10, -1e10, 2.7, -2.7, 2147483520.0, np.inf,
                    -np.inf, 0.5, -0.5], np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.asarray(x).astype(
        jnp.int32)), N(to_int32(T(x))))


# ---------------------------------------------------------------------------
# match field, pose solver, matching
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("radius", [6, 3])
def test_build_field_exact(scene, radius):
    a = jfield.build_field(scene["new"], scene["retuned"], radius=radius,
                           height=H, width=W)
    b = tfield.build_field(TK(scene["new"]), T(scene["retuned"]),
                           radius=radius, height=H, width=W)
    np.testing.assert_array_equal(np.asarray(a), N(b))
    assert (np.asarray(a) >= 0).sum() > 1000


def _fv(scene):
    return tps.FieldView(ikl=T(scene["fv"].ikl), attrs=T(scene["fv"].attrs))


@pytest.mark.parametrize("dx", [0.0, 0.01])
def test_try_vel_rot_matches_jax(scene, dx):
    """Score / JtJ / JtF at rtol 1e-4 (sum order); forward match ids at a
    counted mismatch fraction <= 0.5% (floor(x+0.5) at f32 roundoff)."""
    st = scene["st"]
    X = np.concatenate([np.asarray(st.Vel), np.asarray(st.W0)])
    X = (X + np.asarray([dx, 0, 0, 0, dx / 10, 0])).astype(np.float32)
    a = jps.try_vel_rot(jnp.asarray(X), st.klm, scene["fv"], None,
                        max_r=40.0, **scene["kw"])
    b = tps.try_vel_rot(T(X), TK(st.klm), _fv(scene), None,
                        **_tkw(scene["kw"]))
    np.testing.assert_allclose(float(a.score), float(b.score), rtol=1e-4)
    scale = float(np.abs(np.asarray(a.JtJ)).max())
    np.testing.assert_allclose(np.asarray(a.JtJ), N(b.JtJ), rtol=1e-4,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(np.asarray(a.JtF), N(b.JtF), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(a.JtF)).max())
    mism = (np.asarray(a.m_id_f) != N(b.m_id_f)).mean()
    assert mism <= 5e-3, mism
    assert (np.asarray(a.m_id_f) >= 0).sum() > 500


def test_minimizer_rv_matches_jax(scene):
    """The full LM (warm-start batch + ladder + main loop): [V; W] within
    2e-5 absolute (the LM's accept tests see f32 sum-order noise), forward
    matches at <= 1% mismatch, a singular-free covariance."""
    st = scene["st"]
    a = scene["mres"]
    b = tps.minimizer_rv(T(st.Vel), T(st.W0), TK(st.klm), _fv(scene),
                         iter_max=5, init_iter=2, init_type=2,
                         **_tkw(scene["kw"]))
    for f in ("Vel", "W0"):
        np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                   N(getattr(b, f)), atol=2e-5, err_msg=f)
    np.testing.assert_allclose(float(a.score), float(b.score), rtol=1e-3)
    assert (np.asarray(a.m_id_f) != N(b.m_id_f)).mean() <= 1e-2
    assert np.all(np.isfinite(N(b.RVel)))


def test_singular_solve_is_non_finite():
    """The step's nan_fail relies on a singular LM system giving
    non-finite values (solve_ex / inv_ex do not raise)."""
    z = torch.zeros(6, 6)
    assert not torch.isfinite(tps._solve_lm(z, torch.ones(6),
                                            torch.tensor(0.0))).all()
    assert not torch.isfinite(torch.linalg.inv_ex(z)[0]).all()


def test_minimizer_v_matches_jax(scene):
    st = scene["st"]
    kw = dict(scene["kw"], min_mod=scene["st"].retuned)
    a = jps.minimizer_v(st.Vel, st.klm, scene["fv"], max_r=40.0, iter_max=5,
                        **kw)
    b = tps.minimizer_v(T(st.Vel), TK(st.klm), _fv(scene), iter_max=5,
                        **_tkw(kw))
    np.testing.assert_allclose(np.asarray(a.Vel), N(b.Vel), atol=2e-5)
    assert (np.asarray(a.m_id_f) != N(b.m_id_f)).mean() <= 1e-2


def test_forward_match_exact(scene):
    st, m = scene["st"], scene["mres"].m_id_f
    a, na = jmatch.forward_match(st.klm, scene["new"], m)
    b, nb = tmatch.forward_match(TK(st.klm), TK(scene["new"]), T(m))
    assert int(na) == int(nb) > 500
    for f in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      N(getattr(b, f)), err_msg=f)


def _match_inputs(scene):
    st, mres = scene["st"], scene["mres"]
    fm, _ = jmatch.forward_match(st.klm, scene["new"], mres.m_id_f)
    R0 = jgeo.so3_exp(mres.W0)
    old_rot = scene["fe"]._rotate_map(st.klm, R0)
    return fm, old_rot, mres.Vel, mres.RVel, R0.T


@pytest.mark.parametrize("stride", [4, 0])
def test_directed_matching_matches_jax(scene, stride):
    """Field-sampled (stride 4, the default) and 1-px mask (stride 0)
    ladders: match ids at a counted mismatch fraction <= 0.5%, cloned
    depths equal where the ids agree."""
    st = scene["st"]
    fm, old_rot, V, RV, R = _match_inputs(scene)
    kw = dict(zfm=ZF, cx=CX, cy=CY, width=W, height=H, min_thr_mod=1.0,
              min_thr_ang=45.0, max_radius=40.0, loc_uncertainty=2.0)
    if stride:
        a = jmatch.directed_matching_field(fm, old_rot, st.field_img, V, RV,
                                           R, max_steps=13, stride=stride,
                                           **kw)
        b = tmatch.directed_matching_field(TK(fm), TK(old_rot),
                                           T(st.field_img), T(V), T(RV),
                                           T(R), max_steps=13,
                                           stride=stride, **kw)
    else:
        a = jmatch.directed_matching(fm, old_rot, st.mask_img, V, RV, R,
                                     max_steps=44, **kw)
        b = tmatch.directed_matching(TK(fm), TK(old_rot), T(st.mask_img),
                                     T(V), T(RV), T(R), max_steps=44, **kw)
    ma, mb = np.asarray(a.new.m_id), N(b.new.m_id)
    assert (ma != mb).mean() <= 5e-3
    assert abs(int(a.nmatch) - int(b.nmatch)) <= 0.005 * int(a.nmatch)
    assert int(a.nmatch) > 500
    same = ma == mb
    np.testing.assert_array_equal(np.asarray(a.new.rho)[same],
                                  N(b.new.rho)[same])


# ---------------------------------------------------------------------------
# depth filter
# ---------------------------------------------------------------------------


def test_depth_filter_matches_jax(scene):
    """regularize + EKF + rescaling + quantile on the matched map,
    rtol 1e-5 (elementwise f32), Kp at rtol 1e-5."""
    fm, old_rot, V, RV, R = _match_inputs(scene)
    dres = jmatch.directed_matching_field(
        fm, old_rot, scene["st"].field_img, V, RV, R, zfm=ZF, cx=CX, cy=CY,
        width=W, height=H, max_steps=13, stride=4, min_thr_mod=1.0,
        min_thr_ang=45.0, max_radius=40.0, loc_uncertainty=2.0)
    a, na = jdf.regularize_1_iter(dres.new, 0.5)
    b, nb = tdf.regularize_1_iter(TK(dres.new), 0.5)
    assert int(na) == int(nb) > 100
    a = jdf.depth_ekf(a, V, ZF, reshape_q_abs=1e-4, loc_uncertainty=1.0)
    b = tdf.depth_ekf(b, T(V), ZF, reshape_q_abs=1e-4, loc_uncertainty=1.0)
    for f in ("rho", "s_rho", "rho0", "s_rho0"):
        np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                   N(getattr(b, f)), rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    for apply in (False, True):
        ra = jdf.estimate_rescaling_opt(a, apply=apply)
        rb = tdf.estimate_rescaling_opt(b, apply=apply)
        np.testing.assert_allclose(float(ra[1]), float(rb[1]), rtol=1e-5)
        np.testing.assert_allclose(float(ra[2]), float(rb[2]), rtol=1e-4)
        np.testing.assert_allclose(np.asarray(ra[0].rho), N(rb[0].rho),
                                   rtol=2e-5)
    assert float(jdf.estimate_quantile(a)) == float(tdf.estimate_quantile(b))


# ---------------------------------------------------------------------------
# keyframe tracking
# ---------------------------------------------------------------------------


def _kf_inputs(scene):
    """A keyframe (the state's) and the frame map after forward matching."""
    st = scene["st"]
    fm, _, _, _, _ = _match_inputs(scene)
    return st.kf, fm, st.Pose, st.Pos


def TKF(kf):
    return tkf.KFCarry(klm=TK(kf.klm), Pose=T(kf.Pose), Pos=T(kf.Pos),
                       count=T(kf.count), age=T(kf.age), G=T(kf.G))


def test_chain_primitives_exact(scene):
    kf, klm, Pose, Pos = _kf_inputs(scene)
    a = jkf.invert_matches(klm.m_id, klm.valid, klm.K)
    b = tkf.invert_matches(T(klm.m_id), T(klm.valid), klm.K)
    np.testing.assert_array_equal(np.asarray(a), N(b))
    fa = jkf.build_forward_match(kf.klm.m_id_f, kf.klm.valid, a)
    fb = tkf.build_forward_match(T(kf.klm.m_id_f), T(kf.klm.valid), b)
    np.testing.assert_array_equal(np.asarray(fa), N(fb))
    np.testing.assert_array_equal(
        np.asarray(jkf.augment_matches(klm.m_id_kf, klm.p_id, klm.n_id, 4)),
        N(tkf.augment_matches(T(klm.m_id_kf), T(klm.p_id), T(klm.n_id), 4)))
    R, t = jkf.kf_relative_pose(kf, Pose, Pos + 0.05)
    E = jkf.essential_matrix(R, t)
    ca = jkf.chain_correct(klm.px, klm.py, klm.m_id_kf, kf.klm, E, ZF, 6)
    cb = tkf.chain_correct(T(klm.px), T(klm.py), T(klm.m_id_kf), TK(kf.klm),
                           T(E), ZF, 6)
    np.testing.assert_array_equal(np.asarray(ca[0]), N(cb[0]))


@pytest.mark.parametrize("reanchor", [0, 1])
def test_track_keyframe_matches_jax(scene, reanchor):
    """The whole TrackKeyFrames block, with and without the re-anchor
    (which runs a second LM): match counts within 1%, pose within 1e-5."""
    kf, klm, Pose, Pos = _kf_inputs(scene)
    p = scene["p"].replace(KFReAnchor=reanchor)
    cam = scene["fe"].cam
    Pos2 = Pos + jnp.asarray([0.03, 0.0, 0.0], jnp.float32)
    args = (Pose, Pos2, jnp.asarray(1.0, jnp.float32),
            jnp.asarray(int(klm.count), jnp.int32), scene["s_rho_q"],
            jnp.asarray(True), jnp.asarray(1.0, jnp.float32))
    a = jkf.track_keyframe(kf, klm, scene["fv"], *args, cam=cam, params=p)
    tcam = tgeo.CameraModel(*cam)
    b = tkf.track_keyframe(TKF(kf), TK(klm), _fv(scene), *map(T, args),
                           cam=tcam, params=p)
    assert int(a.kf.count) == int(b.kf.count)
    assert bool(a.saved) == bool(b.saved)
    assert abs(int(a.back_m) - int(b.back_m)) <= 0.01 * max(int(a.back_m), 1)
    assert abs(int(a.fow_m) - int(b.fow_m)) <= 0.01 * max(int(a.fow_m), 1)
    np.testing.assert_allclose(np.asarray(a.Pos), N(b.Pos), atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.Pose), N(b.Pose), atol=1e-5)
    assert (np.asarray(a.klm.m_id_kf) != N(b.klm.m_id_kf)).mean() <= 1e-2


def test_kfvo_transform_and_align_match_jax(scene):
    st = scene["st"]
    R = jgeo.so3_exp(jnp.asarray([0.0, 0.003, 0.0], jnp.float32))
    t = jnp.asarray([0.01, 0.0, 0.0], jnp.float32)
    a = jkfvo.transform_map(st.klm, R, t, ZF)
    b = tkfvo.transform_map(TK(st.klm), T(R), T(t), ZF)
    for f in ("px", "py", "rho", "s_rho", "gx", "gy"):
        np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                   N(getattr(b, f)), rtol=1e-5, atol=1e-4,
                                   err_msg=f)
    Ra, ta = jkfvo.relative_pose(st.Pose, st.Pos, st.Pose, st.Pos + 0.1)
    Rb, tb = tkfvo.relative_pose(T(st.Pose), T(st.Pos), T(st.Pose),
                                 T(st.Pos) + 0.1)
    np.testing.assert_allclose(np.asarray(ta), N(tb), atol=1e-6)
    kw = dict(zfm=ZF, cx=CX, cy=CY, width=W, height=H)
    aa = jkfvo.align_to_keyframe(st.klm, scene["fv"], R, t,
                                 max_s_rho=scene["s_rho_q"], **kw)
    ab = tkfvo.align_to_keyframe(TK(st.klm), _fv(scene), T(R), T(t),
                                 max_s_rho=T(scene["s_rho_q"]), **kw)
    np.testing.assert_allclose(np.asarray(aa.t), N(ab.t), atol=2e-5)
    np.testing.assert_allclose(np.asarray(aa.R), N(ab.R), atol=2e-5)
