"""The port's kernels/stereo.py against the JAX package's, function by
function, on the same inputs, on the CPU.

The maps come from a rendered stereo pair of tests/test_stereo_step.py's
tilted plane at 376x240: both frames go through the port's fused
detector (the plain version of its CUDA kernel, whose mask equals the
JAX Pallas kernel's), with the cam0 map given depths near the truth and
a prior sigma. Both packages then get the same numpy maps. The scale
observers get a synthetic second view: the pair-anchored keylines moved
through a known motion with a known scale error and seeded noise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebvo_tpu.frontend.state import KeylineMap as JMap
from rebvo_tpu.kernels import stereo as jst
from rebvo_tpu_torch.convert import params_from_jax
from rebvo_tpu_torch.frontend.state import KeylineMap as TMap
from rebvo_tpu_torch.frontend.step import VOFrontend as TorchFrontend
from rebvo_tpu_torch.kernels import stereo as tst
from tests.test_stereo_step import BASELINE, SMALL, TILT, stereo_params

torch.set_num_threads(2)

# counted mismatch fraction allowed on the integer ladder's match ids
# (floor(x + 0.5) of a candidate pixel can flip at float32 roundoff)
MISMATCH = 0.005


def _jmap(klm: TMap) -> JMap:
    return JMap(**{f: jnp.asarray(getattr(klm, f).numpy())
                   for f in TMap._fields})


def _tmap(arrays: dict) -> TMap:
    return TMap(**{f: torch.as_tensor(np.asarray(a)) for f, a in
                   arrays.items()})


def _np(klm) -> dict:
    return {f: np.array(getattr(klm, f)) for f in TMap._fields}


@pytest.fixture(scope="module")
def pair():
    """The cam0 map (depths 3% off the truth, sigma 20%), the cam1 map and
    id mask, and the pair's extrinsics and cameras."""
    from tests.render import render_plane_seq
    p = params_from_jax(stereo_params())
    pos0 = np.zeros((1, 3))
    f0, depth = render_plane_seq(1, cam_positions=pos0, plane_normal=TILT,
                                 return_depth=True, **SMALL)
    f1 = render_plane_seq(1, cam_positions=pos0 + [BASELINE, 0.0, 0.0],
                          plane_normal=TILT, **SMALL)
    fe = TorchFrontend(p, device="cpu")
    st = fe.init()
    klm0, _, _, _, _ = fe._detect(st, torch.as_tensor(f0[0]))
    klm1, mask1, _, _, _ = fe._detect_pair(st, torch.as_tensor(f1[0]))
    rng = np.random.default_rng(0)
    x = np.clip(np.round(klm0.x.numpy()).astype(int), 0, SMALL["width"] - 1)
    y = np.clip(np.round(klm0.y.numpy()).astype(int), 0, SMALL["height"] - 1)
    rho = (1.0 / depth[0][y, x]) * (1.03 + 0.02 * rng.standard_normal(
        x.shape))
    klm0 = klm0._replace(rho=torch.as_tensor(rho, dtype=torch.float32),
                         s_rho=torch.as_tensor(0.2 * rho,
                                               dtype=torch.float32))
    return dict(fe=fe, klm0=klm0, klm1=klm1, mask1=mask1, cam=fe.cam,
                cp=fe.cam_pair, R01=fe._R01, t01=fe._t01, p=p)


def _match_kw(d, prior_window):
    p, cam, cp = d["p"], d["cam"], d["cp"]
    return dict(zf0=cam.zfm, zf1=cp.zfm, cx1=cp.cx, cy1=cp.cy,
                width=cam.width, height=cam.height,
                max_steps=p.StereoMatchMaxSteps,
                min_thr_mod=p.MatchThreshModule,
                min_thr_ang=p.MatchThreshAngle,
                max_radius=float(p.StereoSearchRange),
                loc_uncertainty=p.LocationUncertaintyMatch,
                prior_window=prior_window)


@pytest.fixture(scope="module")
def matches(pair):
    """Both packages' directed_matching_stereo, prior-free and windowed."""
    d = pair
    out = {}
    for pw in (False, True):
        kw = _match_kw(d, pw)
        t = tst.directed_matching_stereo(d["klm0"], d["klm1"], d["mask1"],
                                         d["t01"], d["R01"], **kw)
        j = jst.directed_matching_stereo(
            _jmap(d["klm0"]), _jmap(d["klm1"]),
            jnp.asarray(d["mask1"].numpy()), jnp.asarray(d["t01"].numpy()),
            jnp.asarray(d["R01"].numpy()), **kw)
        out[pw] = (t, j)
    return out


@pytest.mark.parametrize("prior_window", [False, True],
                         ids=["prior_free", "prior_window"])
def test_directed_matching_stereo_matches_jax(matches, prior_window):
    """stereo_m_id equal up to a counted mismatch fraction of 0.5% of the
    valid keylines (measured 0.0 on both searches), nmatch within the
    same fraction, and stereo_rho / stereo_s_rho within 1e-4 relative
    where both packages matched to the same keyline (measured 2.6e-5 and
    1.2e-7)."""
    t, j = matches[prior_window]
    valid = t.klm.valid.numpy()
    mt, mj = t.stereo_m_id.numpy(), np.asarray(j.stereo_m_id)
    n_valid = int(valid.sum())
    assert int(j.nmatch) > 1000
    frac = float(np.sum((mt != mj) & valid)) / n_valid
    assert frac <= MISMATCH, frac
    assert abs(int(t.nmatch) - int(j.nmatch)) <= MISMATCH * n_valid
    both = (mt >= 0) & (mt == mj) & valid
    np.testing.assert_allclose(t.stereo_rho.numpy()[both],
                               np.asarray(j.stereo_rho)[both], rtol=1e-4)
    np.testing.assert_allclose(t.stereo_s_rho.numpy()[both],
                               np.asarray(j.stereo_s_rho)[both], rtol=1e-4)


def test_prior_window_narrows_the_search(matches):
    """The windowed search (the reference's) and the prior-free one (the
    default) are different searches, in both packages alike."""
    t_free, _ = matches[False]
    t_win, j_win = matches[True]
    assert not torch.equal(t_free.stereo_m_id, t_win.stereo_m_id)
    np.testing.assert_array_equal(t_win.stereo_m_id.numpy(),
                                  np.asarray(j_win.stereo_m_id))


def test_stereo_depth_matches_jax(pair, matches):
    """rho and I_rho of the matched pairs within 1e-5 relative
    (measured 0.0)."""
    d = pair
    t, _ = matches[False]
    m = t.stereo_m_id.numpy() >= 0
    ms = np.maximum(t.stereo_m_id.numpy(), 0)
    k0, k1 = d["klm0"], d["klm1"]
    args = [k0.px.numpy(), k0.py.numpy(), k1.ux.numpy()[ms],
            k1.uy.numpy()[ms], k1.px.numpy()[ms], k1.py.numpy()[ms]]
    cam, cp, lu = d["cam"], d["cp"], d["p"].LocationUncertaintyMatch
    rt, it = tst.stereo_depth(*[torch.as_tensor(a) for a in args],
                              d["R01"], d["t01"], cam.zfm, cp.zfm, lu)
    rj, ij = jst.stereo_depth(*[jnp.asarray(a) for a in args],
                              jnp.asarray(d["R01"].numpy()),
                              jnp.asarray(d["t01"].numpy()),
                              jnp.float32(cam.zfm), jnp.float32(cp.zfm), lu)
    np.testing.assert_allclose(rt.numpy()[m], np.asarray(rj)[m], rtol=1e-5)
    np.testing.assert_allclose(it.numpy()[m], np.asarray(ij)[m], rtol=1e-5)


def test_fuse_stereo_depth_matches_jax(pair, matches):
    """The fused map's rho, s_rho, rho0 and s_rho0 within 1e-6
    (measured 3.6e-7)."""
    t, _ = matches[False]
    klm = pair["klm0"]
    ft = tst.fuse_stereo_depth(klm, t.stereo_m_id, t.stereo_rho,
                               t.stereo_s_rho)
    fj = jst.fuse_stereo_depth(_jmap(klm), jnp.asarray(t.stereo_m_id),
                               jnp.asarray(t.stereo_rho),
                               jnp.asarray(t.stereo_s_rho))
    for f in ("rho", "s_rho", "rho0", "s_rho0"):
        np.testing.assert_allclose(getattr(ft, f).numpy(),
                                   np.asarray(getattr(fj, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                      np.float32)


def _project(px, py, rho, R, V, zfm):
    """Hom coords of the points (px, py, 1/rho) after X' = R X + V."""
    z = 1.0 / rho
    X = np.stack([px * z / zfm, py * z / zfm, z])
    Y = R @ X + V[:, None]
    return Y[0] * zfm / Y[2], Y[1] * zfm / Y[2]


@pytest.fixture(scope="module")
def second_view(pair, matches):
    """The anchored cam0 map (rho_st = the pair depths) and a second view
    of it through (R, V_true): each keyline moved along its gradient by
    its predicted normal displacement plus 0.1 px of seeded noise. The
    map seen with V = V_true / 1.3 must read a scale near 1.3."""
    d = pair
    t, _ = matches[False]
    zfm = d["cam"].zfm
    old = _np(d["klm0"])
    has = (t.stereo_m_id.numpy() >= 0) & old["valid"]
    old["anchored"] = has
    old["rho_st"] = np.where(has, t.stereo_rho.numpy(), 0.0).astype(
        np.float32)
    rng = np.random.default_rng(1)
    R = _rot_y(0.01)
    V = np.asarray([0.06, 0.01, 0.02], np.float32)
    rho = np.maximum(old["rho_st"], 1e-3)
    qx, qy = _project(old["px"], old["py"], rho, R, V, zfm)
    new = dict(old)
    new["px"] = (qx + 0.1 * rng.standard_normal(qx.shape)).astype(
        np.float32)
    new["py"] = (qy + 0.1 * rng.standard_normal(qy.shape)).astype(
        np.float32)
    new["m_id"] = np.where(old["valid"], np.arange(old["valid"].size),
                           -1).astype(np.int32)
    # anchors: the old positions and pair depths, seen again through
    # the accumulated motion
    anch = dict(new)
    anch["ax"], anch["ay"] = old["px"], old["py"]
    anch["arho"] = old["rho_st"]
    return dict(old=old, new=new, anch=anch, R=R, V=V, zfm=zfm)


def test_velocity_scale_refine_matches_jax(second_view):
    """The old map rotated into the new frame and the velocity 1.3x too
    short: s within 1e-4 of JAX's (and near 1.3), n_used equal
    (measured: equal, s = 1.2985, 702 used)."""
    sv = second_view
    zfm = sv["zfm"]
    old = dict(sv["old"])
    old["px"], old["py"] = _project(old["px"], old["py"],
                                    np.ones_like(old["px"]), sv["R"],
                                    np.zeros(3, np.float32), zfm)
    old["px"] = old["px"].astype(np.float32)
    old["py"] = old["py"].astype(np.float32)
    V = sv["V"] / 1.3
    st, nt = tst.velocity_scale_refine(_tmap(sv["new"]), _tmap(old),
                                       torch.as_tensor(V), zfm)
    sj, nj = jst.velocity_scale_refine(
        JMap(**{f: jnp.asarray(a) for f, a in sv["new"].items()}),
        JMap(**{f: jnp.asarray(a) for f, a in old.items()}),
        jnp.asarray(V), zfm)
    assert int(nt) == int(nj) > 100
    assert abs(float(st) - float(sj)) <= 1e-4
    assert abs(float(sj) - 1.3) < 0.1


@pytest.mark.parametrize("case", ["anchored", "no_use"])
def test_anchor_scale_measure_matches_jax(second_view, case):
    """aV 1.3x too short: s within 1e-4 of JAX's (and near 1.3), n_used
    equal, b_med within 1e-4 (measured 3.6e-7, 1410 used, b_med
    equal). With no anchored keyline (arho = 0, no
    use) the 6x6 system carries only its 1e-4 ridge and both packages
    give s = 1, n_used = 0."""
    sv = second_view
    anch = dict(sv["anch"])
    if case == "no_use":
        anch["arho"] = np.zeros_like(anch["arho"])
    aV = sv["V"] / 1.3
    st, nt, bt = tst.anchor_scale_measure(
        _tmap(anch), torch.as_tensor(sv["R"]), torch.as_tensor(aV),
        sv["zfm"])
    sj, nj, bj = jst.anchor_scale_measure(
        JMap(**{f: jnp.asarray(a) for f, a in anch.items()}),
        jnp.asarray(sv["R"]), jnp.asarray(aV), sv["zfm"])
    assert int(nt) == int(nj)
    assert abs(float(st) - float(sj)) <= 1e-4
    assert abs(float(bt) - float(bj)) <= 1e-4
    if case == "no_use":
        assert float(st) == float(sj) == 1.0 and int(nt) == 0
    else:
        assert int(nj) > 100
        assert abs(float(sj) - 1.3) < 0.1
