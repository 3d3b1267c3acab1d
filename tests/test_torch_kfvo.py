"""The offline keyframe toolkit of the port (backend/kfvo.py:
refine_keyframe_depths, _proj_inv_depth, optimize_scale,
mutual_exclusion, count_kf_matches, keylines_in_fov) against the JAX
package's, on the scenes of tests/test_aux.py's kfvo cases: keyline maps
projected from 3D line segments at 752x480, and a keyframe seen from a
moved camera.

Integer outputs (counts, filtered match ids) must be equal; float outputs
agree within float32 roundoff, rtol 1e-5 (atol 1e-6 where a value can be
near 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebvo_tpu.backend import kfvo as jkfvo
from rebvo_tpu.core.geometry import so3_exp
from rebvo_tpu_torch.backend import kfvo as tkfvo
from rebvo_tpu_torch.frontend.state import KeylineMap
from tests.synthetic import lines_scene, make_map, transform_points

ZFM = 400.0
CX, CY = 376.0, 240.0
K = 2048
RTOL, ATOL = 1e-5, 1e-6


def T(a):
    return torch.as_tensor(np.array(a))


def TK(klm) -> KeylineMap:
    return KeylineMap(**{k: T(getattr(klm, k)) for k in KeylineMap._fields})


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def views():
    """A keyframe map and the map of the same points from a moved camera
    (R_true, t_true), as in test_aux.test_kfvo_transform_and_align."""
    P, ang = lines_scene(seed=2)
    n = P.shape[0]
    kf = make_map(P, ang, ZFM, CX, CY, K, s_rho=0.05)
    R = np.asarray(so3_exp(jnp.asarray([0.004, -0.006, 0.002],
                                       jnp.float32)), np.float32)
    t = np.array([0.02, -0.01, 0.03], np.float32)
    frame = make_map(transform_points(P, R.astype(np.float64),
                                      t.astype(np.float64)),
                     ang, ZFM, CX, CY, K, s_rho=0.05)
    return dict(kf=kf, frame=frame, R=R, t=t, n=n)


def test_proj_inv_depth_matches_jax():
    """Random keylines, some transported behind the camera (-1 there)."""
    rng = np.random.RandomState(0)
    px = rng.uniform(-300, 300, 512).astype(np.float32)
    py = rng.uniform(-200, 200, 512).astype(np.float32)
    rho = rng.uniform(-0.1, 3.0, 512).astype(np.float32)
    R = np.asarray(so3_exp(jnp.asarray([0.3, -0.2, 0.1], jnp.float32)))
    t = np.array([0.1, -0.2, -0.9], np.float32)
    for pre in (1.0, 1.7):
        a = jkfvo._proj_inv_depth(px, py, rho, R, t, ZFM, pre_scale=pre)
        b = tkfvo._proj_inv_depth(T(px), T(py), T(rho), T(R), T(t), ZFM,
                                  pre_scale=pre)
        assert np.array_equal(np.asarray(a) < 0, b.numpy() < 0)
        assert (b.numpy() < 0).any() and (b.numpy() > 0).any()
        close(a, b)


@pytest.mark.parametrize("mode", ["fwd", "f2kf", "back"])
def test_optimize_scale_matches_jax(views, mode):
    """A frame map with a 1.25x depth gauge against the keyframe map
    through the true relative pose, a fifth of the matches cleared."""
    fr = views["frame"]
    fr = fr._replace(rho=fr.rho * 1.25)
    rng = np.random.RandomState(1)
    m_id = np.where((np.arange(K) < views["n"]) & (rng.rand(K) > 0.2),
                    np.arange(K), -1).astype(np.int32)
    Rb, tb = views["R"].T, -(views["R"].T @ views["t"])
    kw = dict(mode=mode, pre_scale=1.1, init=0.9) if mode == "back" else \
        dict(mode=mode)
    Kr_j, w_j = jkfvo.optimize_scale(fr, views["kf"], jnp.asarray(m_id),
                                     jnp.asarray(Rb), jnp.asarray(tb), ZFM,
                                     **kw)
    Kr_t, w_t = tkfvo.optimize_scale(TK(fr), TK(views["kf"]), T(m_id), T(Rb),
                                     T(tb), ZFM, **kw)
    assert float(w_t) > 0
    close(Kr_j, Kr_t)
    close(w_j, w_t)


def test_optimize_scale_fallback_matches_jax(views):
    """No usable pair: weight 0 and the reference's fallback (init)."""
    none = np.full((K,), -1, np.int32)
    for mode, init in (("fwd", 1.0), ("f2kf", 1.0), ("back", 3.7)):
        a = jkfvo.optimize_scale(views["frame"], views["kf"],
                                 jnp.asarray(none), jnp.eye(3),
                                 jnp.zeros(3), ZFM, mode=mode, init=init)
        b = tkfvo.optimize_scale(TK(views["frame"]), TK(views["kf"]),
                                 T(none), torch.eye(3), torch.zeros(3), ZFM,
                                 mode=mode, init=init)
        assert float(b[1]) == float(a[1]) == 0.0
        assert float(b[0]) == float(a[0]) == np.float32(init)


@pytest.mark.parametrize("along_normal", [False, True])
@pytest.mark.parametrize("discard", [True, False])
def test_mutual_exclusion_matches_jax(along_normal, discard):
    """test_aux's four hand-made cases plus 4096 random keylines matched
    into a 1024-keyline partner map."""
    rng = np.random.RandomState(3)
    n, m = 4096, 1024
    m_fwd = np.where(rng.rand(n) < 0.8, rng.randint(0, m, n), -1)
    m_back = np.where(rng.rand(m) < 0.7, rng.randint(0, n, m), -1)
    m_fwd[:4] = [10, 11, 12, -1]
    m_back[[10, 11, 12]] = [0, -1, 0]
    valid = rng.rand(n) > 0.1
    valid[:4] = True
    px = rng.uniform(0, 60, n).astype(np.float32)
    py = rng.uniform(0, 60, n).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, n)
    ux, uy = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    args = [m_fwd.astype(np.int32), valid, m_back.astype(np.int32), px, py,
            ux, uy]
    kw = dict(dist_thresh=5.0, discard_non_mutual=discard,
              along_normal=along_normal)
    a = jkfvo.mutual_exclusion(*[jnp.asarray(x) for x in args], **kw)
    b = tkfvo.mutual_exclusion(*[T(x) for x in args], **kw)
    assert np.array_equal(b[0].numpy(), np.asarray(a[0]))
    assert int(b[1]) == int(a[1]) and int(b[2]) == int(a[2])
    assert 0 < int(b[2]) < int(b[1])


def test_count_kf_matches_matches_jax(views):
    rng = np.random.RandomState(4)
    m_kf = np.where(rng.rand(K) > 0.4, rng.randint(0, K, K), -1)
    klm = views["frame"]._replace(m_id_kf=jnp.asarray(m_kf, jnp.int32))
    a = jkfvo.count_kf_matches(klm)
    b = tkfvo.count_kf_matches(TK(klm))
    assert b.dtype == torch.int32 and int(b) == int(a) > 0


def test_keylines_in_fov_matches_jax(views):
    """The keyframe into the moved camera (test_aux's bar: most of it
    stays in view) and into one turned away (few stay)."""
    for w in ([0.004, -0.006, 0.002], [0.0, 0.9, 0.0]):
        R = np.asarray(so3_exp(jnp.asarray(w, jnp.float32)))
        a = jkfvo.keylines_in_fov(views["kf"], R, views["t"], ZFM, CX, CY,
                                  752, 480)
        b = tkfvo.keylines_in_fov(TK(views["kf"]), T(R), T(views["t"]), ZFM,
                                  CX, CY, 752, 480)
        assert int(b) == int(a)
    assert int(tkfvo.keylines_in_fov(
        TK(views["kf"]), T(views["R"]), T(views["t"]), ZFM, CX, CY, 752,
        480)) > 0.8 * views["n"]


def test_refine_keyframe_depths_matches_jax(views):
    """Matched keylines (observed at the frame's positions, predicted at
    the keyframe's) through the depth EKF in the frame and back."""
    rng = np.random.RandomState(5)
    kf, fr = views["kf"], views["frame"]
    match = (np.arange(K) < views["n"]) & (rng.rand(K) > 0.3)
    klm = kf._replace(
        m_id=jnp.asarray(np.where(match, np.arange(K), -1), jnp.int32),
        p0x=fr.px + jnp.asarray(rng.randn(K).astype(np.float32) * 0.3),
        p0y=fr.py + jnp.asarray(rng.randn(K).astype(np.float32) * 0.3),
        rho=kf.rho * jnp.asarray(np.exp(rng.randn(K) * 0.2), jnp.float32),
        s_rho=kf.s_rho * 3.0)
    vel = np.array([0.02, -0.01, 0.03], np.float32)
    a = jkfvo.refine_keyframe_depths(klm, views["R"], views["t"], vel, ZFM)
    b = tkfvo.refine_keyframe_depths(TK(klm), T(views["R"]), T(views["t"]),
                                     T(vel), ZFM)
    for name in ("rho", "s_rho", "rho0", "s_rho0"):
        close(getattr(a, name), getattr(b, name))
    # only the depth statistics move
    assert torch.equal(b.px, TK(klm).px)
    assert not np.allclose(b.rho.numpy(), np.asarray(klm.rho))
