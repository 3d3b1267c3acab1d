"""The port's stereo step against the JAX package's, on the CPU, on
tests/test_stereo_step.py's scene: a rig with a 0.11 m baseline
translating past a tilted plane, 376x240, `stereo_params`.

Both packages run the fused detector on both cameras: the JAX side its
Pallas kernel in the interpreter, the port the plain version of its CUDA
kernel, whose masks agree exactly. What remains is float32 sum-order
noise in the pose solver, the depth filter and the stereo scale
observers. One step from the same state agrees to ~1e-5 in Pos; over a
sequence the scale carry's deadband (a 5% switch between gains) lets
such noise grow frame by frame, so the sequence's bars are looser than
a single step's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rebvo_tpu.frontend.imu import ImuWindow as JWindow
from rebvo_tpu.frontend.step import VOFrontend
from rebvo_tpu_torch.convert import (imu_window_from_numpy, params_from_jax,
                                     state_from_numpy)
from rebvo_tpu_torch.frontend.step import VOFrontend as TorchFrontend
from tests.render import render_plane_seq
from tests.test_stereo_step import BASELINE, SMALL, TILT, stereo_params

torch.set_num_threads(2)

N_FRAMES = 6
# the sequence's bars: Pos absolute (the path is 0.1 long), VScaleC
# relative on every frame and on the last, stereo_num and klm_num
# relative
SEQ_POS, SEQ_VSC, SEQ_VSC_LAST, SEQ_NUM = 1e-3, 1e-2, 1e-3, 0.01
# one step from the same JAX state: Pos absolute, VScaleC and Vel
# relative, klm_num and stereo_num relative
ONE_POS, ONE_VSC, ONE_NUM = 1e-4, 1e-3, 0.005


def _scene(n):
    pos0 = np.zeros((n, 3))
    pos0[:, 0] = np.arange(n) * 0.02
    f0 = render_plane_seq(n, cam_positions=pos0, plane_normal=TILT, **SMALL)
    f1 = render_plane_seq(n, cam_positions=pos0 + [BASELINE, 0.0, 0.0],
                          plane_normal=TILT, **SMALL)
    return f0, f1


def _jax_frontend(p):
    fe = VOFrontend(p)
    fe.use_pallas = True        # the fused detector, run by the interpreter
    return fe


@pytest.fixture(scope="module")
def runs():
    f0, f1 = _scene(N_FRAMES)
    p = stereo_params()
    fe = _jax_frontend(p)
    with pltpu.force_tpu_interpret_mode():
        st = fe.bootstrap(fe.init(), jnp.asarray(f0[0]), jnp.asarray(0.0),
                          jnp.asarray(f1[0]))
        states, jouts = [st], []
        for i in range(1, N_FRAMES):
            st, out = fe.step(st, jnp.asarray(f0[i]), jnp.asarray(i / 20.0),
                              jnp.asarray(f1[i]))
            states.append(st)
            jouts.append(out)
    tfe = TorchFrontend(params_from_jax(p), device="cpu")
    ts = tfe.bootstrap(tfe.init(), f0[0], 0.0, f1[0])
    touts, tpair, tvsc = [], [], []
    for i in range(1, N_FRAMES):
        ts, out = tfe.step_donated(ts, f0[i], i / 20.0, f1[i])
        touts.append(out)
        tpair.append(int(ts.last_kl_num_pair))
        tvsc.append(float(ts.VScaleC))
    return dict(f0=f0, f1=f1, p=p, fe=fe, tfe=tfe, states=states,
                jouts=jouts, touts=touts, tpair=tpair, tvsc=tvsc)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def test_sequence_matches_jax(runs):
    """Per frame: kl_num equal on both cameras, stereo_num and klm_num
    within 1% (measured 0.07% and 0.25%), Pos within 1e-3 (measured
    8.6e-4), VScaleC within 1e-2 relative and within 1e-3 on the last
    frame. VScaleC's bar is looser than a single step's: the third
    frame's velocity-scale reading parts by 3e-4, as it does in one step
    from JAX's state, and the bootstrap's 0.6-power gain carries that
    into a 3.3e-3 gap at the fourth frame, which closes to 1e-4 at the
    fifth. Every frame estimates, stereo-matches more than 1000 keylines
    and keeps the metric gauge (Kp = 1)."""
    last = len(runs["jouts"]) - 1
    for i, (jo, to) in enumerate(zip(runs["jouts"], runs["touts"])):
        js = runs["states"][i + 1]
        assert int(jo.nav.kl_num) == int(to.nav.kl_num), i
        assert int(js.last_kl_num_pair) == runs["tpair"][i], i
        assert _rel(to.stereo_num, jo.stereo_num) <= SEQ_NUM, i
        assert _rel(to.nav.klm_num, jo.nav.klm_num) <= SEQ_NUM, i
        np.testing.assert_allclose(to.nav.Pos.numpy(),
                                   np.asarray(jo.nav.Pos), atol=SEQ_POS,
                                   rtol=0, err_msg=str(i))
        assert _rel(runs["tvsc"][i], js.VScaleC) <= (
            SEQ_VSC_LAST if i == last else SEQ_VSC), i
        assert bool(to.nav.estimation_ok) and int(to.stereo_num) > 1000
        assert float(to.Kp) == 1.0


def _jax_step(runs, st, i, pair=True):
    with pltpu.force_tpu_interpret_mode():
        return runs["fe"].step(
            st, jnp.asarray(runs["f0"][i]), jnp.asarray(i / 20.0),
            jnp.asarray(runs["f1"][i]) if pair else None)


def _port_step(runs, st, i, pair=True):
    tree = jax.tree_util.tree_map(np.asarray, st)
    return runs["tfe"].step(state_from_numpy(tree, device="cpu"),
                            runs["f0"][i], i / 20.0,
                            runs["f1"][i] if pair else None)


def _check_one(js2, jo, ts2, to):
    assert int(jo.nav.kl_num) == int(to.nav.kl_num)
    assert int(js2.last_kl_num_pair) == int(ts2.last_kl_num_pair)
    assert _rel(to.stereo_num, jo.stereo_num) <= ONE_NUM
    assert _rel(to.nav.klm_num, jo.nav.klm_num) <= ONE_NUM
    assert bool(to.nav.estimation_ok) == bool(jo.nav.estimation_ok)
    np.testing.assert_allclose(to.nav.Pos.numpy(), np.asarray(jo.nav.Pos),
                               atol=ONE_POS, rtol=0)
    assert _rel(ts2.VScaleC, js2.VScaleC) <= ONE_VSC
    vj = np.asarray(js2.Vel)
    assert np.abs(ts2.Vel.numpy() - vj).max() <= ONE_VSC * np.linalg.norm(vj)
    assert int(ts2.aAge) == int(js2.aAge)


def test_single_step_bootstrap_regauge(runs, monkeypatch):
    """The first stereo step (frame_count 1, inside BootstrapRescaleFrames)
    from JAX's bootstrap state: the re-gauge divides the map by the
    pair's median depth ratio (gauge_div != 1) and the warm-start
    velocity is multiplied by it. kl_num equal on both cameras,
    stereo_num and klm_num within 0.5%, Pos within 1e-4, Vel and VScaleC
    within 1e-3 relative (measured 5.9e-8 in Pos)."""
    tfe = runs["tfe"]
    seen = []
    orig = tfe._stereo_depth

    def spy(*a, **k):
        res = orig(*a, **k)
        seen.append(float(res[2]))
        return res
    monkeypatch.setattr(tfe, "_stereo_depth", spy)
    ts2, to = _port_step(runs, runs["states"][0], 1)
    assert len(seen) == 1 and abs(seen[0] - 1.0) > 0.05, seen
    _check_one(runs["states"][1], runs["jouts"][0], ts2, to)


def test_single_step_epoch_reset(runs):
    """From JAX's state after 3 steps with aAge set to
    StereoScaleBaseFrames: the step reads the long-baseline observer and
    resets the epoch (aAge 0, aR = I, aV = 0, the anchors moved to the
    keylines' current positions and pair depths) in both packages alike;
    the bars of the bootstrap step, and the anchors within 1e-4."""
    p = runs["p"]
    st = runs["states"][3]._replace(
        aAge=jnp.asarray(p.StereoScaleBaseFrames, jnp.int32))
    js2, jo = _jax_step(runs, st, 4)
    ts2, to = _port_step(runs, st, 4)
    _check_one(js2, jo, ts2, to)
    assert int(ts2.aAge) == 0
    np.testing.assert_array_equal(ts2.aR.numpy(), np.eye(3))
    np.testing.assert_array_equal(ts2.aV.numpy(), 0.0)
    klm_t, klm_j = ts2.klm, js2.klm
    same = klm_t.anchored.numpy() & np.asarray(klm_j.anchored)
    assert same.sum() > 1000
    for f in ("ax", "ay", "arho"):
        np.testing.assert_allclose(getattr(klm_t, f).numpy()[same],
                                   np.asarray(getattr(klm_j, f))[same],
                                   atol=1e-4, rtol=1e-4, err_msg=f)


def test_single_step_without_pair(runs):
    """A dropped cam1 frame under StereoAvaiable=1 (frame_pair=None): the
    step runs without the pair, as JAX's does (no stereo match, the
    pair's threshold carry unchanged, the anchored vote kept); the bars
    of the bootstrap step."""
    js2, jo = _jax_step(runs, runs["states"][2], 3, pair=False)
    ts2, to = _port_step(runs, runs["states"][2], 3, pair=False)
    assert int(to.stereo_num) == int(jo.stereo_num) == 0
    assert float(ts2.thresh_pair) == float(runs["states"][2].thresh_pair)
    _check_one(js2, jo, ts2, to)


def test_stereo_vio_steps_match_jax(runs):
    """step_imu with the pair (ImuMode=2, InitBiasFrameNum=2; gravity-only
    IMU windows, test_stereo_step's) for 3 frames: kl_num equal on both
    cameras, stereo_num within 1%, Pos within 1e-3 per frame."""
    p = stereo_params(ImuMode=2, InitBiasFrameNum=2)
    f0, f1 = runs["f0"], runs["f1"]
    win = JWindow(gyro=jnp.zeros((8, 3)),
                  accel=jnp.tile(jnp.asarray([0.0, -9.8, 0.0]), (8, 1)),
                  count=jnp.asarray(8, jnp.int32),
                  tsample=jnp.asarray(1.0 / 160.0, jnp.float32))
    twin = imu_window_from_numpy(jax.tree_util.tree_map(np.asarray, win),
                                 device="cpu")
    fe = _jax_frontend(p)
    tfe = TorchFrontend(params_from_jax(p), device="cpu")
    with pltpu.force_tpu_interpret_mode():
        js = fe.bootstrap(fe.init(), jnp.asarray(f0[0]), jnp.asarray(0.0),
                          jnp.asarray(f1[0]))
        ts = tfe.bootstrap(tfe.init(), f0[0], 0.0, f1[0])
        for i in range(1, 4):
            js, jo = fe.step_imu(js, jnp.asarray(f0[i]),
                                 jnp.asarray(i / 20.0), win,
                                 frame_pair=jnp.asarray(f1[i]))
            ts, to = tfe.step_imu_donated(ts, f0[i], i / 20.0, twin,
                                          frame_pair=f1[i])
            assert int(jo.nav.kl_num) == int(to.nav.kl_num)
            assert int(js.last_kl_num_pair) == int(ts.last_kl_num_pair)
            assert int(jo.stereo_num) > 500
            assert _rel(to.stereo_num, jo.stereo_num) <= SEQ_NUM
            np.testing.assert_allclose(to.nav.Pos.numpy(),
                                       np.asarray(jo.nav.Pos), atol=SEQ_POS,
                                       rtol=0)


def test_stereo_vio_turning_steps_match_jax(runs):
    """step_imu with the pair and a turning gyro (0.3 rad/s about y,
    ImuMode=2, InitBiasFrameNum=2) for 3 frames. Before the bias is
    initialised the frame's back rotation is the IMU's, not the
    filter's correction alone, and the scale anchor (aR, aV) composes
    it: aR within 1e-5 of JAX's on every frame (the IMU turns it by
    0.015 a frame), aV and Pos within 1e-3 (the VI filter's float32
    noise), kl_num equal on both cameras."""
    p = stereo_params(ImuMode=2, InitBiasFrameNum=2)
    f0, f1 = runs["f0"], runs["f1"]
    win = JWindow(gyro=jnp.tile(jnp.asarray([0.0, 0.3, 0.0]), (8, 1)),
                  accel=jnp.tile(jnp.asarray([0.0, -9.8, 0.0]), (8, 1)),
                  count=jnp.asarray(8, jnp.int32),
                  tsample=jnp.asarray(1.0 / 160.0, jnp.float32))
    twin = imu_window_from_numpy(jax.tree_util.tree_map(np.asarray, win),
                                 device="cpu")
    fe = _jax_frontend(p)
    tfe = TorchFrontend(params_from_jax(p), device="cpu")
    turned = 0.0
    with pltpu.force_tpu_interpret_mode():
        js = fe.bootstrap(fe.init(), jnp.asarray(f0[0]), jnp.asarray(0.0),
                          jnp.asarray(f1[0]))
        ts = tfe.bootstrap(tfe.init(), f0[0], 0.0, f1[0])
        for i in range(1, 4):
            js, jo = fe.step_imu(js, jnp.asarray(f0[i]),
                                 jnp.asarray(i / 20.0), win,
                                 frame_pair=jnp.asarray(f1[i]))
            ts, to = tfe.step_imu_donated(ts, f0[i], i / 20.0, twin,
                                          frame_pair=f1[i])
            assert int(jo.nav.kl_num) == int(to.nav.kl_num)
            assert int(js.last_kl_num_pair) == int(ts.last_kl_num_pair)
            jaR, jaV = np.asarray(js.aR), np.asarray(js.aV)
            turned = max(turned, float(np.abs(jaR - np.eye(3)).max()))
            np.testing.assert_allclose(ts.aR.numpy(), jaR, atol=1e-5,
                                       rtol=0, err_msg=str(i))
            np.testing.assert_allclose(ts.aV.numpy(), jaV, atol=SEQ_POS,
                                       rtol=0, err_msg=str(i))
            np.testing.assert_allclose(to.nav.Pos.numpy(),
                                       np.asarray(jo.nav.Pos), atol=SEQ_POS,
                                       rtol=0)
    # the anchor carries the IMU's turn (0.015 rad a frame)
    assert turned > 1e-2, turned


def test_mono_frontend_refuses_a_pair(runs):
    """StereoAvaiable=0: every entry point that takes frame_pair raises
    when given one, rather than dropping it."""
    fe = TorchFrontend(params_from_jax(stereo_params(StereoAvaiable=0)),
                       device="cpu")
    f = runs["f0"][0]
    st = fe.init()
    with pytest.raises(ValueError, match="StereoAvaiable=0"):
        fe.bootstrap(st, f, 0.0, f)
    for step in (fe.step, fe.step_donated):
        with pytest.raises(ValueError, match="StereoAvaiable=0"):
            step(st, f, 0.05, frame_pair=f)
    for step in (fe.step_imu, fe.step_imu_donated):
        with pytest.raises(ValueError, match="StereoAvaiable=0"):
            step(st, f, 0.05, None, frame_pair=f)
