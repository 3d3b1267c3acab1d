"""The PyTorch port's mono VO step as a whole, against the JAX package,
at test_vo_step.py's SMALL shapes (376x240, K=8192) on its rendered
tilted-plane translation sequence.

The JAX side runs its step with the Pallas detector forced into the
interpreter, so both packages run the fused detector (UsePallas=-1);
the port runs the plain version of its CUDA kernel on the CPU. The
detections then agree exactly, and what remains is f32 sum-order noise
in the solver and the depth filter, which the LM's discrete accept tests
and the matcher's floor(x+0.5) lookups amplify a little frame by frame.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rebvo_tpu.config import REBVOParameters
from rebvo_tpu.frontend.step import VOFrontend
from rebvo_tpu.io.render import render_plane_seq
from rebvo_tpu.io.trajectory import ate_rmse
from rebvo_tpu_torch.convert import (params_from_jax, state_from_numpy,
                                     state_to_numpy)
from rebvo_tpu_torch.frontend.step import VOFrontend as TorchFrontend
from rebvo_tpu_torch.io.trajectory import read_tum

torch.set_num_threads(2)

SMALL = dict(width=376, height=240, zf=200.0, cx=188.0, cy=120.0, z0=3.0)
TILT = (0.35, 0.25, 1.0)
N_FRAMES = 12


def small_params(**kw):
    return REBVOParameters().replace(
        ImageWidth=SMALL["width"], ImageHeight=SMALL["height"],
        ZfX=SMALL["zf"], ZfY=SMALL["zf"], PPx=SMALL["cx"], PPy=SMALL["cy"],
        KcR2=0.0, KcR4=0.0, KcP1=0.0, KcP2=0.0,
        KeylineMax=8192, MaxPoints=8192, ReferencePoints=3000,
        TrackPoints=8192, GlobalMatchThreshold=200,
        DetectorThresh=0.03, DetectorAutoGain=1e-6, **kw)


@pytest.fixture(scope="module")
def runs():
    pos = np.zeros((N_FRAMES, 3))
    pos[:, 0] = np.arange(N_FRAMES) * 0.02
    frames = render_plane_seq(N_FRAMES, cam_positions=pos,
                              plane_normal=TILT, **SMALL)
    p = small_params()
    fe = VOFrontend(p)
    fe.use_pallas = True      # the fused detector, run by the interpreter
    with pltpu.force_tpu_interpret_mode():
        st = fe.bootstrap(fe.init(), jnp.asarray(frames[0]),
                          jnp.asarray(0.0))
        states, jouts = [st], []
        for i in range(1, N_FRAMES):
            st, out = fe.step(st, jnp.asarray(frames[i]),
                              jnp.asarray(i / 20.0))
            states.append(st)
            jouts.append(out)
        # one JAX step from the state after bootstrap + 2 steps
        j_single = fe.step(states[2], jnp.asarray(frames[3]),
                           jnp.asarray(3 / 20.0))
    tfe = TorchFrontend(params_from_jax(p), device="cpu")
    ts = tfe.bootstrap(tfe.init(), frames[0], 0.0)
    touts = []
    for i in range(1, N_FRAMES):
        ts, out = tfe.step(ts, frames[i], i / 20.0)
        touts.append(out)
    return dict(frames=frames, p=p, tfe=tfe, states=states, jouts=jouts,
                touts=touts, j_single=j_single, pos=pos)


def test_single_step_from_same_state(runs):
    """One port step from the JAX state (bootstrap + 2 steps) carried
    across by convert.state_from_numpy, against one JAX step: kl_num
    equal, klm_num within 0.5%, the state's motion within 5e-5 absolute
    (|V| ~ 7e-3, so ~1% of the per-frame motion: LM sum-order noise)."""
    tfe = runs["tfe"]
    tree = jax.tree_util.tree_map(np.asarray, runs["states"][2])
    ts = state_from_numpy(tree, device="cpu")
    # the conversion is lossless
    back = state_to_numpy(ts)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(tuple(back))):
        np.testing.assert_array_equal(a, b)
    ts2, tout = tfe.step(ts, runs["frames"][3], 3 / 20.0)
    js2, jout = runs["j_single"]
    assert int(jout.nav.kl_num) == int(tout.nav.kl_num)
    assert abs(int(jout.nav.klm_num) - int(tout.nav.klm_num)) <= \
        0.005 * int(jout.nav.klm_num)
    assert bool(jout.nav.estimation_ok) and bool(tout.nav.estimation_ok)
    for f in ("Vel", "W0", "Pos", "Pose"):
        np.testing.assert_allclose(np.asarray(getattr(js2, f)),
                                   getattr(ts2, f).numpy(), atol=5e-5,
                                   err_msg=f)
    np.testing.assert_array_equal(np.asarray(js2.mask_img),
                                  ts2.mask_img.numpy())


def test_sequence_per_frame_nav(runs):
    """12 frames end to end through the port's VOFrontend: per frame the
    keyline count is equal, the matched count within 1%, estimation_ok
    equal, and Pos within 1e-3 (span ~0.1; the drift between the two
    packages grows from ~1e-6 at frame 1 to ~2e-4 by frame 11)."""
    for i, (a, b) in enumerate(zip(runs["jouts"], runs["touts"]), 1):
        assert int(a.nav.kl_num) == int(b.nav.kl_num), i
        assert abs(int(a.nav.klm_num) - int(b.nav.klm_num)) <= \
            0.01 * int(a.nav.klm_num), i
        assert bool(a.nav.estimation_ok) == bool(b.nav.estimation_ok), i
        np.testing.assert_allclose(np.asarray(a.nav.Pos),
                                   b.nav.Pos.numpy(), atol=1e-3,
                                   err_msg=str(i))
        np.testing.assert_allclose(np.asarray(a.nav.PoseLie),
                                   b.nav.PoseLie.numpy(), atol=1e-3,
                                   err_msg=str(i))


def test_sequence_ate_between_packages(runs):
    """The ATE of the port's trajectory against the JAX trajectory
    (similarity-aligned) is below 1% of the path length; both also track
    the rendered ground truth like test_vo_step's bar (15% of span)."""
    PJ = np.stack([np.asarray(o.nav.Pos) for o in runs["jouts"]])
    PT = np.stack([o.nav.Pos.numpy() for o in runs["touts"]])
    span = np.linalg.norm(PJ[-1] - PJ[0])
    ate = ate_rmse(PT, PJ, with_scale=True)
    assert ate < 0.01 * span, (ate, span)
    gt = runs["pos"]
    gt_span = np.linalg.norm(gt[-1] - gt[0])
    assert ate_rmse(PT[2:], gt[3:], with_scale=True) < 0.15 * gt_span


def test_nav_log_ring_matches_outputs(runs):
    """The device nav-log ring holds one packed row per step."""
    from rebvo_tpu_torch.frontend.step import unpack_nav_rows
    fe = runs["tfe"]
    st = fe.bootstrap(fe.init(), runs["frames"][0], 0.0)
    outs = []
    for i in (1, 2):
        st, out = fe.step(st, runs["frames"][i], i / 20.0)
        outs.append(out)
    rows = unpack_nav_rows(st.navlog[:int(st.navlog_n)].numpy())
    assert len(rows) == 2
    for r, o in zip(rows, outs):
        np.testing.assert_allclose(r["Pos"], o.nav.Pos.numpy())
        assert r["kl_num"] == int(o.nav.kl_num)


def test_unported_modes_raise():
    """A stereo config builds a stereo frontend (its pair camera and
    extrinsics on the device); a pair frame given to a mono frontend's
    mono or visual-inertial step raises rather than being dropped."""
    p = small_params()
    fe_st = TorchFrontend(p.replace(StereoAvaiable=1), device="cpu")
    assert fe_st.stereo and fe_st._R01.shape == (3, 3)
    fe = TorchFrontend(p, device="cpu")
    for step in (fe.step, fe.step_imu, fe.step_imu_donated):
        args = (None, None, None) + ((None,) if "imu" in step.__name__
                                     else ())
        with pytest.raises(ValueError, match="StereoAvaiable=0"):
            step(*args, frame_pair=np.zeros((2, 2), np.float32))


def test_run_vo_synthetic_writes_tum(tmp_path):
    """run_vo on 6 procedural frames on the CPU: frame 0 bootstraps and
    each later frame logs one row, as in the JAX package's run_vo. With
    --imu the synthetic frames carry no IMU window, so they run the mono
    step, and with --stereo no pair frame, so they run without one, as
    in the JAX package."""
    from rebvo_tpu_torch.apps import run_vo
    cfg = tmp_path / "small.cfg"
    cfg.write_text("&Camera\nImageWidth=188\nImageHeight=120\nZfX=100\n"
                   "ZfY=100\nPPx=94\nPPy=60\n&TPU\nKeylineMax=2048\n")
    run_vo.main(["--cpu", "--synthetic", "6", "--config", str(cfg),
                 "--out-dir", str(tmp_path)])
    t, pos, quat = read_tum(os.path.join(tmp_path, "rebvo_tray.txt"))
    assert len(t) == 5
    assert np.all(np.isfinite(pos)) and np.all(np.isfinite(quat))
    assert os.path.exists(os.path.join(tmp_path, "rebvo_log.m"))
    imu_dir = tmp_path / "imu"
    run_vo.main(["--cpu", "--imu", "--synthetic", "3", "--config", str(cfg),
                 "--out-dir", str(imu_dir)])
    t, pos, _ = read_tum(os.path.join(imu_dir, "rebvo_tray.txt"))
    assert len(t) == 2 and np.all(np.isfinite(pos))
    st_dir = tmp_path / "stereo"
    run_vo.main(["--cpu", "--stereo", "--synthetic", "3", "--config",
                 str(cfg), "--out-dir", str(st_dir)])
    t, pos, _ = read_tum(os.path.join(st_dir, "rebvo_tray.txt"))
    assert len(t) == 2 and np.all(np.isfinite(pos))
