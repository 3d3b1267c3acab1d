"""The PyTorch port's visual-inertial step against the JAX package's, at
test_vo_step.py's SMALL shapes (376x240, K=8192), on test_vi_step's
full-pose scene (x sinusoid + yaw + gravity after a stationary start),
with the IMU mounted rotated 90 degrees about z (R_cam2imu given),
ImuMode=2 and InitBiasFrameNum=4, so the scale/gravity filter runs from
frame 9 on.

Both packages run the fused detector: the JAX side its Pallas kernel in
the interpreter, the port the plain version of its CUDA kernel. The
detections then agree exactly; what remains is f32 sum-order noise in
the pose solver, the depth filter and the 7-state filter's 20
Gauss-Newton iterations.

That filter amplifies the noise at its start. From the same JAX state
the port's step gives K within 1.1e-5 of JAX's at each of the filter's
first frames but frame 11, where it is 2.7% off
(test_single_step_from_same_state). Frame 11, the third frame the filter
runs and the first whose velocity window has seen the motion, maps the
frame-10 state's small differences (3e-4 in K, ~2e-3 in the velocity
covariance that inv(W_Xgv) takes at condition ~7e3) to K = 1.43 against
JAX's 0.72. From frame 12 both runs re-converge: K within 10%, then
within 1.2% by frame 23, and the trajectories agree after that jump.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rebvo_tpu.frontend.step import VOFrontend
from rebvo_tpu.io.trajectory import ate_rmse
from rebvo_tpu_torch.convert import (imu_window_from_numpy, params_from_jax,
                                     state_from_numpy, state_to_numpy)
from rebvo_tpu_torch.frontend.step import VOFrontend as TorchFrontend
from rebvo_tpu_torch.frontend.step import unpack_nav_rows
from tests.test_vi_step import make_vi_rot_sequence
from tests.test_vo_step import small_params

torch.set_num_threads(2)

N_FRAMES = 24
SENSITIVE = 11           # the frame whose K the filter's start amplifies
RZ = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                np.float32)
BEFORE, AFTER = 3, 11   # single steps from the state after k steps
                        # (frame_count 4: filter off; 12: filter on)
# single steps through the filter's start (it runs from frame_count 9,
# the state after 8 steps); the step from the state after 10 steps is
# the sequence's frame SENSITIVE, where its K first departs. Each k's
# bars: (K rtol, g_est and X7 atol, Pos atol).
SINGLE = {BEFORE: (1e-3, 1e-3, 1e-4), 8: (1e-3, 1e-3, 1e-4),
          9: (1e-3, 1e-3, 1e-4), SENSITIVE - 1: (5e-2, 5e-2, 1e-3),
          AFTER: (1e-3, 1e-3, 1e-4)}


def _win(w):
    return imu_window_from_numpy(jax.tree_util.tree_map(np.asarray, w),
                                 device="cpu")


@pytest.fixture(scope="module")
def runs():
    frames, t_frames, wins, pos, _ = make_vi_rot_sequence(n=N_FRAMES,
                                                          R_c2i=RZ)
    p = small_params().replace(ImuMode=2, InitBiasFrameNum=4)
    fe = VOFrontend(p)
    fe.use_pallas = True      # the fused detector, run by the interpreter
    Rj, Tj = jnp.asarray(RZ), jnp.zeros(3, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        st = fe.bootstrap(fe.init(), jnp.asarray(frames[0]),
                          jnp.asarray(t_frames[0]))
        states, jouts = [st], []
        for i in range(1, N_FRAMES):
            st, out = fe.step_imu(st, jnp.asarray(frames[i]),
                                  jnp.asarray(t_frames[i]), wins[i], Rj, Tj)
            states.append(st)
            jouts.append(out)
    tfe = TorchFrontend(params_from_jax(p), device="cpu")
    Rt, Tt = torch.as_tensor(RZ), torch.zeros(3)
    twins = [_win(w) for w in wins]
    ts = tfe.bootstrap(tfe.init(), frames[0], float(t_frames[0]))
    touts = []
    for i in range(1, N_FRAMES):
        ts, out = tfe.step_imu_donated(ts, frames[i], float(t_frames[i]),
                                       twins[i], Rt, Tt)
        touts.append(out)
    return dict(frames=frames, t=t_frames, twins=twins, tfe=tfe, Rt=Rt,
                Tt=Tt, states=states, jouts=jouts, touts=touts, final=ts,
                pos=pos)


def _single(runs, k):
    tree = jax.tree_util.tree_map(np.asarray, runs["states"][k])
    st = state_from_numpy(tree, device="cpu")
    i = k + 1
    return runs["tfe"].step_imu(st, runs["frames"][i], float(runs["t"][i]),
                                runs["twins"][i], runs["Rt"], runs["Tt"])


@pytest.mark.parametrize("k", list(SINGLE), ids=[
    "filter_off", "filter_start", "filter_2", "filter_sensitive",
    "filter_on"])
def test_single_step_from_same_state(runs, k):
    """One port step_imu from the JAX state after k steps against JAX's
    step k+1: kl_num equal, klm_num within 0.5%, estimation_ok equal;
    Vel (|V| ~ 1e-2) within 5e-5 absolute. At every k but the sensitive
    one: Pos within 1e-4 absolute, K_scale within 1e-3 relative, g_est
    and the 7-state filter X7 within 1e-3 absolute (|g| = 9.8; measured
    at most 1.1e-5 relative and 7.4e-5). The sensitive step (k = 10) from
    the same state gives K within 5e-2 relative, g_est and X7 within 5e-2
    and Pos within 1e-3 (measured 2.7e-2, 2.3e-2, 1.9e-4): there the
    filter's own float32 error is what the sequence's frame-11 departure
    starts from."""
    k_rtol, g_atol, pos_atol = SINGLE[k]
    ts2, tout = _single(runs, k)
    js2, jout = runs["states"][k + 1], runs["jouts"][k]
    assert int(jout.nav.kl_num) == int(tout.nav.kl_num)
    assert abs(int(jout.nav.klm_num) - int(tout.nav.klm_num)) <= \
        0.005 * int(jout.nav.klm_num)
    assert bool(jout.nav.estimation_ok) == bool(tout.nav.estimation_ok)
    np.testing.assert_allclose(np.asarray(js2.Vel), ts2.Vel.numpy(),
                               atol=5e-5)
    np.testing.assert_allclose(np.asarray(js2.Pos), ts2.Pos.numpy(),
                               atol=pos_atol)
    np.testing.assert_allclose(float(js2.K_scale), float(ts2.K_scale),
                               rtol=k_rtol)
    np.testing.assert_allclose(np.asarray(js2.imu.g_est),
                               ts2.imu.g_est.numpy(), atol=g_atol)
    np.testing.assert_allclose(np.asarray(js2.imu.X7), ts2.imu.X7.numpy(),
                               atol=g_atol)
    np.testing.assert_array_equal(np.asarray(js2.mask_img),
                                  ts2.mask_img.numpy())


def test_sequence_per_frame(runs):
    """23 VI frames end to end (see the module note). Every frame:
    kl_num equal, klm_num within 1%, estimation_ok equal. Up to frame 10:
    Pos within 1e-4, K_scale within 1e-3 relative, g within 2e-3. From
    frame 12: K_scale within 15% relative, g within 2e-2 (|g| = 9.8),
    Pos within 1.5e-2 (the frame-11 step persists as an offset; span
    ~0.05). Frame 11: both K finite and positive."""
    for i, (a, b) in enumerate(zip(runs["jouts"], runs["touts"]), 1):
        assert int(a.nav.kl_num) == int(b.nav.kl_num), i
        assert abs(int(a.nav.klm_num) - int(b.nav.klm_num)) <= \
            0.01 * int(a.nav.klm_num), i
        assert bool(a.nav.estimation_ok) == bool(b.nav.estimation_ok), i
        ka, kb = float(a.nav.scale), float(b.nav.scale)
        if i == SENSITIVE:
            assert 0 < ka < 100 and 0 < kb < 100, (ka, kb)
            continue
        tight = i < SENSITIVE
        np.testing.assert_allclose(np.asarray(a.nav.Pos), b.nav.Pos.numpy(),
                                   atol=1e-4 if tight else 1.5e-2,
                                   err_msg=str(i))
        np.testing.assert_allclose(kb, ka, rtol=1e-3 if tight else 0.15,
                                   err_msg=str(i))
        np.testing.assert_allclose(np.asarray(a.nav.g), b.nav.g.numpy(),
                                   atol=2e-3 if tight else 2e-2,
                                   err_msg=str(i))
    # re-converged by the last frame
    np.testing.assert_allclose(float(runs["touts"][-1].nav.scale),
                               float(runs["jouts"][-1].nav.scale), rtol=0.03)


def test_sequence_ate_between_packages(runs):
    """After the filter's start (frames 12-23), the ATE of the port's
    trajectory against the JAX one (similarity-aligned) is under 1% of
    its span (measured 0.2-0.8%), and the final gravity estimates point
    the same way within 1e-3."""
    PJ = np.stack([np.asarray(o.nav.Pos) for o in runs["jouts"]])[11:]
    PT = np.stack([o.nav.Pos.numpy() for o in runs["touts"]])[11:]
    span = np.linalg.norm(PJ.max(0) - PJ.min(0))
    assert span > 0
    assert ate_rmse(PT, PJ, with_scale=True) < 0.01 * span
    gj = np.asarray(runs["states"][-1].imu.g_est)
    gt = runs["final"].imu.g_est.numpy()
    assert gt[1] / np.linalg.norm(gt) > 0.9
    np.testing.assert_allclose(gt / np.linalg.norm(gt),
                               gj / np.linalg.norm(gj), atol=1e-3)


def _leaves(tree):
    """Host copies of a port tree's leaves, in order."""
    return [np.array(x) for x in jax.tree_util.tree_leaves(
        state_to_numpy(tree))]


def test_step_imu_leaves_its_input_unchanged(runs):
    tree = jax.tree_util.tree_map(np.asarray, runs["states"][AFTER])
    st = state_from_numpy(tree, device="cpu")
    before = _leaves(st)
    runs["tfe"].step_imu(st, runs["frames"][AFTER + 1],
                         float(runs["t"][AFTER + 1]),
                         runs["twins"][AFTER + 1], runs["Rt"], runs["Tt"])
    for a, b in zip(before, _leaves(st)):
        np.testing.assert_array_equal(a, b)


def test_step_imu_donated_equals_step_imu(runs):
    """The donated step gives the pure step's outputs and state bit for
    bit."""
    tree = jax.tree_util.tree_map(np.asarray, runs["states"][AFTER])
    fe, i = runs["tfe"], AFTER + 1
    args = (runs["frames"][i], float(runs["t"][i]), runs["twins"][i],
            runs["Rt"], runs["Tt"])
    sa, oa = fe.step_imu(state_from_numpy(tree, device="cpu"), *args)
    sb, ob = fe.step_imu_donated(state_from_numpy(tree, device="cpu"), *args)
    for a, b in zip(_leaves(sa) + _leaves(oa), _leaves(sb) + _leaves(ob)):
        np.testing.assert_array_equal(a, b)


def test_nav_ring_holds_imu_dbg(runs):
    """The nav-log ring of the sequence holds one packed row per step,
    with the imu_dbg rows of each output."""
    st = runs["final"]
    rows = unpack_nav_rows(st.navlog[:int(st.navlog_n)].numpy())
    assert len(rows) == N_FRAMES - 1
    for r, o in zip(rows, runs["touts"]):
        np.testing.assert_array_equal(r["imu_dbg"], o.imu_dbg.numpy())
        np.testing.assert_array_equal(r["g"], o.nav.g.numpy())
        assert r["kl_num"] == int(o.nav.kl_num)
