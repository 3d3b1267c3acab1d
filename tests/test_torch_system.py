"""The port's VOSystem, keyframe store and pose graph against the JAX
package's, on the CPU, mirroring tests/test_system.py's VOSystem tests
(vision only, reset, the IMU window) at its shapes (376x240, 6 rendered
billboard frames); and write_euroc_vi's cam1 stream.

Both systems run the fused detector: the JAX side its Pallas kernel in
the interpreter, the port the plain version of its CUDA kernel, whose
masks agree exactly. (With the separate scale-space and detector ops,
the JAX package's choice off the TPU, keyline counts differ by one now
and then, and the pose solver's final J^T J, the information the pose
log transports, can then move by half.)
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rebvo_tpu.backend import keyframe as jkf
from rebvo_tpu.backend import posegraph as jpg
from rebvo_tpu.system import VOSystem as JSystem
from rebvo_tpu_torch.backend import keyframe as tkf
from rebvo_tpu_torch.backend import posegraph as tpg
from rebvo_tpu_torch.convert import (keyframe_store_from_numpy,
                                     params_from_jax, pose_log_from_jax)
from rebvo_tpu_torch.system import VOSystem as TSystem
from tests.render import render_billboards_seq
from tests.test_vo_step import SMALL, small_params

torch.set_num_threads(2)

N = 6


def _frames(n, moving=True):
    kw = {k: v for k, v in SMALL.items() if k != "z0"}
    pos = np.zeros((n, 3))
    if moving:
        pos[:, 0] = np.arange(n) * 0.02
    return render_billboards_seq(n, cam_positions=pos, **kw)


def _systems(params):
    """A JAX system on the fused detector (call it inside
    pltpu.force_tpu_interpret_mode) and a port system."""
    js = JSystem(params)
    js.frontend.use_pallas = True
    return js, TSystem(params_from_jax(params), device="cpu")


@pytest.fixture(scope="module")
def vision():
    """Both systems over the same N frames."""
    frames = _frames(N)
    params = small_params().replace(TrackKeyFrames=1, SaveLog=1)
    js, ts = _systems(params)
    jouts, touts = [], []
    for i in range(N):
        with pltpu.force_tpu_interpret_mode():
            jouts.append(js.process_frame(frames[i], i / 20.0))
        touts.append(ts.process_frame(frames[i], i / 20.0))
    return dict(params=params, js=js, ts=ts, jouts=jouts, touts=touts)


def test_vosystem_vision_only(vision, tmp_path):
    """tests/test_system.py's vision-only test on the port: one output
    per frame after the first, a finite nav state, the bootstrap
    keyframe pushed, one pose-log entry per frame whose information is
    the transported, symmetric, per-frame W; the log feeds the pose-graph
    optimizer; the outputs are written."""
    v = vision
    ts, js = v["ts"], v["js"]
    assert v["touts"][0] is None and all(o is not None
                                         for o in v["touts"][1:])
    nav = ts.getNav()
    assert np.all(np.isfinite(nav.Pos.numpy()))
    assert int(ts.kf_store.count) == int(js.kf_store.count) >= 1
    assert len(ts.pose_log.meas) == N - 1
    Ws = np.stack([m.W for m in ts.pose_log.meas])
    assert np.all(np.isfinite(Ws))
    np.testing.assert_allclose(Ws[-1], Ws[-1].T, atol=1e-4 * np.abs(
        Ws[-1]).max())
    assert not np.allclose(Ws[-1], np.eye(6))
    assert not np.allclose(Ws[-1], Ws[1])

    prob, n_nodes = tpg.problem_from_log(ts.pose_log, device="cpu")
    R0 = torch.eye(3).repeat(n_nodes, 1, 1)
    _, _, costs = tpg.optimize_pose_graph(R0, torch.zeros(n_nodes, 3), prob,
                                          iters=3)
    assert torch.all(torch.isfinite(costs))

    out_dir = str(tmp_path / "out")
    ts.save_outputs(out_dir)
    assert os.path.exists(os.path.join(out_dir, v["params"].TrayFile))
    assert os.path.exists(os.path.join(out_dir, v["params"].LogFile))


def test_vosystem_matches_jax(vision):
    """Against the JAX system on the same frames, per frame: kl_num
    equal, klm_num within 0.5% (one match apart on one frame), the
    keyframe decision equal, Pos within 1e-4 (measured
    4.9e-7); the store's count and the stored keyframes' poses within
    1e-4; each log entry's rel_pose within 1e-3 and W within 1e-3 of its
    largest entry (measured 2.1e-7 and 1.2e-4), kf_id and K equal."""
    v = vision
    js, lock = v["js"], v["ts"]
    for jo, lo in zip(v["jouts"][1:], v["touts"][1:]):
        assert int(jo.nav.kl_num) == int(lo.nav.kl_num)
        assert abs(int(jo.nav.klm_num) - int(lo.nav.klm_num)) <= \
            0.005 * int(jo.nav.klm_num)
        assert bool(jo.kf_saved) == bool(lo.kf_saved)
        np.testing.assert_allclose(lo.nav.Pos.numpy(),
                                   np.asarray(jo.nav.Pos), atol=1e-4)
    n_kf = int(js.kf_store.count)
    assert int(lock.kf_store.count) == n_kf
    for f in ("Pos", "Pose", "K_scale"):
        np.testing.assert_allclose(
            getattr(lock.kf_store, f).numpy()[:n_kf],
            np.asarray(getattr(js.kf_store, f))[:n_kf], atol=1e-4)
    assert len(lock.pose_log.meas) == len(js.pose_log.meas) == N - 1
    for mj, mt in zip(js.pose_log.meas, lock.pose_log.meas):
        np.testing.assert_allclose(mt.rel_pose, mj.rel_pose, atol=1e-3)
        np.testing.assert_allclose(mt.W, mj.W, atol=1e-3 * np.abs(
            mj.W).max(), rtol=0)
        assert mt.kf_id == mj.kf_id and mt.K == mj.K


def test_optimize_pose_graph_matches_jax(vision):
    """The JAX system's pose log through both optimizers from the same
    start: costs within 1e-4 relative, or within 1e-7 of the first cost
    once GN has converged to float32 roundoff (measured: the first two
    within 8.6e-5 relative, the third 1e-10 in both); the final poses
    within 1e-4."""
    js = vision["js"]
    pj, n = jpg.problem_from_log(js.pose_log)
    pt, n2 = tpg.problem_from_log(pose_log_from_jax(js.pose_log),
                                  device="cpu")
    assert n == n2 == N
    R0 = np.broadcast_to(np.eye(3), (n, 3, 3)).astype(np.float32)
    Rj, Pj, cj = jpg.optimize_pose_graph(jnp.asarray(R0),
                                         jnp.zeros((n, 3)), pj, iters=3)
    Rt, Pt, ct = tpg.optimize_pose_graph(torch.as_tensor(R0.copy()),
                                         torch.zeros((n, 3)), pt, iters=3)
    cj, ct = np.asarray(cj), ct.numpy()
    np.testing.assert_allclose(ct, cj, rtol=1e-4, atol=1e-7 * cj[0])
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=1e-4)


def _same_store(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_snapshots_load_both_ways(vision, tmp_path):
    """TakeSnapshot of each package loads in the other: the port's store
    and pose log through the JAX package's load_keyframes and
    PoseGraphLog.load, the JAX package's through the port's, with the
    same keys, dtypes, shapes and values; a JAX store also carries over
    in memory (convert.keyframe_store_from_numpy)."""
    ts, js = vision["ts"], vision["js"]
    for name, sys_ in (("t", ts), ("j", js)):
        sys_.TakeSnapshot(str(tmp_path / f"{name}_kf.npz"),
                          str(tmp_path / f"{name}_pg.npz"))
    zt, zj = np.load(tmp_path / "t_kf.npz"), np.load(tmp_path / "j_kf.npz")
    assert sorted(zt.files) == sorted(zj.files)
    for k in zt.files:
        assert zt[k].dtype == zj[k].dtype and zt[k].shape == zj[k].shape, k

    store_j = jkf.load_keyframes(str(tmp_path / "t_kf.npz"))
    _same_store({k: np.asarray(v) for k, v in zip(
        ("valid", "t", "K_scale", "Pose", "Pos", "Vel"), store_j[:6])},
        {k: getattr(ts.kf_store, k).numpy() for k in
         ("valid", "t", "K_scale", "Pose", "Pos", "Vel")})
    np.testing.assert_array_equal(np.asarray(store_j.klm.rho),
                                  ts.kf_store.klm.rho.numpy())
    store_t = tkf.load_keyframes(str(tmp_path / "j_kf.npz"), device="cpu")
    mem_t = keyframe_store_from_numpy(
        jax.tree_util.tree_map(np.asarray, js.kf_store), device="cpu")
    for got in (store_t, mem_t):
        for k in ("valid", "t", "Pose", "Pos", "count", "next_slot"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(js.kf_store,
                                                             k)))
        np.testing.assert_array_equal(got.klm.px.numpy(),
                                      np.asarray(js.kf_store.klm.px))
    for src, log, load in (("t", ts.pose_log, jpg.PoseGraphLog.load),
                           ("j", js.pose_log, tpg.PoseGraphLog.load)):
        back = load(str(tmp_path / f"{src}_pg.npz"))
        assert len(back.meas) == len(log.meas)
        for a, b in zip(back.meas, log.meas):
            np.testing.assert_array_equal(a.rel_pose, b.rel_pose)
            np.testing.assert_array_equal(a.W, b.W)
            assert a.kf_id == b.kf_id


def test_vosystem_reset():
    """After 3 frames and Reset, the next frame is a bootstrap frame in
    both systems: frame_count 1 and Pos back at 0; the nav state before
    the reset within 1e-3."""
    frames = _frames(4, moving=False)
    js, ts = _systems(small_params())
    with pltpu.force_tpu_interpret_mode():
        for i in range(3):
            js.process_frame(frames[i], i / 20.0)
            ts.process_frame(frames[i], i / 20.0)
        np.testing.assert_allclose(ts.getNav().Pos.numpy(),
                                   np.asarray(js.getNav().Pos), atol=1e-3)
        for sys_ in (js, ts):
            sys_.Reset()
            sys_.process_frame(frames[3], 3 / 20.0)
            assert sys_.frame_count == 1
    assert float(torch.linalg.norm(ts.state.Pos)) == 0.0
    assert float(ts.state.thresh) == float(js.state.thresh)


def test_vosystem_push_imu_window():
    """pushIMU + _collect_imu_window give the JAX system's window: the 6
    samples in (0, 0.03], then none (consumed samples are dropped)."""
    js, ts = _systems(small_params().replace(ImuMode=2))
    for k in range(10):
        for sys_ in (js, ts):
            sys_.pushIMU(0.005 * k, [0.01, 0, 0], [0, -9.8, 0])
    for _ in range(2):
        wj = js._collect_imu_window(0.0, 0.03)
        wt = ts._collect_imu_window(0.0, 0.03)
        for f in ("gyro", "accel", "count", "tsample"):
            np.testing.assert_array_equal(getattr(wt, f).numpy(),
                                          np.asarray(getattr(wj, f)))
    assert int(wt.count) == 0


def test_vosystem_stereo_and_telemetry():
    """VOSystem.process_frame takes the stereo pair (test_stereo_step's
    VOSystem test on the port); with VideoNetEnabled=1 the system sends
    each frame's edge map (the pair's system too) to a receiver on a free
    loopback port."""
    from tests.render import render_plane_seq
    from tests.test_stereo_step import BASELINE, TILT, stereo_params
    from tests.test_stereo_step import SMALL as ST_SMALL
    pos0 = np.zeros((4, 3))
    pos0[:, 0] = np.arange(4) * 0.02
    f0 = render_plane_seq(4, cam_positions=pos0, plane_normal=TILT,
                          **ST_SMALL)
    f1 = render_plane_seq(4, cam_positions=pos0 + [BASELINE, 0.0, 0.0],
                          plane_normal=TILT, **ST_SMALL)
    p = params_from_jax(stereo_params())
    sys_ = TSystem(p, device="cpu")
    for i in range(4):
        out = sys_.process_frame(f0[i], i / 20.0, frame_pair=f1[i])
    assert int(out.stereo_num) > 500 and bool(out.nav.estimation_ok)
    assert len(sys_.pose_log.meas) == 3
    import socket

    from rebvo_tpu_torch.io.telemetry import EdgeMapReceiver
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    rx = EdgeMapReceiver("127.0.0.1", port)
    tel = TSystem(p.replace(VideoNetEnabled=1, VideoNetPort=port),
                  device="cpu")
    for i in range(2):
        tel.process_frame(f0[i], i / 20.0, frame_pair=f1[i])
    pkt = rx.recv(timeout_ms=3000)
    rx.close()
    tel.sender.close()
    assert pkt is not None and pkt["frame_id"] == 0
    assert pkt["n"] == int(tel.state.klm.valid.sum())
    assert tel.telemetry_dropped == 0


def test_write_euroc_vi_cam1_stream(tmp_path):
    """write_euroc_vi(stereo=True) at 188x120 (the EuRoC cameras scaled):
    cam1/data.csv has cam0's time stamps, so DatasetSequence pairs every
    frame; a cam1 frame, undistorted through cam1's own map, is the
    scene seen from cam1's pose (R_wc1 = R_wc0 R01^T, C1 = C0 - R_wc1
    t01): its mean difference to a direct pinhole render there is under
    20 of 765 (measured 13.3: 8-bit levels and two resamplings), and
    under a third of its difference to a render from cam0's pose
    (measured 73.5)."""
    from rebvo_tpu_torch.config import REBVOParameters
    from rebvo_tpu_torch.core.geometry import CameraModel
    from rebvo_tpu_torch.io.dataset import DatasetSequence
    from rebvo_tpu_torch.io.render import (_yaw_R, pair_poses,
                                           vi_lateral_path, write_euroc_vi)
    from rebvo_tpu_torch.io.undistort import (apply_undistort,
                                              build_undistort_map)
    p = REBVOParameters().replace(
        ImageWidth=188, ImageHeight=120, ZfX=114.66, ZfY=114.32, PPx=91.8,
        PPy=62.1, StereoZfX=114.40, StereoZfY=114.03, StereoPPx=95.0,
        StereoPPy=63.81, InitBiasFrameNum=0)
    d = str(tmp_path / "mav0")
    t, pos = write_euroc_vi(p, 6, d, workers=2, stereo=True)
    csv = [open(os.path.join(d, c, "data.csv")).read()
           for c in ("cam0", "cam1")]
    assert csv[0] == csv[1]
    items = list(DatasetSequence.euroc(d, with_imu=False, stereo=True))
    assert len(items) == 6 and all(it[3] is not None for it in items)
    i = 5
    _, _, yaw, _ = vi_lateral_path(t, 2 / p.config_fps)
    rots = np.stack([_yaw_R(a) for a in yaw])
    pos1, rots1 = pair_poses(p, pos, rots)
    cam1 = CameraModel.from_params(p, stereo=True)
    und = apply_undistort(build_undistort_map(cam1, device="cpu"),
                          torch.as_tensor(items[i][3])).numpy()
    err = {}
    for label, c, r in (("cam1", pos1, rots1), ("cam0", pos, rots)):
        ideal = render_billboards_seq(
            1, width=188, height=120, zf=cam1.zfm, cx=cam1.cx, cy=cam1.cy,
            cam_positions=c[i:i + 1], cam_rotations=r[i:i + 1], ss=1)[0]
        err[label] = float(np.abs(und - ideal)[8:-8, 8:-8].mean())
    assert err["cam1"] < 20.0 and err["cam1"] < err["cam0"] / 3, err



def test_pair_poses_independent():
    """io/render.pair_poses against the JAX package's parity harness
    (rebvo_tpu/apps/parity.py's _pair_poses, its own constants) and
    against the extrinsics' meaning, X1 = R01 X0 + t01: a world point
    seen from cam1's pose has the cam1 coordinates that map from its cam0
    coordinates, and cam0's centre sits at t01 in cam1's frame."""
    from rebvo_tpu.apps.parity import ST_R, ST_T, _pair_poses
    from rebvo_tpu_torch.config import REBVOParameters
    from rebvo_tpu_torch.io.render import pair_poses
    p = REBVOParameters()
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(5, 3))
    q, r = np.linalg.qr(rng.normal(size=(5, 3, 3)))
    rots = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    rots[np.linalg.det(rots) < 0] *= -1.0
    pos1, rots1 = pair_poses(p, pos, rots)
    jpos1, jrots1 = _pair_poses(pos, rots)
    np.testing.assert_allclose(pos1, jpos1, atol=1e-12)
    np.testing.assert_allclose(rots1, jrots1, atol=1e-12)
    R01, t01 = p.stereo_extrinsics()
    np.testing.assert_array_equal(R01, ST_R)
    np.testing.assert_array_equal(t01, ST_T)
    P = rng.normal(size=(7, 3)) + [0.0, 0.0, 3.0]
    for c0, r0, c1, r1 in zip(pos, rots, pos1, rots1):
        X0 = (P - c0) @ r0
        X1 = (P - c1) @ r1
        np.testing.assert_allclose(X1, X0 @ R01.T + t01, atol=1e-12)
        np.testing.assert_allclose((c0 - c1) @ r1, t01, atol=1e-12)
