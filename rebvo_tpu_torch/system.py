"""Top-level VO/VIO system, the reference's `REBVO` class (PyTorch
counterpart of rebvo_tpu/system.py; reference include/rebvo/rebvo.h:
357-640).

    sys_ = VOSystem(params)                  # device="cuda"
    out = sys_.process_frame(frame, t)       # None for the first frame
    out = sys_.process_frame(frame, t, frame_pair=cam1)   # stereo
    sys_.pushIMU(t, gyro, accel)             # visual-inertial
    nav = sys_.getNav()
    sys_.TakeSnapshot("kf_list.npz", "poses_list.npz")

The reference's three threads collapse into the host feeding frames, the
device step, and host-side output: the logger, the keyframe store and
the pose-graph log. Each frame reads its keyframe decision and the
measurement the pose log keeps on the host, in one transfer: that read
is the API's contract (getNav, the pose log), as in the JAX package. The
step itself is `step_donated` / `step_imu_donated`: the system holds the
only reference to its state.

With `VideoNetEnabled=1` every frame's edge map and nav state go to
VideoNetHost:VideoNetPort through `io/telemetry.EdgeMapSender` (with the
encoded frame, `EncoderType`, and the `EdgeMapDelay` ring), in one more
host transfer a frame. The channel is lossy as in the JAX package: a send
the socket refuses (-1) or an OSError of the transport is counted in
`telemetry_dropped` and odometry goes on; any other error raises.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from rebvo_tpu_torch import obs
from rebvo_tpu_torch.config import REBVOParameters, load_config
from rebvo_tpu_torch.frontend.imu import ImuWindow
from rebvo_tpu_torch.frontend.step import VOFrontend
from rebvo_tpu_torch.io.logger import RunLogger

KF_SLOTS = 64            # the keyframe store's ring capacity


def transported_meas(rot, vel, rot_lie, W_X):
    """The pose-graph measurement of one frame (rebvo_second_t.cpp:
    326-334): rel_pose = [-R V; log R], and the estimator's information
    W_X on x = [V; W] pushed through the pseudo-inverse of
    J = d rel_pose / d x, in float64. Returns (rel_pose [6], W [6, 6])."""
    rel_t = -rot @ vel
    rel = np.concatenate([rel_t, rot_lie])
    J_rp_x = np.zeros((6, 6))
    J_rp_x[3:, 3:] = -np.eye(3)
    J_rp_x[:3, :3] = -rot
    J_rp_x[:3, 3:] = np.array([[0.0, -rel_t[2], rel_t[1]],
                               [rel_t[2], 0.0, -rel_t[0]],
                               [-rel_t[1], rel_t[0], 0.0]])
    J_x_rp = np.linalg.pinv(J_rp_x)
    return rel, J_x_rp.T @ W_X @ J_x_rp


class VOSystem:
    """End-to-end system: step + keyframes + pose log."""

    def __init__(self, params: REBVOParameters = None,
                 config_path: str = None, device="cuda"):
        if params is None:
            params = (load_config(config_path) if config_path
                      else REBVOParameters())
        self.params = params
        self.device = torch.device(device)
        self.frontend = VOFrontend(params, device=self.device)
        self.state = self.frontend.init()
        self.logger = RunLogger()
        self.frame_count = 0
        self._t_prev = 0.0          # host copy of state.t (float32)
        self._nav_lock = threading.Lock()
        self._nav = None
        self._callback: Optional[Callable] = None
        self._reset_requested = False
        self._last_tp2 = 0.0

        # keyframe store + pose-graph log (the TrackKeyFrames path)
        self.kf_store = None
        self.pose_log = None
        self.kf_push_enabled = True   # toggleKeyFrames (rebvo.h:462)
        if params.TrackKeyFrames:
            from rebvo_tpu_torch.backend.keyframe import KeyframeStore
            from rebvo_tpu_torch.backend.posegraph import PoseGraphLog
            self.kf_store = KeyframeStore.empty(KF_SLOTS, params.KeylineMax,
                                                device=self.device)
            self.pose_log = PoseGraphLog()

        # telemetry sender (VideoNetEnabled): edge map + encoded frame
        # (EncoderType selects raw/MJPEG, rebvo_third_t.cpp:117-143)
        self.sender = None
        self.telemetry_dropped = 0
        if params.VideoNetEnabled:
            from rebvo_tpu_torch.io.telemetry import EdgeMapSender
            self.sender = EdgeMapSender(
                params.VideoNetHost, params.VideoNetPort,
                params.ImageWidth, params.ImageHeight,
                video_etype=params.EncoderType,
                edgemap_delay=params.EdgeMapDelay)

        # IMU sample buffer for pushIMU (the ImuGrabber role)
        self._imu_samples = []
        self._imu_lock = threading.Lock()
        self._R_c2i = torch.eye(3, device=self.device)
        self._T_c2i = torch.zeros(3, device=self.device)

    # -- reference API surface (rebvo.h names) --------------------------

    def pushIMU(self, t: float, gyro, accel) -> None:
        """Thread-safe IMU sample push (rebvo.h:534)."""
        with self._imu_lock:
            self._imu_samples.append(
                (float(t), np.asarray(gyro, np.float32),
                 np.asarray(accel, np.float32)))

    def setCamImuSE3(self, R, T) -> None:
        f32 = dict(dtype=torch.float32, device=self.device)
        self._R_c2i = torch.as_tensor(np.asarray(R, np.float32)).to(**f32)
        self._T_c2i = torch.as_tensor(np.asarray(T, np.float32)).to(**f32)

    def getNav(self):
        """Latest nav state (thread-safe; rebvo.h:497)."""
        with self._nav_lock:
            return self._nav

    def setOutputCallback(self, fn: Callable) -> None:
        self._callback = fn

    def Reset(self) -> None:
        """Depth/trajectory reset request (system_reset semantics)."""
        self._reset_requested = True

    def TakeSnapshot(self, kf_path: str = "kf_list.npz",
                     poses_path: str = "poses_list.npz") -> None:
        """Save keyframes + pose log (the 's' command,
        app/rebvorun/main.cpp:132-136)."""
        if self.kf_store is not None:
            from rebvo_tpu_torch.backend.keyframe import save_keyframes
            save_keyframes(kf_path, self.kf_store)
        if self.pose_log is not None:
            self.pose_log.save(poses_path)

    # -- frame processing -----------------------------------------------

    def _collect_imu_window(self, t0: float, t1: float,
                            size: int = 32) -> ImuWindow:
        """The pushed samples in (t0, t1] as one window (host tensors),
        dropping them and every earlier one from the buffer."""
        with self._imu_lock:
            sel = [(t, g, a) for (t, g, a) in self._imu_samples
                   if t0 < t <= t1]
            self._imu_samples = [s for s in self._imu_samples if s[0] > t1]
        n = min(len(sel), size)
        gyro = np.zeros((size, 3), np.float32)
        accel = np.zeros((size, 3), np.float32)
        for i in range(n):
            gyro[i] = sel[i][1]
            accel[i] = sel[i][2]
        return ImuWindow(gyro=torch.from_numpy(gyro),
                         accel=torch.from_numpy(accel),
                         count=torch.tensor(n, dtype=torch.int32),
                         tsample=torch.tensor(self.params.SampleTime,
                                              dtype=torch.float32))

    def process_frame(self, frame, t: float,
                      imu_window: Optional[ImuWindow] = None,
                      frame_pair=None):
        """Process one frame; returns the FrameOutput (None for the
        bootstrap frame). `frame_pair` is the synchronised stereo frame
        when StereoAvaiable (the requestStereoCustomCamBuffer role,
        rebvo.h:570-585)."""
        with obs.unit(self.frame_count):
            return self._process_frame(frame, t, imu_window, frame_pair)

    def _process_frame(self, frame, t, imu_window, frame_pair):
        p = self.params
        fe = self.frontend
        tw0 = time.perf_counter()
        with obs.span("sys.prep"):
            t_prev = self._t_prev
            if self._reset_requested:
                # reference system_reset (rebvo_second_t.cpp:609-620): a
                # new state that keeps the detector threshold
                thresh = self.state.thresh
                self.state = fe.init()._replace(thresh=thresh)
                self.frame_count = 0
                self._reset_requested = False
            self._t_prev = float(np.float32(t))

        if self.frame_count == 0:
            with obs.span("sys.step"):
                self.state = fe.bootstrap(self.state, frame, t, frame_pair)
            self.frame_count += 1
            return None

        tw1 = time.perf_counter()
        with obs.span("sys.step"):
            if p.ImuMode > 0:
                if imu_window is None:
                    imu_window = self._collect_imu_window(
                        t_prev + p.TimeDesinc, t + p.TimeDesinc)
                self.state, out = fe.step_imu_donated(
                    self.state, frame, t, imu_window, self._R_c2i,
                    self._T_c2i, frame_pair)
            else:
                self.state, out = fe.step_donated(self.state, frame, t,
                                                  frame_pair)
        tw2 = time.perf_counter()
        with obs.span("sys.output"):
            self.frame_count += 1
            # host stage times: prep, step dispatch (the host's cost, not
            # the device's), and the previous frame's output section (this
            # frame's is still running: the span sys.output times it)
            self.logger.push(out, tproc=(tw1 - tw0, tw2 - tw1,
                                         self._last_tp2))

            with self._nav_lock:
                self._nav = out.nav
            if self._callback is not None:
                self._callback(out)

            if self.kf_store is not None:
                self._keyframe_and_log(out)
            if self.sender is not None:
                self._send(out, frame)
        self._last_tp2 = time.perf_counter() - tw2
        return out

    def _send(self, out, frame) -> None:
        """This frame's edge map and nav state to the telemetry channel
        (rebvo_third_t.cpp:192-236); lossy, so a refused send is counted,
        not raised."""
        nav = out.nav
        try:
            n = self.sender.send(self.state.klm, nav.scale, nav.Pos,
                                 nav.Pose, nav.t, frame=frame)
        except OSError:
            n = -1
        if n < 0:
            self.telemetry_dropped += 1

    def _keyframe_and_log(self, out) -> None:
        """Mirror a saved keyframe into the store (the step's online
        TrackKeyFrames decision, rebvo_second_t.cpp:591-596) and append
        the frame's transported measurement to the pose log. One host
        read of what both need."""
        from rebvo_tpu_torch.backend.keyframe import push_keyframe
        from rebvo_tpu_torch.backend.posegraph import OdometryMeas
        st, nav = self.state, out.nav
        dt = st.Vel.dtype
        packed = torch.cat([
            out.kf_saved.to(dt).reshape(1), out.kf_id.to(dt).reshape(1),
            nav.scale.reshape(1), nav.Rot.reshape(-1), st.Vel, nav.RotLie,
            nav.g, out.W_X.reshape(-1)])
        with obs.span("sys.read"):
            host = packed.cpu().numpy().astype(np.float64)
        saved, kf_id, scale = bool(host[0] > 0), int(host[1]), float(host[2])
        rot, vel, rot_lie = (host[3:12].reshape(3, 3), host[12:15],
                             host[15:18])
        g, W_X = host[18:21], host[21:57].reshape(6, 6)
        if self.kf_push_enabled and saved:
            push_keyframe(self.kf_store, st.klm, st.t, st.K_scale, st.Pose,
                          st.Pos, st.Vel)
        rel, W_meas = transported_meas(rot, vel, rot_lie, W_X)
        self.pose_log.add_frame_meas(OdometryMeas(
            rel_pose=rel, W=W_meas, g_est=g, K=scale, kf_id=kf_id))

    # -- run helpers -----------------------------------------------------

    def run_sequence(self, seq) -> RunLogger:
        """Replay an iterable of (t, frame, imu_window|None) or, for a
        stereo dataset, (t, frame, imu_window|None, frame_pair)."""
        for item in seq:
            t, frame, win = item[:3]
            pair = item[3] if len(item) == 4 else None
            self.process_frame(frame, t, win, frame_pair=pair)
        return self.logger

    def save_outputs(self, out_dir: str = ".") -> None:
        os.makedirs(out_dir, exist_ok=True)
        p = self.params
        if self.logger.rows:
            self.logger.write_trajectory(os.path.join(out_dir, p.TrayFile))
            if p.SaveLog:
                self.logger.write_mfile(os.path.join(out_dir, p.LogFile))
