"""The per-frame VO step, mono vision-only and visual-inertial (PyTorch
counterpart of rebvo_tpu/frontend/step.py; reference SecondThread,
src/rebvo/rebvo_second_t.cpp:128-623, plus FirstThr's detection stage,
rebvo_first_t.cpp:259-272).

    fe = VOFrontend(params, device="cuda")
    state = fe.bootstrap(fe.init(), frame0, t0)
    state, out = fe.step(state, frame, t)              # pure
    state, out = fe.step_donated(state, frame, t)      # reuses the input
    state, outs = fe.step_scan(state, frames, ts)      # N frames at once
    state, outs = fe.step_scan(state, frames, ts, wins)  # N VI frames
    state, outs = fe.step_scan(state, frames, ts, frames_pair=pairs)  # stereo
    state, out = fe.step_imu(state, frame, t, win)     # visual-inertial
    state, out = fe.step_imu_donated(state, frame, t, win)
    state, out = fe.step(state, frame, t, frame_pair)  # stereo (any step)

The step is a fixed sequence of tensor ops with no host synchronisation:
no `.item()`, no Python branch on a device value, no `nonzero`, so
`step_scan` captures N steps as one CUDA graph. `step` is pure like the
JAX package's: it leaves its input state as it was, and so copies the
nav-log ring to append a row. `step_donated` and `step_scan` may reuse
the input state's buffers (the ring is appended in place), like the JAX
package's donated entry points: the caller must not touch the old state.

The same body runs B sequences at once under `torch.func.vmap`
(parallel/mesh.shard_sequences), as the JAX package's step runs under
`jax.vmap`: no op writes a batched value into a buffer made inside the
step (the scatters are out of place), and on the CPU every product goes
through core/numerics.matmul, so a vmapped lane equals the lane alone
bit for bit there.

Each stage of `step` runs under a span of `rebvo_tpu_torch.obs`
(`vo.front`, `vo.detect` inside it, `vo.pose`, `vo.match_depth`,
`vo.keyframe`): a `torch.profiler` `record_function` of that name and a
record of its host time in the ring of `obs`; the rest of the step (pose
composition, nav row) is outside any span. `step_imu` adds `vo.imu` (IMU
integration, gyro-bias init and the map's pre-rotation) and
`vo.imu_filter` (ext_rot_vel, bias_correct and the scale/gravity
filter); its `vo.pose` holds minimizer_v (on the card one launch of
K3's 3-dof mode) and the forward match. The spans run where the host
runs the step's Python: eagerly, or once at a graph's capture. The device time of each stage comes from an
`obs.Timeline`: a CUDA event at the step's start, at each stage's end
and at the step's end (the rest between stages is `vo.rest`), which a
CUDA graph holds as event-record nodes, so every replay of `step_scan`
or of a vmapped step times its stages again, frame by frame; they are
read at the next entry call, without a sync. Every entry call is one
`obs.unit`, numbered by the frontend's host-side `frame_id`.

`step_scan` runs mono, visual-inertial and stereo steps. Given the N
frames' IMU windows (`wins`, stacked by `frontend.imu.stack_windows`) its
steps are `step_imu_donated`, with the frontend's camera-to-IMU
extrinsics; given cam1's N frames (`frames_pair`) each step takes its
pair; given both, the steps are stereo-VI. Each combination is a CUDA
graph of its own. The JAX package's `step_scan` is mono only.

Stereo (`StereoAvaiable=1`): every entry point takes the cam1 frame,
`frame_pair` (`step_scan`: `frames_pair`, [N, H, W]). `_detect_pair` runs
the detector on it with its own threshold carry and cam1's intrinsics
(the fused detector: the CUDA kernel a second time each frame), and
`_tail` adds the stereo velocity-scale carry and observers, the epipolar
stereo match against the cam1 map, the bootstrap re-gauge and the fusion
of the pair depth with the mono EKF, all under the `vo.stereo` span (the
pair's detection under `vo.detect` inside it). The `vo.stereo` device
stage holds the same blocks: each is its own interval between the
`vo.match_depth` ones, summed a step. A stereo frame given
`frame_pair=None` (a dropped cam1 frame) runs without the pair, as in
the JAX package, and is counted in the obs counter `stereo.unpaired`; a
`frame_pair` given to a mono frontend raises ValueError.
"""

from __future__ import annotations

from collections import namedtuple
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from rebvo_tpu_torch import obs
from rebvo_tpu_torch.config import REBVOParameters
from rebvo_tpu_torch.core.geometry import CameraModel, so3_exp, so3_log
from rebvo_tpu_torch.core.numerics import matmul
from rebvo_tpu_torch.core.stats import masked_median
from rebvo_tpu_torch.frontend.imu import (ImuWindow, ScaleWindows,
                                          bias_correct, est_acel_lsq4,
                                          est_ka_gmek_bias, ext_rot_vel,
                                          integrate_window, mean_acel4,
                                          rotation_between)
from rebvo_tpu_torch.frontend.kf_tracking import KFCarry, track_keyframe
from rebvo_tpu_torch.frontend.state import (BIG, RHO_INIT, RHO_MAX, RHO_MIN,
                                            KeylineMap, NavData, select_map)
# tree_map and tree_leaves are re-exported: callers of this module use them
from rebvo_tpu_torch.graphs import (GraphCache, copy_tree_,  # noqa: F401
                                    stack_trees, tree_leaves, tree_map)
from rebvo_tpu_torch.kernels.depth_filter import estimate_quantile
from rebvo_tpu_torch.kernels.edge_detect import (compact_keylines,
                                                 detect_keylines,
                                                 re_estimate_thresh,
                                                 update_detector_threshold)
from rebvo_tpu_torch.kernels.field import build_field
from rebvo_tpu_torch.kernels.match_depth import (MatchResult, match_maps,
                                                 md_depth, md_match,
                                                 rotate_map)
from rebvo_tpu_torch.kernels.matching import (directed_matching,
                                              forward_match)
from rebvo_tpu_torch.kernels.pose_solver import (FieldView, minimizer_rv,
                                                 minimizer_v)
from rebvo_tpu_torch.kernels.scale_space import build_scale_space
from rebvo_tpu_torch.kernels.stereo import (anchor_scale_measure,
                                            directed_matching_stereo,
                                            fuse_stereo_depth,
                                            velocity_scale_refine)

Tensor = torch.Tensor

# Intensity scale of the float images (the reference's RGB-sum
# convention: max_img_value = 255*3, rebvo.cpp:300).
MAX_IMG_VALUE = 765.0


class ImuCarry(NamedTuple):
    """Visual-inertial filter state (the reference's IMUState,
    rebvo.h:239-290, plus the ScaleEstimator statics). Carried unchanged
    by the mono step; `step_imu` updates it."""

    init: Tensor        # bool — gyro-bias init complete
    n_init: Tensor      # int32
    giro_init: Tensor   # [3]
    g_init: Tensor      # [3]
    Bg: Tensor          # [3] gyro bias
    W_Bg: Tensor        # [3,3]
    Vg: Tensor          # [3]
    X7: Tensor          # [7] scale/gravity/bias filter state
    P7: Tensor          # [7,7]
    u_est: Tensor       # [3]
    g_est: Tensor       # [3]
    b_est: Tensor       # [3]
    windows: ScaleWindows
    Posgv: Tensor       # [3]

    @staticmethod
    def make(params: REBVOParameters, dtype=torch.float32,
             device="cuda") -> "ImuCarry":
        p = params
        kw = dict(dtype=dtype, device=device)
        vb = p.VBiasStdDev ** 2 * 10
        P7 = torch.diag(torch.tensor(
            [p.ScaleStdDevInit ** 2, 100.0, 100.0, 100.0, vb, vb, vb], **kw))
        X7 = torch.tensor([np.pi / 4, 0.0, p.g_module, 0.0, 0.0, 0.0, 0.0],
                          **kw)
        dtf = 1.0 / p.config_fps
        W_Bg = torch.eye(3, **kw) / (p.GiroBiasStdDev ** 2 * dtf * dtf * 100.0)
        z3 = torch.zeros((3,), **kw)
        return ImuCarry(
            init=torch.zeros((), dtype=torch.bool, device=device),
            n_init=torch.zeros((), dtype=torch.int32, device=device),
            giro_init=z3, g_init=z3.clone(), Bg=z3.clone(), W_Bg=W_Bg,
            Vg=z3.clone(), X7=X7, P7=P7,
            u_est=torch.tensor([1.0, 0.0, 0.0], **kw),
            g_est=z3.clone(), b_est=z3.clone(),
            windows=ScaleWindows.init(dtype, device), Posgv=z3.clone())


# Packed nav-log row layout: one row appended per step to a device ring,
# so the host fetches the whole run in one transfer. Padded to 64 lanes.
NAVLOG_WIDTH = 64
IMU_DBG_ROWS = ("giro", "acel", "cacel", "dgiro", "GBias", "dWv", "dWgv",
                "VBias", "Av", "As", "Posgv")
NAVLOG_FIELDS = (
    ("t", 1), ("dt", 1), ("RotLie", 3), ("Vel", 3), ("PoseLie", 3),
    ("Pos", 3), ("g", 3), ("scale", 1), ("ok", 1), ("kl_num", 1),
    ("klm_num", 1), ("s_rho_q", 1), ("score", 1), ("stereo_num", 1),
    ("kf_id", 1), ("kf_back_m", 1), ("kf_saved", 1),
    ("Kp", 1), ("RKp", 1), ("imu_dbg", 3 * len(IMU_DBG_ROWS)),
)


class FrameOutput(NamedTuple):
    nav: NavData
    s_rho_q: Tensor
    score: Tensor
    rel_error: Tensor
    stereo_num: Tensor     # stereo matches this frame (0 in mono)
    kf_id: Tensor          # int32 active keyframe number (-1 = none)
    kf_back_m: Tensor      # int32 frame->KF matches surviving the prune
    kf_saved: Tensor       # bool — this frame was pushed as a keyframe
    W_X: Tensor            # [6,6] pose-estimator information of [V; W]
    Kp: Tensor             # per-frame rescaling ratio
    RKp: Tensor            # its variance estimate
    imu_dbg: Tensor        # [len(IMU_DBG_ROWS), 3] (zeros in mono)


def pack_nav_row(out: FrameOutput) -> Tensor:
    nav = out.nav
    dt = nav.t.dtype

    def s(a):
        return a.to(dt).reshape(1)

    parts = [
        s(nav.t), s(nav.dt), nav.RotLie, nav.Vel, nav.PoseLie, nav.Pos,
        nav.g, s(nav.scale), s(nav.estimation_ok), s(nav.kl_num),
        s(nav.klm_num), s(out.s_rho_q), s(out.score), s(out.stereo_num),
        s(out.kf_id), s(out.kf_back_m), s(out.kf_saved), s(out.Kp),
        s(out.RKp), out.imu_dbg.reshape(-1),
    ]
    row = torch.cat(parts)
    return torch.nn.functional.pad(row, (0, NAVLOG_WIDTH - row.shape[0]))


def unpack_nav_rows(rows) -> list:
    """Host-side: packed rows -> the RunLogger row-dict schema."""
    out = []
    for r in np.asarray(rows):
        d = {}
        o = 0
        for name, w in NAVLOG_FIELDS:
            d[name] = r[o] if w == 1 else np.asarray(r[o:o + w])
            o += w
        out.append(dict(
            t=float(d["t"]), dt=float(d["dt"]), RotLie=d["RotLie"],
            Vel=d["Vel"], PoseLie=d["PoseLie"], Pos=d["Pos"], g=d["g"],
            scale=float(d["scale"]), ok=bool(d["ok"] > 0),
            kl_num=int(d["kl_num"]), klm_num=int(d["klm_num"]),
            s_rho_q=float(d["s_rho_q"]), score=float(d["score"]),
            stereo_num=int(d["stereo_num"]), kf_id=int(d["kf_id"]),
            kf_back_m=int(d["kf_back_m"]), kf_saved=bool(d["kf_saved"] > 0),
            Kp=float(d["Kp"]), RKp=float(d["RKp"]),
            imu_dbg=np.asarray(d["imu_dbg"]).reshape(len(IMU_DBG_ROWS), 3),
        ))
    return out


class VOState(NamedTuple):
    """Carry state between frames (one sequence); fields as in
    rebvo_tpu/frontend/step.py VOState."""

    klm: KeylineMap
    mask_img: Tensor       # [H, W] previous map's detection id mask
    field_img: Tensor      # [H, W] previous map's match field
    thresh: Tensor         # detector auto-threshold
    retuned: Tensor        # previous frame's re-tuned threshold
    last_kl_num: Tensor
    thresh_pair: Tensor    # stereo pair detector threshold (unused, mono)
    last_kl_num_pair: Tensor
    Vel: Tensor            # [3] warm-start translation
    W0: Tensor             # [3] warm-start rotation
    Kp: Tensor
    P_Kp: Tensor
    K_scale: Tensor        # global metric scale (1 for vision-only)
    Pose: Tensor           # [3,3] global rotation
    Pos: Tensor            # [3] global position
    t: Tensor              # previous frame timestamp
    frame_count: Tensor    # int32
    imu: ImuCarry
    kf: KFCarry
    navlog: Tensor         # [NavLogCap, 64] device nav-log ring
    navlog_n: Tensor       # int32 rows written (can exceed the cap)
    G_gauge: Tensor        # cumulative rescaling ratio prod(Kp)
    VScaleC: Tensor        # stereo velocity-scale integrator (1 in mono)
    aR: Tensor             # [3,3] stereo scale-anchor epoch state
    aV: Tensor
    aAge: Tensor


def init_state(params: REBVOParameters, dtype=torch.float32,
               device="cuda") -> VOState:
    K = params.KeylineMax
    H, W = params.ImageHeight, params.ImageWidth
    kw = dict(dtype=dtype, device=device)

    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=device)

    return VOState(
        klm=KeylineMap.empty(K, dtype=dtype, device=device),
        mask_img=torch.full((H, W), -1, dtype=torch.int32, device=device),
        field_img=torch.full((H, W), -1, dtype=torch.int32, device=device),
        thresh=torch.full((), params.DetectorThresh, **kw),
        retuned=torch.zeros((), **kw),
        last_kl_num=i32(0),
        thresh_pair=torch.full((), params.DetectorThresh, **kw),
        last_kl_num_pair=i32(0),
        Vel=torch.zeros((3,), **kw),
        W0=torch.zeros((3,), **kw),
        Kp=torch.ones((), **kw),
        P_Kp=torch.full((), 5e-6, **kw),
        K_scale=torch.ones((), **kw),
        Pose=torch.eye(3, **kw),
        Pos=torch.zeros((3,), **kw),
        t=torch.zeros((), **kw),
        frame_count=i32(0),
        imu=ImuCarry.make(params, dtype, device),
        kf=KFCarry.empty(K if params.TrackKeyFrames else 1, dtype=dtype,
                         device=device),
        navlog=torch.zeros((max(params.NavLogCap, 1), NAVLOG_WIDTH), **kw),
        navlog_n=i32(0),
        G_gauge=torch.ones((), **kw),
        VScaleC=torch.ones((), **kw),
        aR=torch.eye(3, **kw),
        aV=torch.zeros((3,), **kw),
        aAge=i32(0),
    )


# `VOFrontend._front`'s results: the stage `vo.front`'s (the frame's
# keylines, their detection mask and threshold carry, the old map's depth
# quantile s_rho_q, the match field) and the cam1 frame's detection
# (stereo: its (klm1, mask1), None without one; its threshold carry)
_Front = namedtuple("_Front", "klm mask_img kl_num thresh retuned s_rho_q fv "
                    "field_img stereo thresh_pair kl_num_pair")
# `VOFrontend._tail`'s results: the frame's map, matched and filtered, its
# scale bookkeeping, and gauge_div, this frame's re-gauge of its depths
_Tail = namedtuple("_Tail", "klm klm_num est_ok Kp Kp_gauge P_Kp V_out "
                   "stereo_num gauge_div VScaleC aR aV aAge R")


class _Stages(NamedTuple):
    """A step body's results (`VOFrontend._mono`, `_vi`), the input of
    the frame skeleton's keyframe block and outputs. The last three are
    the VI filter's, None in a mono step."""

    front: _Front
    tail: _Tail
    R: Tensor              # the frame's rotation
    W0: Tensor             # the next frame's warm-start rotation
    nan_fail: Tensor
    W_X: Tensor            # pose-estimator information, before nan_fail
    score: Tensor
    rel_error: Optional[Tensor]
    K_scale: Tensor
    G_gauge: Tensor
    Pose: Tensor           # before the keyframe block
    Pos: Tensor
    g: Optional[Tensor] = None           # gravity estimate
    imu: Optional[ImuCarry] = None       # Vg before the re-gauge
    imu_dbg: Optional[tuple] = None      # rows in IMU_DBG_ROWS order


class VOFrontend:
    """Binds the static configuration and the device; exposes the mono
    and visual-inertial steps (the module docstring shows their calls).
    `UsePallas` keeps its meaning: non-zero runs the fused detector
    (kernels/cuda_scale_space.py: the CUDA kernel on a CUDA device, its
    plain version on the CPU), 0 the separate scale_space + edge_detect
    ops."""

    def __init__(self, params: REBVOParameters, cam: CameraModel = None,
                 device="cuda"):
        self.params = params
        self.device = torch.device(device)
        self.cam = cam if cam is not None else CameraModel.from_params(params)
        self.use_fused = params.UsePallas != 0
        # stereo twin (rebvo_second_t.cpp:465-485): the extrinsics come
        # from the config, and live on the device from here on, so the
        # step copies no host data
        self.stereo = bool(params.StereoAvaiable)
        if self.stereo:
            self.cam_pair = CameraModel.from_params(params, stereo=True)
            R01, t01 = params.stereo_extrinsics()
            f32 = dict(dtype=torch.float32, device=self.device)
            self._R01 = torch.as_tensor(np.asarray(R01, np.float32)).to(**f32)
            self._t01 = torch.as_tensor(np.asarray(t01, np.float32)).to(**f32)
        # visual-inertial (ImuMode): the camera-to-IMU extrinsics
        # (CamImuSE3File, else identity), on the device from here on, so
        # that a captured step_scan copies no host data
        self.R_cam2imu = self.T_cam2imu = None
        if params.ImuMode:
            R, T = np.eye(3), np.zeros(3)
            if params.CamImuSE3File:
                from rebvo_tpu_torch.io.dataset import read_cam_imu_se3
                R, T = read_cam_imu_se3(params.CamImuSE3File)
            f32 = dict(dtype=torch.float32, device=self.device)
            self.R_cam2imu = torch.as_tensor(np.asarray(R, np.float32)).to(
                **f32)
            self.T_cam2imu = torch.as_tensor(np.asarray(T, np.float32)).to(
                **f32)
        # step_scan's CUDA graphs, one per (N, H, W), and per (N, H, W, S)
        # with IMU windows of S samples; they all carry one static state
        self._graphs = GraphCache()
        # frame ids of the units this frontend opens (rebvo_tpu_torch.obs)
        self.frame_id = 0

    def init(self) -> VOState:
        return init_state(self.params, device=self.device)

    def _frame(self, frame) -> Tensor:
        return torch.as_tensor(frame).to(
            device=self.device, dtype=torch.float32).contiguous()

    def _time(self, t, like: Tensor) -> Tensor:
        if isinstance(t, Tensor):
            return t.to(device=like.device, dtype=like.dtype)
        return torch.full((), float(t), dtype=like.dtype, device=like.device)

    # ------------------------------------------------------------------

    def _detect_with(self, frame: Tensor, thresh0: Tensor,
                     last_kl_num: Tensor, cam: CameraModel):
        p = self.params
        thresh = update_detector_threshold(
            thresh0, last_kl_num, p.ReferencePoints, p.DetectorAutoGain,
            p.DetectorMaxThresh, p.DetectorMinThresh)
        if self.use_fused:
            from rebvo_tpu_torch.kernels.cuda_scale_space import \
                detect_candidates_cuda
            cand = detect_candidates_cuda(
                frame, thresh, sigma0=p.Sigma0, k_sigma=p.KSigma,
                win_s=p.DetectorPlaneFitSize,
                per_hist=p.DetectorPosNegThresh,
                dog_thresh=p.DetectorDoGThresh,
                max_img_value=MAX_IMG_VALUE)
            klm, mask_img, kl_num = compact_keylines(
                cand, K=p.KeylineMax, kl_max=p.MaxPoints, cx=cam.cx,
                cy=cam.cy)
        else:
            ss = build_scale_space(frame, p.Sigma0, p.KSigma, 3)
            klm, mask_img, kl_num = detect_keylines(
                ss, thresh, K=p.KeylineMax, kl_max=p.MaxPoints,
                win_s=p.DetectorPlaneFitSize,
                per_hist=p.DetectorPosNegThresh,
                dog_thresh=p.DetectorDoGThresh, max_img_value=MAX_IMG_VALUE,
                cx=cam.cx, cy=cam.cy)
        retuned = re_estimate_thresh(klm, p.TrackPoints, p.QCutOffNumBins)
        return klm, mask_img, kl_num, thresh, retuned

    def _detect(self, state: VOState, frame: Tensor):
        return self._detect_with(frame, state.thresh, state.last_kl_num,
                                 self.cam)

    def _detect_pair(self, state: VOState, frame_pair: Tensor):
        """Stereo-pair detection twin (rebvo_first_t.cpp:275-290): its own
        auto-threshold carry, the pair camera's intrinsics."""
        return self._detect_with(frame_pair, state.thresh_pair,
                                 state.last_kl_num_pair, self.cam_pair)

    def bootstrap(self, state: VOState, frame, t,
                  frame_pair=None) -> VOState:
        """Process the first frame: detection only (the reference's dummy
        first-frame consume, rebvo_second_t.cpp:108-122); a stereo pair
        frame advances the pair detector's threshold loop."""
        return self._entry(self._bootstrap, frame_pair, state, frame, t)

    def _bootstrap(self, state: VOState, frame, t, *,
                   frame_pair) -> VOState:
        frame = self._frame(frame)
        klm, mask_img, kl_num, thresh, retuned = self._detect(state, frame)
        field_img = build_field(
            klm, retuned,
            radius=min(self.params.FieldRadius, self.params.SearchRange),
            height=self.cam.height, width=self.cam.width)
        state = state._replace(
            klm=klm, mask_img=mask_img, field_img=field_img, thresh=thresh,
            retuned=retuned, last_kl_num=kl_num,
            t=self._time(t, state.t), frame_count=state.frame_count + 1)
        if frame_pair is not None:
            _, _, kl_num_p, thresh_p, _ = self._detect_pair(
                state, self._frame(frame_pair))
            state = state._replace(thresh_pair=thresh_p,
                                   last_kl_num_pair=kl_num_p)
        return state

    # ------------------------------------------------------------------

    def _front(self, state: VOState, frame: Tensor, frame_pair, tl):
        """The stage `vo.front` (detection, quantile, match field) and,
        given a cam1 frame, its detection under `vo.stereo`, with the pair
        detector's own threshold carry."""
        p = self.params
        cam = self.cam
        with obs.span("vo.front"):
            with obs.span("vo.detect"):
                new_klm, new_mask, kl_num, thresh, retuned = self._detect(
                    state, frame)
            s_rho_q = estimate_quantile(
                state.klm, percentile=p.QCutOffQuantile,
                nbins=p.QCutOffNumBins)
            field_img = build_field(
                new_klm, retuned, radius=min(p.FieldRadius, p.SearchRange),
                height=cam.height, width=cam.width)
            fv = FieldView.from_map(field_img, new_klm)
        tl.mark("vo.front")
        stereo, thresh_p, kl_num_p = None, state.thresh_pair, \
            state.last_kl_num_pair
        if frame_pair is not None:
            with obs.span("vo.stereo"), obs.span("vo.detect"):
                klm1, mask1, kl_num_p, thresh_p, _ = self._detect_pair(
                    state, self._frame(frame_pair))
            stereo = (klm1, mask1)
            tl.mark("vo.stereo")
        return _Front(new_klm, new_mask, kl_num, thresh, retuned, s_rho_q,
                      fv, field_img, stereo, thresh_p, kl_num_p)

    def _match(self, state: VOState, new: KeylineMap, V, P_V, nan_fail,
               m_id_f, W, R0, R) -> MatchResult:
        """The forward transfer along `m_id_f` (None: none), the forward
        rotation of the old map state.klm (by so3_exp(W), or by R0 with
        the back rotation R) and the directed matching: md_match (one
        launch of K5 on the card) with the strided field, plain ops with
        the 1-px mask (MatchFieldStride=0)."""
        p = self.params
        cam = self.cam
        if p.MatchFieldStride > 0:
            return md_match(state.klm, new, state.field_img, V, P_V,
                            nan_fail, cam=cam, params=p, m_id_f=m_id_f, W=W,
                            R0=R0, R=R)

        def matcher(new, old, back_rot):
            return directed_matching(
                new, old, state.mask_img, V, P_V, back_rot, zfm=cam.zfm,
                cx=cam.cx, cy=cam.cy, width=cam.width, height=cam.height,
                max_steps=p.MatchMaxSteps, min_thr_mod=p.MatchThreshModule,
                min_thr_ang=p.MatchThreshAngle,
                max_radius=float(p.SearchRange),
                loc_uncertainty=p.LocationUncertaintyMatch)
        dres, old, R0, est_ok = match_maps(
            state.klm, new, m_id_f, W, R0, R, nan_fail, matcher, zfm=cam.zfm,
            gmt=p.GlobalMatchThreshold)
        return MatchResult(dres.new, old, dres.nmatch, est_ok, R0)

    def _solver_vote_mask(self, old: KeylineMap):
        """Stereo: restrict the pose solver's cost vote to the
        pair-anchored keylines whenever at least GlobalMatchThreshold
        exist, else the whole map. None in mono (no restriction)."""
        if not self.stereo:
            return None
        anchored = old.valid & old.anchored
        enough = torch.sum(anchored) >= self.params.GlobalMatchThreshold
        return torch.where(enough, anchored, old.valid)

    def _tail(self, state: VOState, new: KeylineMap, V, P_V, nan_fail,
              stereo, tl, *, m_id_f=None, W=None, R0=None, R=None):
        """The forward transfer, rotation and directed matching (`_match`:
        state.klm is the old map before this frame's forward rotation, by
        so3_exp(W), or by R0 with the back rotation R), the depth
        filtering (md_depth), and the stereo depth fusion (`stereo` = the
        pair's (klm1, mask1)) or the mono rescaling. With a pair, the
        step's Timeline `tl` marks `vo.match_depth` before each stereo
        block and `vo.stereo` after it; without one, nothing."""
        p = self.params
        cam = self.cam
        one = torch.ones((), dtype=V.dtype, device=V.device)

        C_vel = state.VScaleC
        rescale_on = stereo is not None and p.StereoVelRescale
        if rescale_on:
            # Stereo translation-scale carry (see the JAX package): after
            # the bootstrap frames the solver keeps the direction, and the
            # magnitude is the integrator C times the solver's, leashed to
            # 0.7-1.4x the previous frame's
            tl.mark("vo.match_depth")
            with obs.span("vo.stereo"):
                boot = state.frame_count <= p.BootstrapRescaleFrames
                mag_prev = torch.linalg.norm(state.Vel)
                V = V * C_vel
                mag_raw = torch.linalg.norm(V)
                leash_ok = (~boot) & (mag_prev > 1e-8) & (mag_raw > 1e-12)
                mag_cl = torch.minimum(
                    torch.maximum(mag_raw, 0.7 * mag_prev), 1.4 * mag_prev)
                V = torch.where(
                    leash_ok, V * (mag_cl / torch.clamp(mag_raw, min=1e-12)),
                    V)
            tl.mark("vo.stereo")

        mt = self._match(state, new, V, P_V, nan_fail, m_id_f, W, R0, R)
        # the stereo blocks read the forward-rotated old map
        state = state._replace(klm=mt.old)
        # the frame's back rotation: so3_exp(W)^T in mono; the caller's in
        # VI, where it holds the IMU's rotation besides R0
        if R is None:
            R = mt.R0.mT
        klm_num = mt.nmatch
        est_ok = mt.est_ok

        if stereo is not None:
            tl.mark("vo.match_depth")
        if rescale_on:
            with obs.span("vo.stereo"):
                s_meas, n_sc = velocity_scale_refine(
                    mt.new, state.klm, V, cam.zfm,
                    k_px=float(p.LocationUncertaintyMatch) / 2.0)
                s_meas = torch.where(est_ok & (n_sc >= 100), s_meas, one)
                aV_cur = matmul(R.T, state.aV) + V
                aR_cur = matmul(R.T, state.aR)
                s_long, n_long, _ = anchor_scale_measure(
                    mt.new, aR_cur, aV_cur, cam.zfm)
                # age-based epochs
                at_epoch = state.aAge >= p.StereoScaleBaseFrames
                s_long = torch.where(est_ok & (state.aAge >= 4) &
                                     (n_long >= 50), s_long, one)
                # after the bootstrap only the epoch observer drives the
                # level: a strong gain out of a 5% deadband, a weak one
                # inside it
                s_long_exp = torch.where(torch.abs(s_long - 1.0) > 0.05,
                                         0.8 * one, 0.25 * one)
                early = state.frame_count <= 3 * p.BootstrapRescaleFrames
                s_long_exp = torch.maximum(
                    s_long_exp, torch.where(early, 0.5 * one, 0.0 * one))
                upd = s_meas ** torch.where(boot, 0.6 * one, 0.0 * one) * \
                    s_long ** s_long_exp
                upd = torch.where(est_ok, torch.clamp(upd, 0.5, 2.0), one)
                V = V * upd
                C_vel = torch.clamp(C_vel * upd, 0.05, 50.0)
                # log-domain EMA of the applied magnitude
                mag2 = torch.clamp(torch.linalg.norm(V), min=1e-12)
                sm_ok = leash_ok & est_ok & (mag2 > 1e-12)
                mag_sm = mag_prev ** 0.65 * mag2 ** 0.35
                V = torch.where(sm_ok, V * (mag_sm / mag2), V)
                # epoch bookkeeping: compose this frame's (refined)
                # motion; reset at the epoch boundary
                aV_cur = matmul(R.T, state.aV) + V
                aR_new = torch.where(at_epoch, torch.eye(3, dtype=V.dtype,
                                                         device=V.device),
                                     aR_cur)
                aV_new = torch.where(at_epoch, torch.zeros_like(aV_cur),
                                     aV_cur)
                aAge_new = torch.where(at_epoch,
                                       torch.zeros_like(state.aAge),
                                       state.aAge + 1)
        else:
            at_epoch = None
            aR_new, aV_new, aAge_new = state.aR, state.aV, state.aAge

        new_map = mt.new
        if p.SeedRhoMapMedian and stereo is not None:
            # gauge-coherent birth depth: fresh keylines start at the
            # median rho of the mature population (RhoInit while nothing
            # is mature); s_rho stays at RHO_MAX
            with obs.span("vo.stereo"):
                mature = new_map.valid & (new_map.m_num > 0)
                seed = torch.clamp(
                    masked_median(new_map.rho, mature, fallback=RHO_INIT),
                    RHO_MIN, RHO_MAX)
                fresh = new_map.valid & (new_map.m_num == 0)
                new_map = new_map._replace(
                    rho=torch.where(fresh, seed, new_map.rho),
                    rho0=torch.where(fresh, seed, new_map.rho0))
        if stereo is not None:
            tl.mark("vo.stereo")

        # regularize_1_iter and depth_ekf, without a pair the rescaling and
        # the est_ok select, and the scale bookkeeping (Kp_gauge skips
        # frames whose creep the applied rescale already removed from the
        # map): md_depth, one launch of K5 on the card
        dep = md_depth(new_map, V, nan_fail, klm_num, state.frame_count,
                       state.P_Kp, cam=cam, params=p,
                       rescale=stereo is None)
        if stereo is not None:
            tl.mark("vo.match_depth")
            with obs.span("vo.stereo"):
                proc, stereo_num, gauge_div = self._stereo_depth(
                    state, dep.klm, stereo, est_ok, at_epoch)
            tl.mark("vo.stereo")
            # only the fields the depth and stereo blocks changed
            new_final = select_map(est_ok, proc, mt.new)
        else:
            stereo_num = torch.zeros((), dtype=torch.int32, device=V.device)
            gauge_div = one
            new_final = dep.klm
        # gauge_div: the factor this frame's re-gauge divided the map's
        # inverse depths by; the caller multiplies the warm-start velocity
        # by it
        return _Tail(new_final, klm_num, est_ok, dep.Kp, dep.Kp_gauge,
                     dep.P_Kp, dep.V_out, stereo_num, gauge_div, C_vel,
                     aR_new, aV_new, aAge_new, R)

    def _stereo_depth(self, state: VOState, proc: KeylineMap, stereo,
                      est_ok, at_epoch):
        """The stereo depth block (rebvo_second_t.cpp:465-489): epipolar
        match against the pair map, the bootstrap re-gauge to the pair's
        metric gauge, the fusion of the pair depth with the mono EKF, and
        the anchored / rho_st / scale-anchor fields. Returns (map,
        stereo_num, gauge_div)."""
        p = self.params
        cam, cp = self.cam, self.cam_pair
        klm1, mask1 = stereo
        one = torch.ones((), dtype=proc.rho.dtype, device=proc.rho.device)
        sres = directed_matching_stereo(
            proc, klm1, mask1, self._t01, self._R01,
            zf0=cam.zfm, zf1=cp.zfm, cx1=cp.cx, cy1=cp.cy,
            width=cam.width, height=cam.height,
            max_steps=p.StereoMatchMaxSteps,
            min_thr_mod=p.MatchThreshModule,
            min_thr_ang=p.MatchThreshAngle,
            max_radius=float(p.StereoSearchRange),
            loc_uncertainty=p.LocationUncertaintyMatch,
            prior_window=bool(p.StereoPriorWindow))
        # bootstrap re-gauge: during the first frames, divide the whole
        # map by the median ratio of its rho to the pair-geometry rho
        gauge_div = one
        if p.BootstrapRescaleFrames > 0:
            hasm = (sres.stereo_m_id >= 0) & proc.valid & \
                (sres.stereo_rho > RHO_MIN)
            g_st = masked_median(
                proc.rho / torch.clamp(sres.stereo_rho, min=RHO_MIN), hasm)
            g_st = torch.clamp(g_st, 1e-3, 1e3)
            boot_st = (state.frame_count <= p.BootstrapRescaleFrames) & \
                (sres.nmatch > p.GlobalMatchThreshold) & \
                (torch.abs(g_st - 1.0) > 0.05) & est_ok
            gauge_div = torch.where(boot_st, g_st, one)
            proc = proc._replace(rho=proc.rho / gauge_div,
                                 s_rho=proc.s_rho / gauge_div)
        proc = fuse_stereo_depth(proc, sres.stereo_m_id, sres.stereo_rho,
                                 sres.stereo_s_rho)
        # pair-anchored flags for the next frame's pose-solver vote
        has_st = (sres.stereo_m_id >= 0) & proc.valid
        zero = torch.zeros_like(sres.stereo_rho)
        rho_st = torch.where(has_st, sres.stereo_rho, zero)
        proc = proc._replace(anchored=has_st, rho_st=rho_st)
        if p.StereoVelRescale:
            # scale-anchor epoch reset: re-anchor every keyline with a
            # fresh pair depth at its current position
            proc = proc._replace(
                ax=torch.where(at_epoch, proc.px, proc.ax),
                ay=torch.where(at_epoch, proc.py, proc.ay),
                arho=torch.where(at_epoch, rho_st, proc.arho))
        return proc, sres.nmatch, gauge_div

    # ------------------------------------------------------------------
    # Entry points and the frame skeleton
    # ------------------------------------------------------------------

    def step(self, state: VOState, frame, t,
             frame_pair=None) -> Tuple[VOState, FrameOutput]:
        """One frame (`frame_pair`: the cam1 frame, stereo only). Pure:
        the input state is left as it was."""
        return self._entry(self._step, frame_pair, self._mono, False, state,
                           frame, t)

    def step_donated(self, state: VOState, frame, t,
                     frame_pair=None) -> Tuple[VOState, FrameOutput]:
        """`step` that may reuse the input state's buffers (it appends the
        nav-log row in place), the counterpart of the JAX package's
        donated step: the caller must not touch the old state."""
        return self._entry(self._step, frame_pair, self._mono, True, state,
                           frame, t)

    def step_imu(self, state: VOState, frame, t, win: ImuWindow,
                 R_cam2imu: Tensor = None, T_cam2imu: Tensor = None,
                 frame_pair=None) -> Tuple[VOState, FrameOutput]:
        """One visual-inertial frame: `win` holds the IMU samples since
        the previous frame, in the IMU frame (R_cam2imu / T_cam2imu: the
        camera-to-IMU extrinsics, default identity). Pure: the input
        state is left as it was. `frame_pair`: the cam1 frame, stereo
        only."""
        return self._entry(self._step, frame_pair, self._vi, False, state,
                           frame, t, win, R_cam2imu, T_cam2imu)

    def step_imu_donated(self, state: VOState, frame, t, win: ImuWindow,
                         R_cam2imu: Tensor = None, T_cam2imu: Tensor = None,
                         frame_pair=None) -> Tuple[VOState, FrameOutput]:
        """`step_imu` that appends the nav-log row into the input state's
        ring in place (the JAX package's donated step_imu): the caller
        must not touch the old state."""
        return self._entry(self._step, frame_pair, self._vi, True, state,
                           frame, t, win, R_cam2imu, T_cam2imu)

    def _entry(self, fn, frame_pair, *args, n: int = 1):
        """An entry call of n frames, one `obs.unit`: `fn(*args,
        frame_pair=...)`. A `frame_pair` given to a mono frontend raises
        ValueError. A stereo frontend's call given none, outside another
        entry call, counts its n frames in `stereo.unpaired`."""
        if frame_pair is not None and not self.stereo:
            raise ValueError("frame_pair given to a mono frontend "
                             "(StereoAvaiable=0)")
        if self.stereo and frame_pair is None and obs.open_unit() is None:
            obs.count("stereo.unpaired", n)
        with obs.unit(self, n):
            return fn(*args, frame_pair=frame_pair)

    def _step(self, body, donate: bool, state: VOState, frame, t, *extra,
              frame_pair) -> Tuple[VOState, FrameOutput]:
        """The frame skeleton of every step: the frame, `t` and the clamped
        `dt_frame`; `body`'s stages (`_mono` or `_vi`, given `extra`); the
        keyframe block; then NavData, FrameOutput, the nav-log row and the
        next VOState, built here alone."""
        p = self.params
        tl = obs.Timeline(state.Vel.device)
        frame = self._frame(frame)
        t = self._time(t, state.t)
        dt_frame = t - state.t
        dt_frame = torch.where(
            dt_frame < 0.001,
            torch.full_like(dt_frame, 1.0 / p.config_fps), dt_frame)
        s = body(state, frame, dt_frame, frame_pair, tl, *extra)
        tl.mark()
        fr, tail = s.front, s.tail
        kw = dict(dtype=state.Vel.dtype, device=state.Vel.device)
        i32 = dict(dtype=torch.int32, device=kw["device"])
        kf_carry, klm, Pose, Pos = state.kf, tail.klm, s.Pose, s.Pos
        with obs.span("vo.keyframe"):
            if p.TrackKeyFrames:          # online keyframe tracking
                res = track_keyframe(
                    kf_carry, klm, fr.fv, Pose, Pos, s.K_scale, fr.kl_num,
                    fr.s_rho_q, tail.est_ok, s.G_gauge, cam=self.cam,
                    params=p)
                kf_carry, klm, Pose, Pos = res.kf, res.klm, res.Pose, res.Pos
                kf_id, kf_back_m, kf_saved = (res.kf.count - 1, res.back_m,
                                              res.saved)
            else:
                kf_id = torch.full((), -1, **i32)
                kf_back_m = torch.zeros((), **i32)
                kf_saved = torch.zeros((), dtype=torch.bool,
                                       device=kw["device"])
        tl.mark("vo.keyframe")

        vi = s.imu is not None
        rot_lie = so3_log(s.R)
        vel = -tail.V_out * s.K_scale
        if not vi:     # mono's gauge-consistent export (see `_mono`)
            vel = vel * s.G_gauge
        nav = NavData(
            t=t, dt=dt_frame, Rot=s.R, RotLie=rot_lie, Vel=vel / dt_frame,
            Pose=Pose, PoseLie=so3_log(Pose), Pos=Pos,
            g=s.g if vi else torch.zeros(3, **kw), scale=s.K_scale,
            estimation_ok=tail.est_ok, kl_num=fr.kl_num,
            klm_num=tail.klm_num)
        # the warm starts follow this frame's re-gauge
        imu = s.imu._replace(Vg=s.imu.Vg * tail.gauge_div) if vi else \
            state.imu
        W_X = torch.where(s.nan_fail, torch.eye(6, **kw) * 1e-12, s.W_X)
        imu_dbg = torch.stack(s.imu_dbg).to(kw["dtype"]) if vi else None
        out = FrameOutput(
            nav=nav, s_rho_q=fr.s_rho_q, score=s.score,
            rel_error=torch.zeros((), **kw) if vi else s.rel_error,
            stereo_num=tail.stereo_num, kf_id=kf_id, kf_back_m=kf_back_m,
            kf_saved=kf_saved, W_X=W_X, Kp=tail.Kp, RKp=tail.P_Kp,
            imu_dbg=imu_dbg if vi else torch.zeros((len(IMU_DBG_ROWS), 3),
                                                   **kw))
        navlog, navlog_n = state.navlog, state.navlog_n
        if p.NavLogCap > 0:
            # the packed row appended to the device ring: in place when
            # the input state is donated, else into a copy of the ring;
            # in place by index_put_, which vmap batches (index_copy_ it
            # does not)
            row = pack_nav_row(out)
            idx = (navlog_n % navlog.shape[0]).to(torch.int64).reshape(1)
            navlog = navlog.index_put_((idx,), row[None]) if donate else \
                navlog.index_copy(0, idx, row[None])
            navlog_n = navlog_n + 1
        new_state = VOState(
            klm=klm, mask_img=fr.mask_img, field_img=fr.field_img,
            thresh=fr.thresh, retuned=fr.retuned, last_kl_num=fr.kl_num,
            thresh_pair=fr.thresh_pair, last_kl_num_pair=fr.kl_num_pair,
            Vel=tail.V_out * tail.gauge_div, W0=s.W0, Kp=tail.Kp,
            P_Kp=tail.P_Kp, K_scale=s.K_scale, Pose=Pose, Pos=Pos, t=t,
            frame_count=state.frame_count + 1, imu=imu, kf=kf_carry,
            navlog=navlog, navlog_n=navlog_n, G_gauge=s.G_gauge,
            VScaleC=tail.VScaleC, aR=tail.aR, aV=tail.aV, aAge=tail.aAge)
        tl.close()
        return new_state, out

    def _mono(self, state: VOState, frame: Tensor, dt_frame, frame_pair,
              tl) -> _Stages:
        """The vision-only stages (rebvo_second_t.cpp:338-382 + common
        tail): `vo.front`, `vo.pose` (minimizer_rv), `vo.match_depth`,
        the pose composition."""
        p = self.params
        cam = self.cam
        dt_f = state.Vel.dtype
        dev = state.Vel.device
        fr = self._front(state, frame, frame_pair, tl)
        old = state.klm

        with obs.span("vo.pose"):
            match_num_min = torch.clamp(state.frame_count,
                                        max=p.MatchNumThresh)
            mres = minimizer_rv(
                state.Vel, state.W0, old, fr.fv, zfm=cam.zfm, cx=cam.cx,
                cy=cam.cy, width=cam.width, height=cam.height,
                match_thresh=p.TrackerMatchThresh, max_s_rho=fr.s_rho_q,
                match_num_min=match_num_min, k_huber=p.ReweigthDistance,
                iter_max=p.TrackerIterNum, init_iter=p.TrackerInitIterNum,
                init_type=p.TrackerInitType,
                vote_mask=self._solver_vote_mask(old))

            nan_fail = torch.any(~torch.isfinite(mres.Vel)) | \
                torch.any(~torch.isfinite(mres.W0))
            z3 = torch.zeros(3, dtype=dt_f, device=dev)
            V = torch.where(nan_fail, z3, mres.Vel)
            W = torch.where(nan_fail, z3, mres.W0)
            P_V = torch.where(nan_fail,
                              torch.eye(3, dtype=dt_f, device=dev) * BIG,
                              mres.RVel)
        tl.mark("vo.pose")

        with obs.span("vo.match_depth"):
            tail = self._tail(state, fr.klm, V, P_V, nan_fail, fr.stereo, tl,
                              m_id_f=mres.m_id_f, W=W)
            R = tail.R
        tl.mark("vo.match_depth")

        K_scale = state.K_scale
        Pose = matmul(state.Pose, R)
        # gauge-consistent export (mono): multiply exported displacements
        # by the cumulative rescaling ratio (see the JAX package)
        if p.GaugeExport:
            G_gauge = torch.clamp(state.G_gauge * tail.Kp_gauge, 1e-4, 1e4)
        else:
            G_gauge = state.G_gauge
        Pos = state.Pos - matmul(Pose, tail.V_out * K_scale * G_gauge)
        return _Stages(fr, tail, R, W, nan_fail, mres.W_X, mres.score,
                       mres.rel_error, K_scale, G_gauge, Pose, Pos)

    def _vi(self, state: VOState, frame: Tensor, dt_frame, frame_pair, tl,
            win: ImuWindow, R_cam2imu, T_cam2imu) -> _Stages:
        """The visual-inertial stages (rebvo_second_t.cpp:182-335,
        528-546): `vo.imu`, `vo.front`, `vo.pose` (minimizer_v),
        `vo.imu_filter`, `vo.match_depth`, the gravity-aligned pose."""
        p = self.params
        cam = self.cam
        dt_f = state.Vel.dtype
        dev = state.Vel.device
        kw = dict(dtype=dt_f, device=dev)
        win = ImuWindow(*[torch.as_tensor(x).to(self.device) for x in win])
        eye3 = torch.eye(3, **kw)
        z3 = torch.zeros(3, **kw)
        R_cam2imu = eye3 if R_cam2imu is None else \
            torch.as_tensor(R_cam2imu).to(**kw)
        T_cam2imu = z3 if T_cam2imu is None else \
            torch.as_tensor(T_cam2imu).to(**kw)
        ic = state.imu

        with obs.span("vo.imu"):
            imu = integrate_window(win, R_cam2imu, T_cam2imu)

            # --- Gyro-bias initialisation (rebvo_second_t.cpp:163-185).
            accumulating = (~ic.init) & (state.frame_count > 0)
            giro_init = torch.where(accumulating,
                                    ic.giro_init + imu.giro * imu.dt,
                                    ic.giro_init)
            g_init = torch.where(accumulating, ic.g_init - imu.cacel,
                                 ic.g_init)
            n_init = torch.where(accumulating, ic.n_init + 1, ic.n_init)
            done = accumulating & (n_init > p.InitBiasFrameNum)
            nf = torch.clamp(n_init, min=1).to(dt_f)
            Bg = torch.where(done, giro_init / nf, ic.Bg)
            W_Bg = torch.where(
                done,
                torch.linalg.inv_ex(eye3 * (p.GiroBiasStdDev ** 2 * dt_frame *
                                            dt_frame * 1e2))[0],
                ic.W_Bg)
            X7 = torch.where(done, torch.cat([ic.X7[:1], g_init / nf,
                                              ic.X7[4:]]), ic.X7)
            init = ic.init | done
            if p.InitBias == 0:
                init = torch.ones((), dtype=torch.bool, device=dev)
                Bg = (eye3[0] * p.BiasHintX + eye3[1] * p.BiasHintY +
                      eye3[2] * p.BiasHintZ) * imu.dt

            # --- IMU pre-rotation (rebvo_second_t.cpp:206-211):
            # R^T = SO3(Bg) @ Rot^T  ->  R = Rot @ SO3(Bg)^T.
            R = imu.Rot @ so3_exp(Bg).T
            old_pre = self._rotate_map(state.klm, R.T)
        tl.mark("vo.imu")

        fr = self._front(state._replace(klm=old_pre), frame, frame_pair, tl)

        with obs.span("vo.pose"):
            match_num_min = torch.clamp(state.frame_count,
                                        max=p.MatchNumThresh)
            # IMU-propagated warm start (see the JAX package): the
            # previous displacement moved by the accel increment, in the
            # VO gauge; back-displacement convention, hence the minus.
            filter_on = state.frame_count > (4 + p.InitBiasFrameNum)
            dv_imu = -(imu.cacel + ic.g_est) * dt_frame * dt_frame / \
                torch.clamp(state.K_scale, min=1e-6)
            dv_imu = torch.where(filter_on & torch.all(torch.isfinite(dv_imu)),
                                 dv_imu, z3)
            Vg0 = z3 if p.TrackerInitType == 0 else ic.Vg + dv_imu
            vres = minimizer_v(
                Vg0, old_pre, fr.fv, zfm=cam.zfm, cx=cam.cx, cy=cam.cy,
                width=cam.width, height=cam.height,
                match_thresh=p.TrackerMatchThresh, max_s_rho=fr.s_rho_q,
                match_num_min=match_num_min, k_huber=p.ReweigthDistance,
                min_mod=state.retuned, iter_max=p.TrackerIterNum,
                vote_mask=self._solver_vote_mask(old_pre))
            Vg = vres.Vel
            new_fm, _ = forward_match(old_pre, fr.klm, vres.m_id_f)
        tl.mark("vo.pose")

        with obs.span("vo.imu_filter"):
            # --- 6-dof linear correction + gyro fusion.
            ok_x, W_Xv, R_Xv, Xv = ext_rot_vel(
                new_fm, Vg, cam.zfm, p.LocationUncertainty,
                p.ReweigthDistance)
            RGBias = eye3 * (p.GiroBiasStdDev ** 2 * dt_frame * dt_frame)
            RGiro = eye3 * (p.GiroMeasStdDev ** 2 * dt_frame * dt_frame)
            Xgv, W_Xgv, dgbias, W_Bg = bias_correct(Xv, W_Xv, z3, W_Bg,
                                                    RGiro, RGBias)
            Bg = Bg + dgbias

            dVgv = Xgv[:3]
            dWgv = Xgv[3:]
            Rgva_pre = R
            R0 = so3_exp(dWgv)
            R = R @ R0.T                      # R^T = R0 @ R^T
            Vgv = R0 @ Vg + dVgv
            V = Vgv
            R_Xgv = torch.linalg.inv_ex(W_Xgv)[0]
            P_V = R_Xgv[:3, :3]
            P_W = R_Xgv[3:, 3:]

            # --- Scale/gravity filter (rebvo_second_t.cpp:282-312).
            win1, Av = est_acel_lsq4(ic.windows, -Vgv / dt_frame, R,
                                     dt_frame)
            win2, As = mean_acel4(win1, imu.cacel, R)

            Rv = P_V / (dt_frame ** 4)
            Qrot = P_W
            QKp = state.P_Kp
            Qg = eye3 * (p.g_uncert ** 2)
            Rg_mod = torch.full((), p.g_module_uncer ** 2, **kw)
            Rs = eye3 * (p.AcelMeasStdDev ** 2)
            Qbias = eye3 * (p.VBiasStdDev ** 2)

            Kf, X7n, P7n, g_est, b_est, Xgva = est_ka_gmek_bias(
                As, Av, torch.ones((), **kw), R, X7, ic.P7,
                Qg, Qrot, Qbias, QKp, Rg_mod, Rs, Rv,
                W_Xgv, Xgv, p.g_module, nll_logdet=bool(p.ScaleFilterLogDet))
            K_scale = torch.where(filter_on, Kf, state.K_scale)
            X7 = torch.where(filter_on, X7n, X7)
            P7 = torch.where(filter_on, P7n, ic.P7)
            g_est = torch.where(filter_on, g_est, ic.g_est)
            b_est = torch.where(filter_on, b_est, ic.b_est)

            dVgva = torch.where(filter_on, Xgva[:3], dVgv)
            dWgva = torch.where(filter_on, Xgva[3:], dWgv)
            R0gva = so3_exp(dWgva)
            Rgva = torch.where(filter_on, Rgva_pre @ R0gva.T, R)
            Vgva = torch.where(filter_on, R0gva @ Vg + dVgva, Vgv)
        tl.mark("vo.imu_filter")

        with obs.span("vo.match_depth"):
            nan_fail = torch.any(~torch.isfinite(V)) | (~ok_x)
            V = torch.where(nan_fail, z3, V)
            P_V = torch.where(nan_fail, eye3 * BIG, P_V)
            # the second forward rotation of the old map (by R0) in _tail
            tail = self._tail(state._replace(klm=old_pre), new_fm, V, P_V,
                              nan_fail, fr.stereo, tl, R0=R0, R=R)
        tl.mark("vo.match_depth")

        # --- Gravity-aligned pose integration (rebvo_second_t.cpp:528-546).
        u_est = Rgva.T @ ic.u_est
        u_est = u_est - (torch.dot(u_est, g_est) /
                         torch.clamp(torch.dot(g_est, g_est), min=1e-12)) * \
            g_est
        u_norm = torch.linalg.norm(u_est)
        u_est = u_est / torch.where(u_norm > 1e-12, u_norm,
                                    torch.ones_like(u_norm))
        PoseP1 = rotation_between(g_est, eye3[1])
        PoseP2 = rotation_between(PoseP1 @ u_est, eye3[0])
        Pose_f = PoseP2 @ PoseP1
        Pos_f = state.Pos - Pose_f @ (Vgva * K_scale)
        Posgv = ic.Posgv - Pose_f @ (Vgv * K_scale)

        Pose = torch.where(filter_on, Pose_f, state.Pose)
        Pos = torch.where(filter_on, Pos_f, state.Pos)
        u_est = torch.where(filter_on, u_est, ic.u_est)

        imu_carry = ImuCarry(
            init=init, n_init=n_init, giro_init=giro_init, g_init=g_init,
            Bg=Bg, W_Bg=W_Bg, Vg=Vg, X7=X7, P7=P7, u_est=u_est,
            g_est=g_est, b_est=b_est, windows=win2, Posgv=Posgv)
        # VI filter internals for the .m log (rebvo_third_t.cpp:283-299
        # census)
        imu_dbg = (imu.giro, imu.acel, imu.cacel, imu.dgiro, Bg, Xv[3:],
                   dWgv, b_est, Av, As, Posgv)
        return _Stages(fr, tail, R, dWgv, nan_fail, W_Xgv, vres.score, None,
                       K_scale, state.G_gauge, Pose, Pos, g_est, imu_carry,
                       imu_dbg)

    # ------------------------------------------------------------------
    # Chunked step (the counterpart of the JAX package's lax.scan)
    # ------------------------------------------------------------------

    def step_scan(self, state: VOState, frames, ts,
                  wins: Optional[ImuWindow] = None, frames_pair=None
                  ) -> Tuple[VOState, FrameOutput]:
        """Advance over a chunk of frames ([N, H, W], timestamps [N]);
        returns the final state and the N per-frame outputs stacked on a
        leading axis, as lax.scan stacks them. Donates its input state
        like `step_donated`.

        With `wins`, the N frames' IMU windows stacked on a leading axis
        (gyro and accel [N, S, 3], count [N], tsample [N];
        `frontend.imu.stack_windows`), each step is `step_imu_donated`
        with the frontend's camera-to-IMU extrinsics (`R_cam2imu`,
        `T_cam2imu`); a frontend without ImuMode refuses them. Windows
        handed over on the host are counted (`obs`): `imu.samples`, the
        valid samples, and `imu.truncated`, the windows filled to S (a
        window packer keeps at most S samples, so every window it cut is
        among them).

        With `frames_pair`, cam1's N frames ([N, H, W], undistorted by
        the caller as `frames` are), step i takes frame_pair
        `frames_pair[i]`; a frontend without StereoAvaiable refuses them,
        as pairs of another shape than the frames'. They are counted in
        `stereo.pairs`. A stereo frontend given none steps every frame
        without its pair, as the eager step does a dropped cam1 frame.

        On a CUDA state the N steps are one CUDA graph
        (`graphs.GraphCache`), captured at the first call for each (N, H,
        W), (N, H, W, S) with windows, and either with "pair" added for
        pairs, and replayed by every later call. The frames, timestamps,
        windows and pairs are copied into the graph's static buffers, and
        a state other than the one the last call returned into its static
        state. The state returned IS that static state, so chained calls
        copy no state, and the next call overwrites it; the outputs
        returned are copies. A capture that fails raises: a CUDA state
        never runs the steps eagerly here. On a CPU state the same N
        steps run in a Python loop. The call is one `obs.unit` of N
        frames."""
        return self._entry(self._step_scan, frames_pair, state, frames, ts,
                           wins, n=len(frames))

    def _scan_windows(self, wins: ImuWindow, n: int) -> ImuWindow:
        """step_scan's windows as tensors, checked and counted."""
        if not self.params.ImuMode:
            raise ValueError("step_scan: IMU windows given to a "
                             "vision-only frontend (ImuMode=0)")
        wins = ImuWindow(*[torch.as_tensor(x) for x in wins])
        g = wins.gyro
        if (g.ndim != 3 or tuple(g.shape[::2]) != (n, 3)
                or wins.accel.shape != g.shape
                or tuple(wins.count.shape) != (n,)
                or tuple(wins.tsample.shape) != (n,)):
            raise ValueError(
                f"step_scan: windows must be gyro and accel [{n}, S, 3], "
                f"count and tsample [{n}], got "
                f"{[tuple(x.shape) for x in wins]}")
        if wins.count.device.type == "cpu":
            obs.count("imu.samples", int(wins.count.sum()))
            obs.count("imu.truncated", int((wins.count >= g.shape[1]).sum()))
        return wins

    def _scan_pairs(self, pairs, frames: Tensor) -> Tensor:
        """step_scan's cam1 frames as a tensor, checked and counted."""
        pairs = self._frame(pairs)
        if pairs.shape != frames.shape:
            raise ValueError(
                f"step_scan: frames_pair must have the frames' shape "
                f"{tuple(frames.shape)}, got {tuple(pairs.shape)}")
        obs.count("stereo.pairs", pairs.shape[0])
        return pairs

    def _scan_steps(self, state: VOState, inputs: tuple, n: int):
        """The first n steps of a chunk, `inputs` (frames, ts, windows or
        (), (cam1 frames,) or ()): `step_donated`, or `step_imu_donated`
        with each frame's window, each given its cam1 frame if there are
        pairs. Returns the state and the n outputs."""
        frames, ts, wins, pairs = inputs
        outs = []
        for i in range(n):
            pair = pairs[0][i] if pairs else None
            if wins:
                state, out = self.step_imu_donated(
                    state, frames[i], ts[i],
                    ImuWindow(*[x[i] for x in wins]), self.R_cam2imu,
                    self.T_cam2imu, pair)
            else:
                state, out = self.step_donated(state, frames[i], ts[i], pair)
            outs.append(out)
        return state, outs

    def _step_scan(self, state: VOState, frames, ts, wins, *, frame_pair):
        frames = self._frame(frames)
        ts = torch.as_tensor(ts, dtype=state.t.dtype).to(state.t.device)
        if frames.ndim != 3 or tuple(ts.shape) != tuple(frames.shape[:1]):
            raise ValueError(f"step_scan: frames must be [N, H, W] and ts "
                             f"[N], got {tuple(frames.shape)} and "
                             f"{tuple(ts.shape)}")
        n = frames.shape[0]
        key = tuple(frames.shape)
        if wins is not None:
            wins = self._scan_windows(wins, n)
            key += (wins.gyro.shape[1], "imu")
        pairs = ()
        if frame_pair is not None:
            pairs = (self._scan_pairs(frame_pair, frames),)
            key += ("pair",)
        inputs = (frames, ts, () if wins is None else wins, pairs)
        if state.t.device.type == "cpu":
            state, outs = self._scan_steps(state, inputs, n)
            return state, stack_trees(outs)
        if state.t.device.type != "cuda":
            raise ValueError(f"step_scan: unsupported device "
                             f"{state.t.device}")

        def run(static, x):
            # the N steps from the static state, which then takes the
            # final state; the warm-up runs two steps on a clone
            st, outs = self._scan_steps(static, x, n)
            outs = stack_trees(outs)    # before the copy: an output
            copy_tree_(static, st)      # may be a static state leaf
            return outs

        return self._graphs(key, state, inputs, run,
                            lambda st, x: self._scan_steps(st, x,
                                                           min(2, n))[0])

    # ------------------------------------------------------------------

    def _rotate_map(self, klm: KeylineMap, R0: Tensor) -> KeylineMap:
        """Forward-rotate an edge map (edge_tracker::rotate_keylines)."""
        return rotate_map(klm, R0, self.cam.zfm)
