"""The per-frame VO step, mono vision-only and visual-inertial (PyTorch
counterpart of rebvo_tpu/frontend/step.py; reference SecondThread,
src/rebvo/rebvo_second_t.cpp:128-623, plus FirstThr's detection stage,
rebvo_first_t.cpp:259-272).

    fe = VOFrontend(params, device="cuda")
    state = fe.bootstrap(fe.init(), frame0, t0)
    state, out = fe.step(state, frame, t)              # pure
    state, out = fe.step_donated(state, frame, t)      # reuses the input
    state, outs = fe.step_scan(state, frames, ts)      # N frames at once
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
filter); its `vo.pose` holds minimizer_v and the forward match. The
spans run where the host runs the step's Python: eagerly, or once at a
graph's capture. The device time of each stage comes from an
`obs.Timeline`: a CUDA event at the step's start, at each stage's end
and at the step's end (the rest between stages is `vo.rest`), which a
CUDA graph holds as event-record nodes, so every replay of `step_scan`
or of a vmapped step times its stages again, frame by frame; they are
read at the next entry call, without a sync. Every entry call is one
`obs.unit`, numbered by the frontend's host-side `frame_id`.

The JAX package has no visual-inertial `step_scan`, and its run_vo
refuses `--chunk` in IMU mode, so no CUDA graph of `step_imu` exists.

Stereo (`StereoAvaiable=1`): every entry point but `step_scan` takes the
cam1 frame as `frame_pair`. `_detect_pair` runs the detector on it with
its own threshold carry and cam1's intrinsics (the fused detector: the
CUDA kernel a second time each frame), and `_tail` adds the stereo
velocity-scale observers, the epipolar stereo match against the cam1
map, the bootstrap re-gauge and the fusion of the pair depth with the
mono EKF, all under the `vo.stereo` span (the pair's detection under
`vo.detect` inside it). A stereo frame given `frame_pair=None` (a dropped
cam1 frame) runs without the pair, as in the JAX package; a `frame_pair`
given to a mono frontend raises ValueError. `step_scan` stays mono, as
the JAX package's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from rebvo_tpu_torch import obs
from rebvo_tpu_torch.config import REBVOParameters
from rebvo_tpu_torch.core.geometry import (CameraModel, rotate_gradients,
                                           rotate_hom_points, so3_exp,
                                           so3_log)
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
from rebvo_tpu_torch.kernels.depth_filter import (depth_ekf,
                                                  estimate_quantile,
                                                  estimate_rescaling_opt,
                                                  regularize_1_iter)
from rebvo_tpu_torch.kernels.edge_detect import (compact_keylines,
                                                 detect_keylines,
                                                 re_estimate_thresh,
                                                 update_detector_threshold)
from rebvo_tpu_torch.kernels.field import build_field
from rebvo_tpu_torch.kernels.matching import (directed_matching,
                                              directed_matching_field,
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


def tree_leaves(tree) -> list:
    """The leaves of a nest of tuples, NamedTuples and lists, in order
    (anything else is a leaf)."""
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn, *trees):
    """fn over the leaves of nests of tuples, NamedTuples and lists of
    one structure."""
    t = trees[0]
    if not isinstance(t, (tuple, list)):
        return fn(*trees)
    subs = [tree_map(fn, *xs) for xs in zip(*trees)]
    return type(t)(*subs) if hasattr(t, "_fields") else type(t)(subs)


def _stack_outputs(outs) -> "FrameOutput":
    """Per-frame outputs stacked on a leading axis, as lax.scan stacks
    them."""
    return tree_map(lambda *xs: torch.stack(xs), *outs)


def _copy_state_(dst, src) -> None:
    """Copy every leaf of `src` into the same leaf of `dst`. A source leaf
    that shares storage with another destination leaf is cloned first,
    so no copy reads a buffer that an earlier copy has overwritten."""
    pairs = [(d, x) for d, x in zip(tree_leaves(dst), tree_leaves(src))
             if d is not x]
    dst_mem = {d.untyped_storage().data_ptr() for d, _ in pairs}
    pairs = [(d, x.clone() if x.untyped_storage().data_ptr() in dst_mem
              else x) for d, x in pairs]
    for d, x in pairs:
        d.copy_(x)


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


class Captured(NamedTuple):
    """A CUDA graph of `capture_graph`."""

    graph: "torch.cuda.CUDAGraph"
    outs: object           # the graph's outputs, rewritten by each replay
    launches: tuple        # (kernel wrapper, its launches per replay)
    stages: tuple          # obs.Timeline of each step captured, in order


def capture_graph(fn, args, pool, warmup) -> Captured:
    """`fn(*args)` captured as one CUDA graph in memory pool `pool`,
    PyTorch's recipe: `warmup()` first runs on a side stream (it creates
    the cuBLAS and cuSOLVER handles and loads the kernels; it must leave
    `args` as they were; its steps record no stage events), then the
    capture, under the span `graph.capture` (counted in
    `graph.captures`). The outputs are the graph's own tensors, rewritten
    by each replay; launches recorded by the capture are taken off the
    kernel wrappers' counts and listed as (wrapper, launches per replay)
    for `replay_graph` to add back; each captured step's stage events are
    nodes of the graph (`obs.Timeline`). Used by `VOFrontend.step_scan`
    and `parallel.mesh.shard_sequences`."""
    from rebvo_tpu_torch.kernels.registry import WRAPPERS
    with obs.span("graph.capture"):
        dev = torch.cuda.current_device()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(main)
        with torch.cuda.stream(side), obs.quiet():
            warmup()
        main.wait_stream(side)
        before = [w.launches for w in WRAPPERS]
        graph = torch.cuda.CUDAGraph()
        with obs.capture() as stages, torch.cuda.graph(graph, pool=pool):
            outs = fn(*args)
        launches = []
        for w, n0 in zip(WRAPPERS, before):
            launches.append((w, w.launches - n0))
            w.launches = n0
    obs.count("graph.captures")
    return Captured(graph, outs, tuple(launches), tuple(stages))


def replay_graph(g: Captured, copy_in):
    """One call of a graph of `capture_graph`, inside the caller's
    `obs.unit`, in three spans: `copy_in()` (the inputs copied into the
    graph's static buffers) under `graph.copy_in`, the replay under
    `graph.replay` (counted in `graph.replays`, with the graph's kernel
    launches), and clones of the outputs, returned, under
    `graph.clone_out`. The captured steps' stage times are read when the
    next unit opens (`obs.replayed`)."""
    with obs.span("graph.copy_in"):
        copy_in()
    with obs.span("graph.replay"):
        g.graph.replay()
        for w, n in g.launches:
            w.launches += n
        obs.count("graph.replays")
    obs.replayed(g.stages)
    with obs.span("graph.clone_out"):
        return tree_map(torch.clone, g.outs)


class _ScanGraph(NamedTuple):
    """One chunk of N steps captured as a CUDA graph (VOFrontend.step_scan)."""

    cap: Captured          # its outputs: the N outputs, stacked
    frames: Tensor         # [N, H, W] static input frames
    ts: Tensor             # [N] static timestamps


class VOFrontend:
    """Binds the static configuration and the device; exposes the mono
    and visual-inertial steps.

        fe = VOFrontend(params)                # device="cuda"
        state = fe.init()
        state = fe.bootstrap(state, frame0, t0)   # detection only
        state, out = fe.step(state, frame, t)     # vision-only
        state, out = fe.step_donated(state, frame, t)
        state, outs = fe.step_scan(state, frames, ts)
        state, out = fe.step_imu(state, frame, t, win)   # visual-inertial
        state, out = fe.step_imu_donated(state, frame, t, win)

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
        # step_scan's CUDA graphs, one per (N, H, W); they all read and
        # write one static state and share one memory pool
        self._scan_graphs: Dict[tuple, _ScanGraph] = {}
        self._scan_state: Optional[VOState] = None
        self._scan_pool = None
        # frame ids of the units this frontend opens (rebvo_tpu_torch.obs)
        self.frame_id = 0

    def init(self) -> VOState:
        return init_state(self.params, device=self.device)

    def _frame(self, frame) -> Tensor:
        return torch.as_tensor(frame).to(
            device=self.device, dtype=torch.float32).contiguous()

    def _window(self, win: ImuWindow) -> ImuWindow:
        return ImuWindow(*[torch.as_tensor(x).to(self.device) for x in win])

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

    def _check_pair(self, frame_pair):
        if frame_pair is not None and not self.stereo:
            raise ValueError("frame_pair given to a mono frontend "
                             "(StereoAvaiable=0)")

    def bootstrap(self, state: VOState, frame, t,
                  frame_pair=None) -> VOState:
        """Process the first frame: detection only (the reference's dummy
        first-frame consume, rebvo_second_t.cpp:108-122); a stereo pair
        frame advances the pair detector's threshold loop."""
        self._check_pair(frame_pair)
        with obs.unit(self):
            return self._bootstrap(state, frame, t, frame_pair)

    def _bootstrap(self, state: VOState, frame, t, frame_pair) -> VOState:
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

    def _front(self, state: VOState, frame: Tensor):
        """Detection + quantile + match field."""
        p = self.params
        cam = self.cam
        with obs.span("vo.detect"):
            new_klm, new_mask, kl_num, thresh, retuned = self._detect(state,
                                                                      frame)
        s_rho_q = estimate_quantile(
            state.klm, percentile=p.QCutOffQuantile, nbins=p.QCutOffNumBins)
        field_img = build_field(
            new_klm, retuned, radius=min(p.FieldRadius, p.SearchRange),
            height=cam.height, width=cam.width)
        fv = FieldView.from_map(field_img, new_klm)
        return (new_klm, new_mask, kl_num, thresh, retuned, s_rho_q, fv,
                field_img)

    def _match(self, state: VOState, new_klm: KeylineMap, V, P_V, R):
        p = self.params
        cam = self.cam
        kw = dict(zfm=cam.zfm, cx=cam.cx, cy=cam.cy, width=cam.width,
                  height=cam.height, min_thr_mod=p.MatchThreshModule,
                  min_thr_ang=p.MatchThreshAngle,
                  max_radius=float(p.SearchRange),
                  loc_uncertainty=p.LocationUncertaintyMatch)
        if p.MatchFieldStride > 0:
            stride = p.MatchFieldStride
            return directed_matching_field(
                new_klm, state.klm, state.field_img, V, P_V, R,
                max_steps=int(p.SearchRange / stride) + 3, stride=stride,
                **kw)
        return directed_matching(new_klm, state.klm, state.mask_img, V, P_V,
                                 R, max_steps=p.MatchMaxSteps, **kw)

    def _solver_vote_mask(self, old: KeylineMap):
        """Stereo: restrict the pose solver's cost vote to the
        pair-anchored keylines whenever at least GlobalMatchThreshold
        exist, else the whole map. None in mono (no restriction)."""
        if not self.stereo:
            return None
        anchored = old.valid & old.anchored
        enough = torch.sum(anchored) >= self.params.GlobalMatchThreshold
        return torch.where(enough, anchored, old.valid)

    def _stereo_front(self, state: VOState, frame_pair):
        """Detect the cam1 frame when one was given: the (klm1, mask1)
        bundle for `_tail` and the pair detector's threshold carry."""
        if frame_pair is None:
            return None, state.thresh_pair, state.last_kl_num_pair
        with obs.span("vo.stereo"), obs.span("vo.detect"):
            klm1, mask1, kl_num_p, thresh_p, _ = self._detect_pair(
                state, self._frame(frame_pair))
        return (klm1, mask1), thresh_p, kl_num_p

    def _tail(self, state: VOState, new_fm: KeylineMap, V, P_V, R,
              nan_fail, stereo=None):
        """Directed matching, depth filtering, and the stereo depth fusion
        (`stereo` = the pair's (klm1, mask1)) or the mono rescaling; the
        caller has merged the forward rotations into state.klm. Returns
        (map, klm_num, est_ok, Kp, Kp_gauge, P_Kp, V_out, stereo_num,
        gauge_div, VScaleC, aR, aV, aAge)."""
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
            boot = state.frame_count <= p.BootstrapRescaleFrames
            mag_prev = torch.linalg.norm(state.Vel)
            V = V * C_vel
            mag_raw = torch.linalg.norm(V)
            leash_ok = (~boot) & (mag_prev > 1e-8) & (mag_raw > 1e-12)
            mag_cl = torch.minimum(torch.maximum(mag_raw, 0.7 * mag_prev),
                                   1.4 * mag_prev)
            V = torch.where(leash_ok,
                            V * (mag_cl / torch.clamp(mag_raw, min=1e-12)), V)

        dres = self._match(state, new_fm, V, P_V, R)
        klm_num = dres.nmatch
        match_fail = klm_num < p.GlobalMatchThreshold
        est_ok = (~nan_fail) & (~match_fail)

        if rescale_on:
            with obs.span("vo.stereo"):
                s_meas, n_sc = velocity_scale_refine(
                    dres.new, state.klm, V, cam.zfm,
                    k_px=float(p.LocationUncertaintyMatch) / 2.0)
                s_meas = torch.where(est_ok & (n_sc >= 100), s_meas, one)
                aV_cur = matmul(R.T, state.aV) + V
                aR_cur = matmul(R.T, state.aR)
                s_long, n_long, _ = anchor_scale_measure(
                    dres.new, aR_cur, aV_cur, cam.zfm)
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

        new_map = dres.new
        if p.SeedRhoMapMedian and stereo is not None:
            # gauge-coherent birth depth: fresh keylines start at the
            # median rho of the mature population (RhoInit while nothing
            # is mature); s_rho stays at RHO_MAX
            mature = new_map.valid & (new_map.m_num > 0)
            seed = torch.clamp(
                masked_median(new_map.rho, mature, fallback=RHO_INIT),
                RHO_MIN, RHO_MAX)
            fresh = new_map.valid & (new_map.m_num == 0)
            new_map = new_map._replace(
                rho=torch.where(fresh, seed, new_map.rho),
                rho0=torch.where(fresh, seed, new_map.rho0))

        proc, _ = regularize_1_iter(new_map, p.RegularizeThresh)
        proc = depth_ekf(proc, V, cam.zfm, reshape_q_abs=p.ReshapeQAbsolute,
                         loc_uncertainty=p.LocationUncertainty)

        if stereo is not None:
            with obs.span("vo.stereo"):
                proc, stereo_num, gauge_div = self._stereo_depth(
                    state, proc, stereo, est_ok, at_epoch)
            Kp_new = one
            P_Kp_new = state.P_Kp
            Kp_gauge = one
        else:
            stereo_num = torch.zeros((), dtype=torch.int32, device=V.device)
            gauge_div = one
            proc, Kp_new, P_Kp_new = estimate_rescaling_opt(proc,
                                                            apply=False)
            do_res = torch.full((), bool(p.DoReScaling), dtype=torch.bool,
                                device=V.device)
            if p.ImuMode > 0 and p.BootstrapRescaleFrames > 0:
                boot = state.frame_count <= p.BootstrapRescaleFrames
                moving = torch.abs(Kp_new - 1.0) > 0.05
                apply_res = do_res | (boot & moving & est_ok)
            else:
                apply_res = do_res
            div = torch.where(apply_res, Kp_new, one)
            proc = proc._replace(rho=proc.rho / div, s_rho=proc.s_rho / div)

        new_final = select_map(est_ok, proc, dres.new)
        Kp = torch.where(est_ok, Kp_new, one)
        if stereo is None:
            # gauge bookkeeping skips frames whose creep the applied
            # rescale already removed from the map
            Kp_gauge = torch.where(apply_res, one, Kp)
        P_Kp = torch.where(nan_fail, torch.full_like(P_Kp_new, BIG),
                           torch.where(match_fail,
                                       torch.full_like(P_Kp_new, 10.0),
                                       P_Kp_new))
        V_out = torch.where(est_ok, V, torch.zeros_like(V))
        # gauge_div: the factor this frame's re-gauge divided the map's
        # inverse depths by; the caller multiplies the warm-start velocity
        # by it
        return (new_final, klm_num, est_ok, Kp, Kp_gauge, P_Kp, V_out,
                stereo_num, gauge_div, C_vel, aR_new, aV_new, aAge_new)

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
    # Vision-only path (rebvo_second_t.cpp:338-382 + common tail)
    # ------------------------------------------------------------------

    def step(self, state: VOState, frame, t,
             frame_pair=None) -> Tuple[VOState, FrameOutput]:
        """One frame (`frame_pair`: the cam1 frame, stereo only). Pure:
        the input state is left as it was."""
        self._check_pair(frame_pair)
        with obs.unit(self):
            return self._step(state, frame, t, frame_pair, donate=False)

    def step_donated(self, state: VOState, frame, t,
                     frame_pair=None) -> Tuple[VOState, FrameOutput]:
        """`step` that may reuse the input state's buffers (it appends the
        nav-log row in place), the counterpart of the JAX package's
        donated step: the caller must not touch the old state."""
        self._check_pair(frame_pair)
        with obs.unit(self):
            return self._step(state, frame, t, frame_pair, donate=True)

    def _step(self, state: VOState, frame, t, frame_pair,
              donate: bool) -> Tuple[VOState, FrameOutput]:
        p = self.params
        cam = self.cam
        dt_f = state.Vel.dtype
        dev = state.Vel.device
        tl = obs.Timeline(dev)
        frame = self._frame(frame)
        t = self._time(t, state.t)
        dt_frame = t - state.t
        dt_frame = torch.where(dt_frame < 0.001,
                               torch.full_like(dt_frame, 1.0 / p.config_fps),
                               dt_frame)

        with obs.span("vo.front"):
            (new_klm, new_mask, kl_num, thresh, retuned, s_rho_q, fv,
             field_img) = self._front(state, frame)
        tl.mark("vo.front")
        stereo, thresh_pair, kl_num_pair = self._stereo_front(state,
                                                              frame_pair)
        if stereo is not None:
            tl.mark("vo.stereo")
        old = state.klm

        with obs.span("vo.pose"):
            match_num_min = torch.clamp(state.frame_count,
                                        max=p.MatchNumThresh)
            mres = minimizer_rv(
                state.Vel, state.W0, old, fv, zfm=cam.zfm, cx=cam.cx,
                cy=cam.cy, width=cam.width, height=cam.height,
                match_thresh=p.TrackerMatchThresh, max_s_rho=s_rho_q,
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
            new_fm, _ = forward_match(old, new_klm, mres.m_id_f)
            R0 = so3_exp(W)
            R = R0.T
            state2 = state._replace(klm=self._rotate_map(old, R0))
            (new_final, klm_num, est_ok, Kp, Kp_gauge, P_Kp, V_out,
             stereo_num, gauge_div, C_vel, aR_new, aV_new,
             aAge_new) = self._tail(state2, new_fm, V, P_V, R, nan_fail,
                                    stereo)
        tl.mark("vo.match_depth")

        K_scale = state.K_scale
        Pose = matmul(state.Pose, R)
        # gauge-consistent export (mono): multiply exported displacements
        # by the cumulative rescaling ratio (see the JAX package)
        if p.GaugeExport:
            G_gauge = torch.clamp(state.G_gauge * Kp_gauge, 1e-4, 1e4)
        else:
            G_gauge = state.G_gauge
        Pos = state.Pos - matmul(Pose, V_out * K_scale * G_gauge)
        tl.mark()

        with obs.span("vo.keyframe"):
            (kf_carry, new_final, Pose, Pos, kf_id, kf_back_m,
             kf_saved) = self._kf_track(state, new_final, fv, Pose, Pos,
                                        K_scale, kl_num, s_rho_q, est_ok,
                                        G_gauge)
        tl.mark("vo.keyframe")

        nav = NavData(
            t=t, dt=dt_frame, Rot=R, RotLie=so3_log(R),
            Vel=-V_out * K_scale * G_gauge / dt_frame,
            Pose=Pose, PoseLie=so3_log(Pose), Pos=Pos,
            g=torch.zeros(3, dtype=dt_f, device=dev), scale=K_scale,
            estimation_ok=est_ok, kl_num=kl_num, klm_num=klm_num)
        W_X_out = torch.where(nan_fail,
                              torch.eye(6, dtype=dt_f, device=dev) * 1e-12,
                              mres.W_X)
        out = FrameOutput(
            nav=nav, s_rho_q=s_rho_q, score=mres.score,
            rel_error=mres.rel_error, stereo_num=stereo_num,
            kf_id=kf_id, kf_back_m=kf_back_m, kf_saved=kf_saved,
            W_X=W_X_out, Kp=Kp, RKp=P_Kp,
            imu_dbg=torch.zeros((len(IMU_DBG_ROWS), 3), dtype=dt_f,
                                device=dev))
        navlog, navlog_n = self._log_nav(state, out, donate)
        new_state = VOState(
            klm=new_final, mask_img=new_mask, field_img=field_img,
            thresh=thresh, retuned=retuned, last_kl_num=kl_num,
            thresh_pair=thresh_pair, last_kl_num_pair=kl_num_pair,
            Vel=V_out * gauge_div, W0=W, Kp=Kp, P_Kp=P_Kp, K_scale=K_scale,
            Pose=Pose, Pos=Pos, t=t, frame_count=state.frame_count + 1,
            imu=state.imu, kf=kf_carry, navlog=navlog, navlog_n=navlog_n,
            G_gauge=G_gauge, VScaleC=C_vel, aR=aR_new, aV=aV_new,
            aAge=aAge_new)
        tl.close()
        return new_state, out

    # ------------------------------------------------------------------
    # Visual-inertial path (rebvo_second_t.cpp:182-335, 528-546)
    # ------------------------------------------------------------------

    def step_imu(self, state: VOState, frame, t, win: ImuWindow,
                 R_cam2imu: Tensor = None, T_cam2imu: Tensor = None,
                 frame_pair=None) -> Tuple[VOState, FrameOutput]:
        """One visual-inertial frame: `win` holds the IMU samples since
        the previous frame, in the IMU frame (R_cam2imu / T_cam2imu: the
        camera-to-IMU extrinsics, default identity). Pure: the input
        state is left as it was. `frame_pair`: the cam1 frame, stereo
        only."""
        self._check_pair(frame_pair)
        with obs.unit(self):
            return self._step_imu(state, frame, t, win, R_cam2imu,
                                  T_cam2imu, frame_pair, donate=False)

    def step_imu_donated(self, state: VOState, frame, t, win: ImuWindow,
                         R_cam2imu: Tensor = None, T_cam2imu: Tensor = None,
                         frame_pair=None) -> Tuple[VOState, FrameOutput]:
        """`step_imu` that appends the nav-log row into the input state's
        ring in place (the JAX package's donated step_imu): the caller
        must not touch the old state."""
        self._check_pair(frame_pair)
        with obs.unit(self):
            return self._step_imu(state, frame, t, win, R_cam2imu,
                                  T_cam2imu, frame_pair, donate=True)

    def _step_imu(self, state: VOState, frame, t, win: ImuWindow, R_cam2imu,
                  T_cam2imu, frame_pair,
                  donate: bool) -> Tuple[VOState, FrameOutput]:
        p = self.params
        cam = self.cam
        dt_f = state.Vel.dtype
        dev = state.Vel.device
        kw = dict(dtype=dt_f, device=dev)
        tl = obs.Timeline(dev)
        frame = self._frame(frame)
        win = self._window(win)
        t = self._time(t, state.t)
        dt_frame = t - state.t
        dt_frame = torch.where(dt_frame < 0.001,
                               torch.full_like(dt_frame, 1.0 / p.config_fps),
                               dt_frame)
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

        with obs.span("vo.front"):
            (new_klm, new_mask, kl_num, thresh, retuned, s_rho_q, fv,
             field_img) = self._front(state._replace(klm=old_pre), frame)
        tl.mark("vo.front")
        stereo, thresh_pair, kl_num_pair = self._stereo_front(state,
                                                              frame_pair)
        if stereo is not None:
            tl.mark("vo.stereo")

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
                Vg0, old_pre, fv, zfm=cam.zfm, cx=cam.cx, cy=cam.cy,
                width=cam.width, height=cam.height,
                match_thresh=p.TrackerMatchThresh, max_s_rho=s_rho_q,
                match_num_min=match_num_min, k_huber=p.ReweigthDistance,
                min_mod=state.retuned, iter_max=p.TrackerIterNum,
                vote_mask=self._solver_vote_mask(old_pre))
            Vg = vres.Vel
            new_fm, _ = forward_match(old_pre, new_klm, vres.m_id_f)
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
            # --- Second forward rotation of the old map.
            state2 = state._replace(klm=self._rotate_map(old_pre, R0))
            nan_fail = torch.any(~torch.isfinite(V)) | (~ok_x)
            V = torch.where(nan_fail, z3, V)
            P_V = torch.where(nan_fail, eye3 * BIG, P_V)
            (new_final, klm_num, est_ok, Kp, Kp_gauge, P_Kp, V_out,
             stereo_num, gauge_div, C_vel, aR_new, aV_new,
             aAge_new) = self._tail(state2, new_fm, V, P_V, R, nan_fail,
                                    stereo)
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
        tl.mark()

        with obs.span("vo.keyframe"):
            (kf_carry, new_final, Pose, Pos, kf_id, kf_back_m,
             kf_saved) = self._kf_track(state, new_final, fv, Pose, Pos,
                                        K_scale, kl_num, s_rho_q, est_ok,
                                        state.G_gauge)
        tl.mark("vo.keyframe")

        nav = NavData(
            t=t, dt=dt_frame, Rot=R, RotLie=so3_log(R),
            Vel=-V_out * K_scale / dt_frame,
            Pose=Pose, PoseLie=so3_log(Pose), Pos=Pos,
            g=g_est, scale=K_scale,
            estimation_ok=est_ok, kl_num=kl_num, klm_num=klm_num)

        imu_carry = ImuCarry(
            init=init, n_init=n_init, giro_init=giro_init, g_init=g_init,
            Bg=Bg, W_Bg=W_Bg, Vg=Vg * gauge_div, X7=X7, P7=P7, u_est=u_est,
            g_est=g_est, b_est=b_est, windows=win2, Posgv=Posgv)

        W_X_out = torch.where(nan_fail, torch.eye(6, **kw) * 1e-12, W_Xgv)
        # VI filter internals for the .m log (IMU_DBG_ROWS order;
        # rebvo_third_t.cpp:283-299 census)
        imu_dbg = torch.stack([imu.giro, imu.acel, imu.cacel, imu.dgiro,
                               Bg, Xv[3:], dWgv, b_est, Av, As, Posgv])
        out = FrameOutput(
            nav=nav, s_rho_q=s_rho_q, score=vres.score,
            rel_error=torch.zeros((), **kw), stereo_num=stereo_num,
            kf_id=kf_id, kf_back_m=kf_back_m, kf_saved=kf_saved,
            W_X=W_X_out, Kp=Kp, RKp=P_Kp, imu_dbg=imu_dbg.to(dt_f))
        navlog, navlog_n = self._log_nav(state, out, donate)
        new_state = VOState(
            klm=new_final, mask_img=new_mask, field_img=field_img,
            thresh=thresh, retuned=retuned, last_kl_num=kl_num,
            thresh_pair=thresh_pair, last_kl_num_pair=kl_num_pair,
            Vel=V_out * gauge_div, W0=dWgv, Kp=Kp, P_Kp=P_Kp,
            K_scale=K_scale, Pose=Pose, Pos=Pos, t=t,
            frame_count=state.frame_count + 1, imu=imu_carry, kf=kf_carry,
            navlog=navlog, navlog_n=navlog_n,
            G_gauge=state.G_gauge,   # VI: metric scale K owns the gauge
            VScaleC=C_vel, aR=aR_new, aV=aV_new, aAge=aAge_new)
        tl.close()
        return new_state, out

    # ------------------------------------------------------------------
    # Chunked step (the counterpart of the JAX package's lax.scan)
    # ------------------------------------------------------------------

    def step_scan(self, state: VOState, frames,
                  ts) -> Tuple[VOState, FrameOutput]:
        """Advance over a chunk of frames ([N, H, W], timestamps [N]);
        returns the final state and the N per-frame outputs stacked on a
        leading axis, as lax.scan stacks them. Donates its input state
        like `step_donated`.

        On a CUDA state the N steps are one CUDA graph, captured at the
        first call for each (N, H, W) and replayed by every later call.
        The frames and timestamps are copied into the graph's static
        buffers, and a state other than the one the last call returned
        into its static state. The state returned IS that static state,
        so chained calls copy no state, and the next call overwrites it;
        the outputs returned are copies. A capture that fails raises: a
        CUDA state never runs the steps eagerly here. On a CPU state the
        same N steps run in a Python loop. The call is one `obs.unit` of
        N frames."""
        with obs.unit(self, len(frames)):
            return self._step_scan(state, frames, ts)

    def _step_scan(self, state: VOState, frames, ts):
        frames = self._frame(frames)
        ts = torch.as_tensor(ts, dtype=state.t.dtype).to(state.t.device)
        if frames.ndim != 3 or tuple(ts.shape) != tuple(frames.shape[:1]):
            raise ValueError(f"step_scan: frames must be [N, H, W] and ts "
                             f"[N], got {tuple(frames.shape)} and "
                             f"{tuple(ts.shape)}")
        if state.t.device.type == "cpu":
            outs = []
            for i in range(frames.shape[0]):
                state, out = self.step_donated(state, frames[i], ts[i])
                outs.append(out)
            return state, _stack_outputs(outs)
        if state.t.device.type != "cuda":
            raise ValueError(f"step_scan: unsupported device "
                             f"{state.t.device}")
        g = self._scan_graphs.get(tuple(frames.shape))
        if g is None:
            g = self._capture_scan(state, frames, ts)

        def copy_in():
            g.frames.copy_(frames)
            g.ts.copy_(ts)
            if state is not self._scan_state:
                _copy_state_(self._scan_state, state)

        return self._scan_state, replay_graph(g.cap, copy_in)

    def _capture_scan(self, state: VOState, frames: Tensor,
                      ts: Tensor) -> _ScanGraph:
        """Capture len(frames) donated steps from the static state as one
        CUDA graph (`capture_graph`): the warm-up runs two steps on a
        clone of `state`, so the caller's state does not advance; the
        capture ends by copying the final state into the static one."""
        if self._scan_state is None:
            self._scan_state = tree_map(torch.clone, state)
            self._scan_pool = torch.cuda.graph_pool_handle()
        static = self._scan_state
        frames_s, ts_s = frames.clone(), ts.clone()

        def warmup():
            st = tree_map(torch.clone, state)
            for i in range(min(2, frames.shape[0])):
                st, _ = self.step_donated(st, frames_s[i], ts_s[i])

        def steps():
            st, outs = static, []
            for i in range(frames.shape[0]):
                st, out = self.step_donated(st, frames_s[i], ts_s[i])
                outs.append(out)
            outs = _stack_outputs(outs)     # before the copy: an output
            _copy_state_(static, st)        # may be a static state leaf
            return outs

        with torch.cuda.device(frames.device):
            cap = capture_graph(steps, (), self._scan_pool, warmup)
        g = _ScanGraph(cap, frames_s, ts_s)
        self._scan_graphs[tuple(frames.shape)] = g
        return g

    # ------------------------------------------------------------------

    def _log_nav(self, state: VOState, out: FrameOutput, donate: bool):
        """Append the packed nav row to the device ring: in place when the
        input state is donated, else into a copy of the ring. The in-place
        append is `index_put_`, which vmap batches (it has no rule for
        `index_copy_`)."""
        if self.params.NavLogCap <= 0:
            return state.navlog, state.navlog_n
        cap = state.navlog.shape[0]
        row = pack_nav_row(out)
        idx = (state.navlog_n % cap).to(torch.int64).reshape(1)
        if donate:
            navlog = state.navlog.index_put_((idx,), row[None])
        else:
            navlog = state.navlog.index_copy(0, idx, row[None])
        return navlog, state.navlog_n + 1

    def _kf_track(self, state: VOState, klm: KeylineMap, fv, Pose, Pos,
                  K_scale, kl_num, s_rho_q, est_ok, G_gauge):
        """Online keyframe tracking (TrackKeyFrames, statically gated)."""
        dev = Pose.device
        if not self.params.TrackKeyFrames:
            return (state.kf, klm, Pose, Pos,
                    torch.full((), -1, dtype=torch.int32, device=dev),
                    torch.zeros((), dtype=torch.int32, device=dev),
                    torch.zeros((), dtype=torch.bool, device=dev))
        res = track_keyframe(
            state.kf, klm, fv, Pose, Pos, K_scale, kl_num, s_rho_q, est_ok,
            G_gauge, cam=self.cam, params=self.params)
        return (res.kf, res.klm, res.Pose, res.Pos, res.kf.count - 1,
                res.back_m, res.saved)

    def _rotate_map(self, klm: KeylineMap, R0: Tensor) -> KeylineMap:
        """Forward-rotate an edge map (edge_tracker::rotate_keylines)."""
        px, py, rho, s_rho = rotate_hom_points(
            R0, klm.px, klm.py, klm.rho, klm.s_rho, self.cam.zfm)
        gx, gy = rotate_gradients(R0, klm.gx, klm.gy)
        return klm._replace(px=px, py=py, rho=rho, s_rho=s_rho,
                            gx=gx, gy=gy)
