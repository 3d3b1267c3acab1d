"""Parity harness (PyTorch port of rebvo_tpu/apps/parity.py): renders the
parity scenes, runs this package's run_vo on them, and reports ATE
against the rendered ground truth.

  1. renders synthetic sequences (multi-depth billboard scenes with real
     occlusions, `io/render`) and writes them as a DataSetCam-format
     dataset (8-bit PNG frames written by `io/png` + a
     `timestamp_ns,filename` list; the reference's deterministic replay
     path, src/VideoLib/datasetcam.cpp:172-191), from the JAX package's
     seeds, so both packages render the same pixels;
  2. writes one GlobalConfig (every mandatory key of the reference's
     src/rebvo/rebvo.cpp:53-221), read by both the reference binary and
     run_vo;
  3. runs the reference binary when one is given (`REBVO_REF_BINARY`,
     default `rebvorun` on the PATH; its stdin is fed a keystroke
     trickle so its interactive loop, app/rebvorun/main.cpp:92-125,
     re-checks Running() and exits at the dataset's end) and reads its
     TUM `rebvo_tray.txt`; `--skip-ref` skips it;
  4. runs `rebvo_tpu_torch.apps.run_vo` on the same frames and config,
     on the CUDA device (`--cpu` for the CPU), in a subprocess;
  5. reports ATE(port vs GT), and with a reference run ATE(ref vs GT) and
     ATE(port vs ref), per sequence, Umeyama Sim(3)-aligned since
     monocular VO has a gauge freedom; visual-inertial and stereo rows
     add the alignment scale and the scale-fixed SE(3) ATE. `--ba-every N`
     also captures a keyframe every N frames and reports the keyframes'
     ATE before and after offline BA (`run_ba`).

Kinds: `lateral_arc`, `dolly`, `loop`, `loop3` (three revisit cycles,
for long runs: `loop3:1600` sets its frame count); suffixes `_vi`
(time-warped, dithered path plus a consistent 200 Hz EuRoC IMU CSV),
`_dist` (radial distortion, UseUndistort=1), `_st` (a cam1 stream at the
EuRoC extrinsics, StereoAvaiable=1) and `_b0` (a control row on its base
kind's dataset with BootstrapRescaleFrames=0).

Usage:
    python -m rebvo_tpu_torch.apps.parity --skip-ref \\
        --seqs lateral_arc,dolly,loop,loop3:1600 --json parity.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

REF_BINARY = os.environ.get("REBVO_REF_BINARY", "rebvorun")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# camera of every parity scene (distortion-free unless `_dist`, so
# UseUndistort=0 on both sides and the PNG pixels are the whole story)
W, H, ZF, CX, CY = 752, 480, 400.0, 376.0, 240.0
FPS = 20.0


def _traj_eval(kind: str, u: np.ndarray):
    """Smooth camera paths with parallax and gentle rotation at path
    parameter u in [0, 1]; returns (pos [n,3], yaw [n], pitch [n])."""
    u = np.asarray(u, np.float64)
    pos = np.zeros(u.shape + (3,))
    yaw = np.zeros(u.shape)
    pitch = np.zeros(u.shape)
    if kind == "lateral_arc":
        pos[..., 0] = 0.45 * np.sin(np.pi * u)
        pos[..., 1] = 0.12 * np.sin(2 * np.pi * u)
        pos[..., 2] = 0.25 * u
        yaw = 0.10 * np.sin(np.pi * u)
    elif kind == "dolly":
        pos[..., 2] = 0.9 * u
        pos[..., 0] = 0.15 * np.sin(2 * np.pi * u)
        pitch = 0.05 * np.sin(2 * np.pi * u)
    elif kind == "loop":
        pos[..., 0] = 0.35 * np.sin(2 * np.pi * u)
        pos[..., 1] = 0.18 * (1 - np.cos(2 * np.pi * u))
        pos[..., 2] = 0.30 * np.sin(np.pi * u)
        yaw = 0.08 * np.sin(2 * np.pi * u)
    elif kind == "loop3":
        # three revisit cycles of the loop under a slow depth envelope:
        # drift, keyframe and nav-log rings, and the scale machinery over
        # a long run
        pos[..., 0] = 0.35 * np.sin(2 * np.pi * 3 * u)
        pos[..., 1] = 0.18 * (1 - np.cos(2 * np.pi * 3 * u))
        pos[..., 2] = 0.30 * np.sin(np.pi * u)
        yaw = 0.08 * np.sin(2 * np.pi * 3 * u)
    else:
        raise ValueError(kind)
    return pos, yaw, pitch


def _build_rots(yaw: np.ndarray, pitch: np.ndarray) -> np.ndarray:
    """World-from-camera rotations Ry(yaw) @ Rx(pitch)."""
    n = len(yaw)
    rot = np.empty((n, 3, 3))
    for i in range(n):
        cy_, sy = np.cos(yaw[i]), np.sin(yaw[i])
        cp, sp = np.cos(pitch[i]), np.sin(pitch[i])
        Ry = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        rot[i] = Ry @ Rx
    return rot


def _traj(kind: str, n: int):
    """Per-frame camera path: (positions [n,3], rotations [n,3,3]
    world-from-camera)."""
    pos, yaw, pitch = _traj_eval(kind, np.linspace(0.0, 1.0, n))
    return pos, _build_rots(yaw, pitch)


# ---------------------------------------------------------------------------
# Visual-inertial sequences: the same scenes and paths with a consistent
# IMU, a EuRoC-format CSV (ImuMode=2, imugrabber.cpp:80: t,gx,gy,gz,ax,ay,az)
# ---------------------------------------------------------------------------

VI_HOLD = 0.12      # share of the duration held still at the start: both
                    # systems average the early gyro as the initial bias
                    # (InitBias/InitBiasFrameNum, rebvo_second_t.cpp:184-201)
VI_T0 = 1.0         # cam+IMU time offset (s): the reference's first-frame
                    # IMU window is (0, t_frame0] (rebvo_first_t.cpp:89,
                    # 294-303); a zero first time stamp would leave it empty
IMU_HZ = 200.0
G_W = np.asarray([0.0, 9.8, 0.0])     # gravity "down" = +y (image down)


def _vi_pose_at(base_kind: str, t_sec: np.ndarray, T_end: float):
    """Camera pose at any time for the VI variants: the base path
    time-warped by a C1 smoothstep (zero velocity at both ends, a still
    hold for the bias init) plus a small position and yaw dither that
    gives the accelerometer the excitation monocular scale needs."""
    t_sec = np.asarray(t_sec, np.float64)
    tau = np.clip(t_sec / T_end, 0.0, 1.0)
    s = np.clip((tau - VI_HOLD) / (1.0 - VI_HOLD), 0.0, 1.0)
    u = s * s * (3.0 - 2.0 * s)
    pos, yaw, pitch = _traj_eval(base_kind, u)
    # the position dither runs from t=0 (a short ramp-in): it leaves the
    # gyro still for the bias init and excites the visual-acceleration
    # windows before the scale filter starts
    tp = np.maximum(t_sec, 0.0)
    act = np.clip(tp / 0.4, 0.0, 1.0)
    act = act * act * (3.0 - 2.0 * act)
    pos[..., 0] += 0.05 * np.sin(2 * np.pi * 1.3 * tp) * act
    pos[..., 1] += 0.035 * np.sin(2 * np.pi * 0.9 * tp + 1.0) * act
    # the yaw dither only after the bias-init hold (it excites the gyro)
    ta = np.maximum(t_sec - VI_HOLD * T_end, 0.0)
    acty = np.clip(ta / 1.0, 0.0, 1.0)
    acty = acty * acty * (3.0 - 2.0 * acty)
    yaw = yaw + 0.012 * np.sin(2 * np.pi * 1.1 * ta) * acty
    return pos, yaw, pitch


def _so3_log_np(R: np.ndarray) -> np.ndarray:
    """Rotation log (numpy, float64): axis * angle of a 3x3 rotation."""
    w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]])
    c = np.clip(0.5 * (np.trace(R) - 1.0), -1.0, 1.0)
    s = np.linalg.norm(w)
    if s < 1e-12:
        return w
    return w * (np.arccos(c) / s)


def _write_imu_csv(seq_dir: str, base_kind: str, n_frames: int) -> str:
    """EuRoC-format IMU CSV consistent with the rendered path: body rates
    from the rotation's derivative, specific force f_b = R_wc^T (a_w - g_w)
    from the position's second derivative (ns time stamps)."""
    T_end = (n_frames - 1) / FPS
    dt_fd = 1e-3
    n_samp = int(np.ceil((VI_T0 + T_end + 0.1) * IMU_HZ))
    tk = np.arange(1, n_samp + 1) / IMU_HZ        # offset clock t'
    t_sec = tk - VI_T0                            # trajectory clock

    def pose(ts):
        pos, yaw, pitch = _vi_pose_at(base_kind, ts, T_end)
        return pos, _build_rots(yaw, pitch)

    p_m, R_m = pose(t_sec - dt_fd)
    p_0, R_0 = pose(t_sec)
    p_p, R_p = pose(t_sec + dt_fd)
    a_w = (p_p - 2.0 * p_0 + p_m) / (dt_fd * dt_fd)
    lines = []
    for i in range(n_samp):
        w_b = _so3_log_np(R_m[i].T @ R_p[i]) / (2.0 * dt_fd)
        f_b = R_0[i].T @ (a_w[i] - G_W)
        t_ns = int(round(tk[i] * 1e9))
        lines.append(f"{t_ns},{w_b[0]:.9f},{w_b[1]:.9f},{w_b[2]:.9f},"
                     f"{f_b[0]:.9f},{f_b[1]:.9f},{f_b[2]:.9f}")
    path = os.path.join(seq_dir, "imu.csv")
    with open(path, "w") as fh:
        fh.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n" +
                 "\n".join(lines) + "\n")
    return path


# ---------------------------------------------------------------------------
# Distorted-camera variant: kinds ending in `_dist` warp the pinhole
# rendering through a radial model and set UseUndistort=1. Radial only
# (p1=p2=0): the reference's undistortHom2Hom Newton iteration ignores the
# tangential terms (cam_model.h:57-73), so both systems invert it exactly.
# ---------------------------------------------------------------------------

DIST_KC2 = -0.22      # EuRoC-like barrel distortion (normalised units)
DIST_KC4 = 0.06


def _undistort_radial_np(hx, hy, kc2, kc4, zf, iters=12):
    """Distorted hom -> ideal hom, Newton on the radial polynomial
    (float64; cam_model.h:57-73 with fx=fy=zfm)."""
    rd = np.sqrt(hx * hx + hy * hy) / zf
    rn = rd.copy()
    for _ in range(iters):
        f = rn * (1.0 + rn * rn * (kc2 + kc4 * rn * rn)) - rd
        df = 1.0 + rn * rn * (3.0 * kc2 + 5.0 * kc4 * rn * rn)
        rn = rn - f / df
    scale = np.where(rd > 1e-12, rn / np.maximum(rd, 1e-12), 1.0)
    return hx * scale, hy * scale


def _distort_frames(frames_big, margin):
    """Resample an oversized pinhole rendering into the distorted camera's
    pixel grid, D(x_d) = I(undistort(x_d)); frames_big is [n, H+2m, W+2m]
    rendered with principal point (CX+m, CY+m)."""
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    ux, uy = _undistort_radial_np(xs - CX, ys - CY, DIST_KC2, DIST_KC4, ZF)
    sx = np.clip(ux + CX + margin, 0, frames_big.shape[2] - 1.001)
    sy = np.clip(uy + CY + margin, 0, frames_big.shape[1] - 1.001)
    x0 = sx.astype(np.int64)
    y0 = sy.astype(np.int64)
    fx_, fy_ = sx - x0, sy - y0
    out = np.empty((frames_big.shape[0], H, W), np.float64)
    for i, I in enumerate(frames_big):
        out[i] = (I[y0, x0] * (1 - fx_) * (1 - fy_)
                  + I[y0, x0 + 1] * fx_ * (1 - fy_)
                  + I[y0 + 1, x0] * (1 - fx_) * fy_
                  + I[y0 + 1, x0 + 1] * fx_ * fy_)
    return out


# ---------------------------------------------------------------------------
# Stereo variant: kinds ending in `_st` also render a cam1 stream at the
# EuRoC cam0->cam1 extrinsics the reference hard-codes in its stereo path
# (rebvo_second_t.cpp:467-470; the &Stereo config keys default to them),
# and run StereoAvaiable=1. The 0.11 m baseline pins the gauge.
# ---------------------------------------------------------------------------

ST_R = np.array([[0.999997256477450, 0.002312067192420, 0.000376008102351],
                 [-0.002317135723285, 0.999898048506528, 0.014089835846697],
                 [-0.000343393120589, -0.014090668452670, 0.999900662638179]])
ST_T = np.array([-0.110073808127139, 0.000399121547014, -0.000853702503351])


def _pair_poses(pos: np.ndarray, rot: np.ndarray):
    """World pose of cam1 from cam0's centres and rotations
    (world-from-cam): p_c1 = ST_R p_c0 + ST_T, so R_wc1 = R_wc0 ST_R^T and
    C1 = C0 - R_wc1 ST_T."""
    rot1 = rot @ ST_R.T
    pos1 = pos - np.einsum("nij,j->ni", rot1, ST_T)
    return pos1, rot1


def _parse_kind(kind: str):
    """(base path kind, vi, dist, st) of a kind without `_b0`."""
    st = kind.endswith("_st")
    base = kind[:-3] if st else kind
    dist = base.endswith("_dist")
    base = base[:-5] if dist else base
    vi = base.endswith("_vi")
    return (base[:-3] if vi else base), vi, dist, st


def render_dataset(seq_dir: str, kind: str, n_frames: int, seed: int):
    """Render and write one DataSetCam dataset; returns the GT positions.
    A `_vi` kind renders the time-warped, dithered variant of its base
    path and writes the consistent EuRoC IMU CSV. Frames are rendered one
    by one (each is a pure function of its pose and the seed), on up to 8
    threads (numpy and zlib release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from rebvo_tpu_torch.io.png import write_png
    from rebvo_tpu_torch.io.render import render_billboards_seq

    data_dir = os.path.join(seq_dir, "data")
    os.makedirs(data_dir, exist_ok=True)
    base, vi, dist, st = _parse_kind(kind)
    if vi:
        t_frames = np.arange(n_frames) / FPS
        pos, yaw, pitch = _vi_pose_at(base, t_frames, (n_frames - 1) / FPS)
        rot = _build_rots(yaw, pitch)
        _write_imu_csv(seq_dir, base, n_frames)
        t_offset = VI_T0
    else:
        pos, rot = _traj(base, n_frames)
        t_offset = 0.0
    streams = [(data_dir, pos, rot)]
    if st:
        pair_dir = os.path.join(seq_dir, "data_stereo")
        os.makedirs(pair_dir, exist_ok=True)
        streams.append((pair_dir,) + _pair_poses(pos, rot))

    def frame(job):
        out_dir, c, r = streams[job[0]]
        i = job[1]
        if dist and job[0] == 0:
            m = 128
            big = render_billboards_seq(
                1, width=W + 2 * m, height=H + 2 * m, zf=ZF, cx=CX + m,
                cy=CY + m, seed=seed, cam_positions=c[i:i + 1],
                cam_rotations=r[i:i + 1])
            img = _distort_frames(np.asarray(big), m)[0]
        else:
            img = render_billboards_seq(
                1, width=W, height=H, zf=ZF, cx=CX, cy=CY, seed=seed,
                cam_positions=c[i:i + 1], cam_rotations=r[i:i + 1])[0]
        # 8-bit grey PNG; both sides read it back as r+g+b = 3*v
        g = np.clip(img / 3.0, 0, 255).astype(np.uint8)
        write_png(os.path.join(out_dir, f"{i:06d}.png"), g)

    threads = min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(frame, [(s, i) for s in range(len(streams))
                              for i in range(n_frames)]))
    lines = [f"{int(round((t_offset + i / FPS) * 1e9))},{i:06d}.png"
             for i in range(n_frames)]
    csvs = ["data.csv", "data_stereo.csv"][:len(streams)]
    for name in csvs:
        with open(os.path.join(seq_dir, name), "w") as fh:
            fh.write("#timestamp [ns],filename\n" + "\n".join(lines) + "\n")
    np.savetxt(os.path.join(seq_dir, "gt_pos.txt"), pos)
    # the render's provenance, so --reuse reports the seed the dataset
    # was rendered with
    with open(os.path.join(seq_dir, "meta.json"), "w") as fh:
        json.dump({"kind": kind, "n_frames": n_frames, "seed": seed}, fh)
    return pos


def parity_params(seq_dir: str, vi: bool = False, dist: bool = False,
                  st: bool = False):
    from rebvo_tpu_torch.config import REBVOParameters
    p = REBVOParameters().replace(
        ZfX=ZF, ZfY=ZF, PPx=CX, PPy=CY,
        KcR2=DIST_KC2 if dist else 0.0, KcR4=DIST_KC4 if dist else 0.0,
        KcR6=0.0, KcP1=0.0, KcP2=0.0,
        ImageWidth=W, ImageHeight=H, config_fps=FPS, soft_fps=FPS,
        useUndistort=1 if dist else 0, rotatedCam=0,
        CameraType=2, VideoNetEnabled=0, VideoSave=0, SaveLog=1,
        EncoderType=1, TrackKeyFrames=0,
        DataSetDir=os.path.join(seq_dir, "data") + "/",
        DataSetFile=os.path.join(seq_dir, "data.csv"),
        CamTimeScale=1e-9,
        ImuMode=0, ImuTimeScale=1.0,   # the trajectory's t stays in s
        StereoAvaiable=0,
        cpuSetAffinity=0,              # a failed affinity call aborts the
                                       # reference
    )
    if st:
        # the pair camera shares the parity intrinsics; the extrinsics stay
        # at the config defaults, the values the reference hard-codes
        p = p.replace(
            StereoAvaiable=1,
            StereoZfX=ZF, StereoZfY=ZF, StereoPPx=CX, StereoPPy=CY,
            StereoKcR2=0.0, StereoKcR4=0.0, StereoKcR6=0.0,
            StereoKcP1=0.0, StereoKcP2=0.0,
            DataSetDirStereo=os.path.join(seq_dir, "data_stereo") + "/",
            DataSetFileStereo=os.path.join(seq_dir, "data_stereo.csv"),
        )
    if vi:
        p = p.replace(
            ImuMode=2,
            ImuFile=os.path.join(seq_dir, "imu.csv"),
            ImuTimeScale=1e-9,
            SampleTime=1.0 / IMU_HZ,   # sizes run_vo's IMU windows; the
                                       # reference estimates it from data
            CamImuSE3File="",          # identity cam-IMU mounting
            TimeDesinc=0.0,
        )
    return p


def write_parity_config(seq_dir: str, vi: bool = False,
                        dist: bool = False, st: bool = False) -> str:
    """Write the GlobalConfig both sides read; returns its path (a pure
    function of seq_dir)."""
    from rebvo_tpu_torch.config import save_config
    cfg = os.path.join(seq_dir, "GlobalConfig_parity")
    save_config(parity_params(seq_dir, vi=vi, dist=dist, st=st), cfg)
    return cfg


def run_reference(seq_dir: str, timeout: float = 600.0, vi: bool = False,
                  dist: bool = False, st: bool = False):
    """Run the reference binary on the dataset; returns (positions,
    wall seconds) or (None, a message) on failure."""
    cfg = write_parity_config(seq_dir, vi=vi, dist=dist, st=st)
    env = dict(os.environ)
    # the reference links libv4l2, never called under DataSetCam: the
    # repo's stub (make -C native) stands in for it
    env["LD_LIBRARY_PATH"] = (os.path.join(REPO_ROOT, "native") +
                              ":" + env.get("LD_LIBRARY_PATH", ""))
    t0 = time.perf_counter()
    try:
        proc = subprocess.Popen(
            [REF_BINARY, cfg], cwd=seq_dir, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE)
    except OSError as e:
        return None, f"reference binary {REF_BINARY!r} not run: {e}"

    def feeder():
        # the reference's main loop blocks on `std::cin >> c` between
        # Running() checks; trickle keystrokes until it exits
        try:
            while proc.poll() is None:
                proc.stdin.write(b"x\n")
                proc.stdin.flush()
                time.sleep(0.2)
        except (BrokenPipeError, OSError, ValueError):
            pass

    th = threading.Thread(target=feeder, daemon=True)
    th.start()
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return None, f"reference binary timed out after {timeout}s"
    wall = time.perf_counter() - t0
    tray = os.path.join(seq_dir, "rebvo_tray.txt")
    if not os.path.exists(tray):
        return None, (f"no trajectory written (exit {proc.returncode}); "
                      f"stderr: {err.decode(errors='replace')[-500:]}")
    rows = np.loadtxt(tray)
    if rows.ndim != 2 or rows.shape[0] < 10:
        return None, f"trajectory too short: shape {rows.shape}"
    return rows[:, 1:4], wall


def run_repo(seq_dir: str, timeout: float = 1800.0, vi: bool = False,
             dist: bool = False, st: bool = False, kf_every: int = 0,
             overrides: dict = None, out_tag: str = "", cpu: bool = False):
    """Run this package's run_vo in a subprocess, on the CUDA device
    unless `cpu`; returns (positions, wall seconds, kernel launches).
    `overrides` patches config keys (control rows, e.g.
    BootstrapRescaleFrames=0) into a tagged config and output directory,
    leaving the canonical run untouched."""
    out_dir = os.path.join(seq_dir, "repo_out" + out_tag)
    if overrides:
        from rebvo_tpu_torch.config import save_config
        p = parity_params(seq_dir, vi=vi, dist=dist, st=st).replace(
            **overrides)
        cfg = os.path.join(seq_dir, "GlobalConfig_parity" + out_tag)
        save_config(p, cfg)
    else:
        cfg = write_parity_config(seq_dir, vi=vi, dist=dist, st=st)
    cmd = [sys.executable, "-m", "rebvo_tpu_torch.apps.run_vo", "--config",
           cfg, "--out-dir", out_dir]
    if cpu:
        cmd.append("--cpu")
    if kf_every:
        cmd += ["--kf-every", str(kf_every)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True, text=True,
                       timeout=timeout)
    wall = time.perf_counter() - t0
    tray = os.path.join(out_dir, "rebvo_tray.txt")
    if r.returncode != 0 or not os.path.exists(tray):
        raise RuntimeError(f"run_vo failed ({r.returncode}):\n"
                           f"{r.stdout[-800:]}\n{r.stderr[-800:]}")
    launches = {}
    for line in r.stdout.splitlines():
        if line.startswith("kernel_launches="):
            launches = json.loads(line.split("=", 1)[1])
    rows = np.loadtxt(tray)
    return rows[:, 1:4], wall, launches


def _dataset_t0(seq_dir: str) -> float:
    """First frame time stamp (s) of the rendered dataset: VI variants
    offset the camera clock by VI_T0, so keyframe times shift back by it
    before they become GT frame indices."""
    try:
        with open(os.path.join(seq_dir, "data.csv")) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                return float(line.split(",")[0]) * 1e-9
    except OSError:
        pass
    return 0.0


def _ba_refine(seq_dir: str, gt: np.ndarray, warm: int, res: dict,
               cpu: bool = False):
    """Offline BA over the keyframes captured during the run (`run_ba` in
    a subprocess, on the CUDA device unless `cpu`); adds the keyframes'
    ATE before and after it."""
    from rebvo_tpu_torch.backend.keyframe import load_keyframes
    from rebvo_tpu_torch.io.trajectory import ate_rmse

    kf_path = os.path.join(seq_dir, "repo_out", "kf_list.npz")
    if not os.path.exists(kf_path):
        res["ba_error"] = "no keyframe store written"
        return
    opt_path = os.path.join(seq_dir, "repo_out", "kf_list_opt.npz")
    # a conservative refine (the JAX package's study on its loop store: a
    # tight match radius, a strong robustifier, one round of 4 iterations;
    # radius 8 with 4 rounds imports the field matching's occlusion bias)
    cmd = [sys.executable, "-m", "rebvo_tpu_torch.apps.run_ba", kf_path,
           "--out", opt_path, "--rounds", "1", "--iters", "4",
           "--field-radius", "2", "--huber-k", "1.0"]
    if cpu:
        cmd.append("--cpu")
    r = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True, text=True,
                       timeout=1800)
    if r.returncode != 0:
        res["ba_error"] = f"run_ba failed: {r.stderr[-400:]}"
        return
    ba_stats = json.loads(r.stdout.strip().splitlines()[-1])
    before = load_keyframes(kf_path, device="cpu")
    after = load_keyframes(opt_path, device="cpu")
    live = before.valid.numpy()
    t0 = _dataset_t0(seq_dir)
    idx = np.clip(np.round((before.t.numpy()[live] - t0) * FPS).astype(int),
                  0, len(gt) - 1)
    keep = idx >= warm                 # the trajectory ATE's settling cut
    idx = idx[keep]
    if idx.size < 3:
        res["ba_error"] = f"too few post-warm keyframes ({idx.size})"
        return
    gt_kf = gt[idx]
    p_on = before.Pos.numpy()[live][keep]
    p_ba = after.Pos.numpy()[live][keep]
    res["ba"] = {
        "keyframes": int(idx.size),
        "observations": ba_stats.get("observations"),
        "cost_initial": ba_stats.get("cost_initial"),
        "cost_final": ba_stats.get("cost_final"),
        "ate_kf_online_vs_gt": float(ate_rmse(p_on, gt_kf, with_scale=True)),
        "ate_kf_ba_vs_gt": float(ate_rmse(p_ba, gt_kf, with_scale=True)),
    }
    res["ba"]["ba_improves"] = bool(
        res["ba"]["ate_kf_ba_vs_gt"] < res["ba"]["ate_kf_online_vs_gt"])


def _resample(P: np.ndarray, n: int) -> np.ndarray:
    """Linear index resample of a trajectory to n rows (a run may log a
    few frames more or fewer at the ends)."""
    if len(P) == n:
        return P
    src = np.linspace(0, len(P) - 1, n)
    i0 = np.floor(src).astype(int)
    i1 = np.minimum(i0 + 1, len(P) - 1)
    w = (src - i0)[:, None]
    return P[i0] * (1 - w) + P[i1] * w


def evaluate_sequence(seq_dir, kind, n_frames, seed, skip_ref=False,
                      reuse=False, ba_every=0, cpu=False):
    """One parity row: render (or reuse) the dataset, run the reference
    unless `skip_ref`, run this package's run_vo (on the CUDA device
    unless `cpu`), and return the row's dict."""
    from rebvo_tpu_torch.io.trajectory import align_umeyama, ate_rmse

    # run_vo runs from the repo's root and reads the config's paths
    seq_dir = os.path.abspath(seq_dir)
    # the control-row suffix `_b0`: the base kind's dataset and reference
    # run, with the port run reference-exact (BootstrapRescaleFrames=0)
    overrides, out_tag = None, ""
    label = kind
    if kind.endswith("_b0"):
        kind = kind[:-3]
        overrides = {"BootstrapRescaleFrames": 0}
        out_tag = "_b0"
    _, vi, dist, st = _parse_kind(kind)
    res = {"sequence": label, "n_frames": n_frames, "seed": seed,
           "mode": ("visual-inertial" if vi else "mono")
                   + (" distorted" if dist else "")
                   + (" stereo" if st else ""),
           "repo_device": "cpu" if cpu else "cuda"}
    reusable = (reuse and os.path.exists(os.path.join(seq_dir, "data.csv"))
                and os.path.exists(os.path.join(seq_dir, "gt_pos.txt")))
    if reusable:
        gt = np.loadtxt(os.path.join(seq_dir, "gt_pos.txt"))
        meta_path = os.path.join(seq_dir, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as fh:
                res["seed"] = json.load(fh).get("seed", seed)
        print(f"[{kind}] reusing the rendered dataset", flush=True)
    else:
        print(f"[{kind}] rendering {n_frames} frames ...", flush=True)
        t0 = time.perf_counter()
        gt = render_dataset(seq_dir, kind, n_frames, seed)
        res["render_s"] = round(time.perf_counter() - t0, 2)

    ref_pos = None
    if not skip_ref:
        tray = os.path.join(seq_dir, "rebvo_tray.txt")
        if reusable and os.path.exists(tray):
            ref_pos = np.loadtxt(tray)[:, 1:4]
        else:
            print(f"[{kind}] running the reference binary ...", flush=True)
            ref_pos, ref_info = run_reference(seq_dir, vi=vi, dist=dist,
                                              st=st)
            if ref_pos is None:
                res["reference_error"] = ref_info
                print(f"[{kind}] reference FAILED: {ref_info}", flush=True)
            else:
                res["ref_wall_s"] = round(ref_info, 2)
                res["ref_fps"] = round(len(ref_pos) / ref_info, 1)

    print(f"[{kind}] running run_vo ...", flush=True)
    repo_pos, repo_wall, launches = run_repo(
        seq_dir, vi=vi, dist=dist, st=st, kf_every=ba_every,
        overrides=overrides, out_tag=out_tag, cpu=cpu)
    res["repo_wall_s"] = round(repo_wall, 2)
    res["repo_kernel_launches"] = launches

    # skip the bootstrap frames both systems spend converging depth
    warm = min(40, n_frames // 4)
    if ba_every:
        print(f"[{kind}] offline BA over keyframes ...", flush=True)
        _ba_refine(seq_dir, gt, warm, res, cpu=cpu)
    gt_w = gt[warm:]
    repo_w = _resample(repo_pos, n_frames)[warm:]
    res["ate_repo_vs_gt"] = float(ate_rmse(repo_w, gt_w, with_scale=True))
    if vi or st:
        # metric scale: the VI filter's K (or the stereo baseline) should
        # make the trajectory metric, an alignment scale near 1; the
        # scale-fixed SE(3) ATE does not forgive a wrong global scale
        s_align, _, _ = align_umeyama(repo_w, gt_w, with_scale=True)
        res["align_scale_repo"] = float(s_align)
        res["scale_ok"] = bool(abs(1.0 - float(s_align)) < 0.10)
        res["ate_se3_repo_vs_gt"] = float(
            ate_rmse(repo_w, gt_w, with_scale=False))
    if ref_pos is not None:
        ref_w = _resample(ref_pos, n_frames)[warm:]
        res["ate_ref_vs_gt"] = float(ate_rmse(ref_w, gt_w, with_scale=True))
        res["ate_repo_vs_ref"] = float(
            ate_rmse(repo_w, ref_w, with_scale=True))
        res["repo_beats_ref"] = bool(
            res["ate_repo_vs_gt"] <= res["ate_ref_vs_gt"])
        if vi or st:
            s_ref, _, _ = align_umeyama(ref_w, gt_w, with_scale=True)
            res["align_scale_ref"] = float(s_ref)
            res["ate_se3_ref_vs_gt"] = float(
                ate_rmse(ref_w, gt_w, with_scale=False))
    print(f"[{kind}] "
          f"{json.dumps({k: v for k, v in res.items() if 'ate' in k})}",
          flush=True)
    return res


# name-keyed scene seeds (the JAX package's): a dataset does not depend on
# which subset of sequences a run evaluates; variants reuse their base
# scene's seed, unknown names get one from the name's crc32
SEQ_SEED = {"lateral_arc": 7, "dolly": 20, "loop": 33, "loop3": 33,
            "lateral_arc_vi": 7, "dolly_vi": 20, "loop_vi": 33,
            "lateral_arc_dist": 7, "dolly_dist": 20, "loop_dist": 33,
            "lateral_arc_st": 7, "dolly_st": 20, "loop_st": 33}


def seq_seed(kind: str) -> int:
    import zlib
    return SEQ_SEED.get(kind, zlib.crc32(kind.encode()) % 997)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out-dir",
                    default=os.path.join(REPO_ROOT, "build", "parity"))
    ap.add_argument("--json", default=None,
                    help="summary file (default <out-dir>/parity.json)")
    ap.add_argument("--n-frames", type=int, default=240)
    ap.add_argument("--skip-ref", action="store_true")
    ap.add_argument("--reuse", action="store_true",
                    help="reuse an existing rendered dataset and the "
                         "reference's trajectory; re-run only run_vo")
    ap.add_argument("--seqs", default="lateral_arc,dolly,loop")
    ap.add_argument("--ba-every", type=int, default=0,
                    help="capture a keyframe every N frames during the "
                         "run and report the keyframes' ATE before and "
                         "after offline BA")
    ap.add_argument("--cpu", action="store_true",
                    help="run run_vo and run_ba on the CPU")
    args = ap.parse_args(argv)

    results = []
    for kind in args.seqs.split(","):
        # per-sequence frame count: "loop3:1600" overrides --n-frames
        n_frames = args.n_frames
        if ":" in kind:
            kind, nf = kind.split(":", 1)
            n_frames = int(nf)
        # control rows (_b0) share their base kind's directory and seed
        base_dir_kind = kind[:-3] if kind.endswith("_b0") else kind
        seq_dir = os.path.join(args.out_dir, base_dir_kind)
        os.makedirs(seq_dir, exist_ok=True)
        results.append(evaluate_sequence(
            seq_dir, kind, n_frames, seed=seq_seed(base_dir_kind),
            skip_ref=args.skip_ref, reuse=args.reuse,
            ba_every=args.ba_every, cpu=args.cpu))

    ok = [r for r in results if "ate_ref_vs_gt" in r]
    summary = {
        "date": time.strftime("%Y-%m-%d"),
        "reference_binary": None if args.skip_ref else REF_BINARY,
        "sequences": results,
        "n_compared": len(ok),
        "repo_beats_ref_all": bool(ok) and all(r["repo_beats_ref"]
                                               for r in ok),
    }
    path = args.json or os.path.join(args.out_dir, "parity.json")
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
