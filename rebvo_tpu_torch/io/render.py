"""Procedural synthetic sequence renderer for end-to-end VO tests and
smoke runs (a copy of rebvo_tpu/io/render.py, owned by the port, plus the
procedural `synth_frames`, the lateral `render_lateral` sequence, and
`write_euroc_vi`, which writes a EuRoC directory of distorted frames and
the IMU samples of their path).

Renders a textured fronto-parallel plane (piecewise-constant 'cartoon'
texture whose region boundaries provide DoG edges) viewed by a moving
pinhole camera — a deterministic, dependency-free stand-in for dataset
replay (the reference's verification harness, SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np


def cartoon_texture(X: np.ndarray, Y: np.ndarray, seed: int = 0,
                    levels: int = 6) -> np.ndarray:
    """Smooth random field quantised into flat patches (values 0..1).

    Normalisation is FIXED by the drawn amplitudes (not the min/max of
    the sampled crop), so the texture is a pure function of world
    coordinates: the same surface point keeps its value from any
    viewpoint (the crop-dependent variant flickered slightly frame to
    frame) and the field can be evaluated on sparse subsets."""
    rng = np.random.RandomState(seed)
    f = np.zeros_like(X, dtype=np.float64)
    amp = 0.0
    for _ in range(8):
        kx, ky = rng.uniform(2.0, 9.0, 2) * rng.choice([-1, 1], 2)
        ph = rng.uniform(0, 2 * np.pi)
        a = rng.uniform(0.5, 1.0)
        f = f + a * np.sin(kx * X + ky * Y + ph)
        amp += a
    # 0.72*amp ~ the empirical range of an 8-sin sum (the strict bound
    # amp is almost never reached; using it would waste outer levels)
    span = 0.72 * amp
    q = np.clip((f + span) / (2.0 * span + 1e-9), 0.0, 1.0 - 1e-9)
    q = np.floor(q * levels) / levels
    # Non-linear level spacing: adjacent patches differ by varying
    # contrast, so detector counts vary smoothly with the threshold
    # (uniform contrast makes the auto-threshold controller oscillate).
    return q ** 1.7


def _supersample_grid(width, height, cx, cy, zf, ss):
    """Pixel-center ray grid at ss x ss supersampling."""
    xs = (np.arange(width * ss) + 0.5) / ss - 0.5
    ys = (np.arange(height * ss) + 0.5) / ss - 0.5
    xs = (xs - cx) / zf
    ys = (ys - cy) / zf
    return np.meshgrid(xs, ys)


def _downsample(img, ss):
    H, W = img.shape
    return img.reshape(H // ss, ss, W // ss, ss).mean(axis=(1, 3))


def render_billboards_seq(n_frames: int, *, width=752, height=480, zf=400.0,
                          cx=376.0, cy=240.0, seed=0,
                          cam_positions=None, cam_rotations=None,
                          max_val=765.0, return_depth=False, ss=3):
    """Ray-cast a multi-depth scene of textured fronto-parallel
    billboards over a far background plane (view-consistent, with real
    occlusions and depth discontinuities) — a well-conditioned scene for
    vision-only VO, unlike a single plane (planar-homography ambiguity).
    """
    if cam_positions is None:
        cam_positions = np.zeros((n_frames, 3))
    if cam_rotations is None:
        cam_rotations = np.tile(np.eye(3), (n_frames, 1, 1))

    rng = np.random.RandomState(seed + 1000)
    boards = []   # (z, x0, x1, y0, y1, tex_seed)
    for k in range(7):
        z = rng.uniform(1.8, 5.0)
        w = rng.uniform(0.6, 1.6)
        h = rng.uniform(0.5, 1.2)
        x0 = rng.uniform(-1.6, 1.2)
        y0 = rng.uniform(-1.1, 0.6)
        boards.append((z, x0, x0 + w, y0, y0 + h, seed + k + 1))
    boards.sort(key=lambda b: b[0])          # nearest first
    z_bg = 8.0

    dx, dy = _supersample_grid(width, height, cx, cy, zf, ss)
    rays = np.stack([dx, dy, np.ones_like(dx)], axis=-1)

    frames = np.empty((n_frames, height, width), np.float32)
    depths = np.empty((n_frames, height, width), np.float32)
    for i in range(n_frames):
        Rwc = cam_rotations[i]
        c = cam_positions[i]
        rw = rays @ Rwc.T
        # paint from background to front (at ss x supersampling, then
        # box-downsample: without anti-aliasing, rendered edges move in
        # whole-pixel jumps and bias subpixel VO tests)
        t = (z_bg - c[2]) / rw[..., 2]
        X = c[0] + t * rw[..., 0]
        Y = c[1] + t * rw[..., 1]
        img = cartoon_texture(X * 0.7, Y * 0.7, seed=seed)
        dep = t.copy()
        for (z, x0, x1, y0, y1, ts) in reversed(boards):   # far to near
            t = (z - c[2]) / rw[..., 2]
            X = c[0] + t * rw[..., 0]
            Y = c[1] + t * rw[..., 1]
            hit = (t > 0) & (X >= x0) & (X <= x1) & (Y >= y0) & (Y <= y1)
            # texture only where the board is hit (it is a pure function
            # of world coordinates, so subset evaluation is exact; a
            # board typically covers a small fraction of the frame)
            img[hit] = cartoon_texture(X[hit] * 2.0, Y[hit] * 2.0, seed=ts)
            dep[hit] = t[hit]
        frames[i] = _downsample(50.0 + img * (max_val - 100.0), ss).astype(np.float32)
        depths[i] = _downsample(dep, ss).astype(np.float32)
    if return_depth:
        return frames, depths
    return frames


def render_plane_seq(n_frames: int, *, width=752, height=480, zf=400.0,
                     cx=376.0, cy=240.0, z0=3.0, seed=0,
                     cam_positions=None, cam_rotations=None,
                     plane_normal=None, max_val=765.0,
                     return_depth=False, ss=3):
    """Render a sequence of a textured plane from camera poses.

    The plane passes through (0, 0, z0) with normal `plane_normal`
    (default (0,0,1), i.e. fronto-parallel — note that case leaves the
    Vy/Wx and Vx/Wy motion pairs nearly degenerate; tilt the plane for
    well-conditioned VO tests).

    cam_positions: [N,3] camera centers (world); default: origin.
    cam_rotations: [N,3,3] world-from-camera rotations; default identity.
    Returns float32 images [N,H,W] scaled 0..max_val; with return_depth,
    also the per-pixel camera-frame depth maps [N,H,W].
    """
    if cam_positions is None:
        cam_positions = np.zeros((n_frames, 3))
    if cam_rotations is None:
        cam_rotations = np.tile(np.eye(3), (n_frames, 1, 1))
    n = np.asarray([0.0, 0.0, 1.0] if plane_normal is None else plane_normal,
                   np.float64)
    n = n / np.linalg.norm(n)
    p0 = np.array([0.0, 0.0, z0])

    dx, dy = _supersample_grid(width, height, cx, cy, zf, ss)
    rays = np.stack([dx, dy, np.ones_like(dx)], axis=-1)   # camera rays

    frames = np.empty((n_frames, height, width), np.float32)
    depths = np.empty((n_frames, height, width), np.float32)
    for i in range(n_frames):
        Rwc = cam_rotations[i]
        c = cam_positions[i]
        rw = rays @ Rwc.T                      # rays in world frame
        # intersect with the plane: n . (c + t*rw - p0) = 0
        t = (n @ (p0 - c)) / (rw @ n)
        X = c[0] + t * rw[..., 0]
        Y = c[1] + t * rw[..., 1]
        tex = cartoon_texture(X, Y, seed=seed)
        frames[i] = _downsample(50.0 + tex * (max_val - 100.0), ss).astype(np.float32)
        depths[i] = _downsample(t * rays[..., 2], ss).astype(np.float32)
    if return_depth:
        return frames, depths
    return frames


def synth_frames(params, n, seed=0):
    """Cheap procedural frames at the configured size (values 0..765):
    a moving sign-of-sines checkerboard plus noise, for smoke runs
    (`run_vo --synthetic`)."""
    H, W = params.ImageHeight, params.ImageWidth
    rng = np.random.RandomState(seed)
    xx, yy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    out = []
    for i in range(n):
        img = 300.0 + 250.0 * np.sign(
            np.sin(xx / 17.0 + 0.3 * i) * np.sin(yy / 13.0 - 0.2 * i))
        out.append((img + rng.rand(H, W) * 8.0).astype(np.float32))
    return out


def render_lateral(params, n_frames, step=0.01, seed=0, ss=1):
    """A billboard sequence seen by the configured pinhole camera moving
    sideways `step` per frame (the bench's rendered lane)."""
    pos = np.zeros((n_frames, 3))
    pos[:, 0] = np.arange(n_frames) * step
    return render_billboards_seq(
        n_frames, width=params.ImageWidth, height=params.ImageHeight,
        zf=params.zf_mean, cx=params.PPx, cy=params.PPy,
        cam_positions=pos, seed=seed, ss=ss)


def _undistort_np(hx, hy, cam, iters=20):
    """Distorted hom -> ideal hom: the exact inverse of
    CameraModel.distort_hom (radial + tangential, per-axis focal) by
    fixed-point iteration in float64, as OpenCV's undistortPoints does."""
    xd, yd = hx / cam.fx, hy / cam.fy
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.kc2 + r2 * (cam.kc4 + r2 * cam.kc6))
        tx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        ty = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        x, y = (xd - tx) / radial, (yd - ty) / radial
    return x * cam.zfm, y * cam.zfm


def vi_lateral_path(t, t_hold):
    """Camera path of `write_euroc_vi` at times t (s): still until
    t_hold, then x = amp (1 - cos w tau)^2 / 2 (from 0 to 2 amp = 0.3 m
    and back at 0.5 Hz, starting at zero velocity and zero acceleration)
    and a yaw dither yaw_amp (1 - cos w2 tau) about the camera y axis
    (0.03 rad at 0.7 Hz, starting at zero rate). Returns (pos [N,3],
    pos'' [N,3], yaw [N], yaw' [N])."""
    amp, yaw_amp = 0.15, 0.03
    tau = np.maximum(np.asarray(t, np.float64) - t_hold, 0.0)
    w, w2 = 2 * np.pi * 0.5, 2 * np.pi * 0.7
    c, s = np.cos(w * tau), np.sin(w * tau)
    pos = np.zeros(tau.shape + (3,))
    acc = np.zeros(tau.shape + (3,))
    pos[..., 0] = 0.5 * amp * (1.0 - c) ** 2
    acc[..., 0] = amp * w * w * (s * s + (1.0 - c) * c)
    yaw = yaw_amp * (1.0 - np.cos(w2 * tau))
    yaw_dot = yaw_amp * w2 * np.sin(w2 * tau)
    return pos, acc, yaw, yaw_dot


def _yaw_R(a):
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


IMU_HZ = 200.0                # write_euroc_vi's IMU rate (EuRoC's)
T0_NS = 1_000_000_000         # its first frame's time stamp


def pair_poses(params, pos, rots):
    """World poses of cam1 for cam0 centres `pos` [N, 3] and rotations
    `rots` [N, 3, 3] (world-from-camera), from the config's cam0 -> cam1
    extrinsics (X1 = R01 X0 + t01): R_wc1 = R_wc0 R01^T, C1 = C0 -
    R_wc1 t01. Returns (pos1, rots1)."""
    R01, t01 = params.stereo_extrinsics()
    rots1 = rots @ R01.T
    return pos - np.einsum("nij,j->ni", rots1, t01), rots1


def _resample_map(cam, H, W):
    """For each pixel of `cam`'s distorted H x W image, where it samples
    an ideal pinhole image of focal zfm oversized by a margin m on every
    side: (m, x0, y0, fx, fy) for bilinear interpolation."""
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    ux, uy = _undistort_np(xs - cam.cx, ys - cam.cy, cam)
    m = int(np.ceil(max(np.abs(ux + cam.cx - xs).max(),
                        np.abs(uy + cam.cy - ys).max()))) + 2
    sx = np.clip(ux + cam.cx + m, 0, W + 2 * m - 1.001)
    sy = np.clip(uy + cam.cy + m, 0, H + 2 * m - 1.001)
    x0, y0 = sx.astype(np.int64), sy.astype(np.int64)
    return m, x0, y0, sx - x0, sy - y0


def write_euroc_vi(params, n_frames: int, out_dir: str, seed: int = 0,
                   workers: int = 1, stereo: bool = False):
    """Write a EuRoC `mav0` directory for a visual-inertial run at the
    config's camera: `cam0/data.csv`, `cam0/data/<ns>.png` (8-bit grey)
    and `imu0/data.csv` at IMU_HZ, gravity +y in the world, IMU frame =
    camera frame; with `stereo`, also `cam1/data.csv` and
    `cam1/data/<ns>.png` at the same time stamps.

    The camera holds still for InitBiasFrameNum + 2 frames (the gyro-bias
    init averages them), then moves on `vi_lateral_path`. The IMU is the
    exact derivative of that path: body rate (0, yaw', 0) and specific
    force R^T (a_w - g_w). Each frame is a billboard scene rendered by an
    ideal pinhole camera of focal zf_mean, oversized by a margin, then
    resampled at every pixel of the config's camera through the exact
    inverse of its distortion (radial-tangential, per-axis focal), so
    the pipeline's undistortion undoes a real distortion. A cam1 frame is
    rendered from cam1's pose (`pair_poses`) and resampled through cam1's
    own (`Stereo*`) intrinsics and distortion. `workers` threads render
    and write frames at once (numpy and zlib release the GIL). Returns
    (frame times in s, cam0 positions [n, 3])."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from rebvo_tpu_torch.core.geometry import CameraModel
    from rebvo_tpu_torch.io.png import write_png

    H, W = params.ImageHeight, params.ImageWidth
    fps = params.config_fps
    t_hold = (params.InitBiasFrameNum + 2) / fps
    t_frames = np.arange(n_frames) / fps
    pos, _, yaw, _ = vi_lateral_path(t_frames, t_hold)
    rots = np.stack([_yaw_R(a) for a in yaw])
    # (directory, camera, camera centres, rotations) per stream
    streams = [("cam0", CameraModel.from_params(params), pos, rots)]
    if stereo:
        streams.append(("cam1", CameraModel.from_params(params, stereo=True))
                       + pair_poses(params, pos, rots))
    maps = [_resample_map(cam, H, W) for _, cam, _, _ in streams]
    stamps = [T0_NS + int(round(t * 1e9)) for t in t_frames]
    for name, _, _, _ in streams:
        os.makedirs(os.path.join(out_dir, name, "data"), exist_ok=True)
    imu_dir = os.path.join(out_dir, "imu0")
    os.makedirs(imu_dir, exist_ok=True)

    def frame(k):
        (name, cam, c, r), (m, x0, y0, fx, fy) = streams[k[0]], maps[k[0]]
        i = k[1]
        img = render_billboards_seq(
            1, width=W + 2 * m, height=H + 2 * m, zf=cam.zfm,
            cx=cam.cx + m, cy=cam.cy + m, cam_positions=c[i:i + 1],
            cam_rotations=r[i:i + 1], seed=seed, ss=1)[0]
        d = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx *
             (1 - fy) + img[y0 + 1, x0] * (1 - fx) * fy +
             img[y0 + 1, x0 + 1] * fx * fy)
        write_png(os.path.join(out_dir, name, "data", f"{stamps[i]}.png"),
                  np.clip(np.round(d / 3.0), 0, 255).astype(np.uint8))

    with ThreadPoolExecutor(max_workers=max(workers, 1)) as pool:
        list(pool.map(frame, [(s, i) for s in range(len(streams))
                              for i in range(n_frames)]))
    lines = ["#timestamp [ns],filename"] + [f"{ns},{ns}.png"
                                           for ns in stamps]
    for name, _, _, _ in streams:
        with open(os.path.join(out_dir, name, "data.csv"), "w") as fh:
            fh.write("\n".join(lines) + "\n")

    # IMU from 0.1 s before the first frame to past the last one
    tk = np.arange(-int(0.1 * IMU_HZ), int((t_frames[-1] + 0.05) * IMU_HZ)
                   + 1) / IMU_HZ
    _, acc, yaw_k, yaw_dot = vi_lateral_path(tk, t_hold)
    g_w = np.asarray([0.0, 9.8, 0.0])
    lines = ["#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
             "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
             "a_RS_S_z [m s^-2]"]
    for k in range(tk.shape[0]):
        f = _yaw_R(yaw_k[k]).T @ (acc[k] - g_w)
        ns = T0_NS + int(round(tk[k] * 1e9))
        lines.append(f"{ns},0.0,{yaw_dot[k]:.9f},0.0,"
                     f"{f[0]:.9f},{f[1]:.9f},{f[2]:.9f}")
    with open(os.path.join(imu_dir, "data.csv"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return t_frames, pos
