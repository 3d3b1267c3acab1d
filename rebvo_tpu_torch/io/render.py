"""Procedural synthetic sequence renderer for end-to-end VO tests and
smoke runs (a copy of rebvo_tpu/io/render.py, owned by the port, plus the
procedural `synth_frames` and the lateral `render_lateral` sequence).

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
