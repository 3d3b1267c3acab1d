"""The benchmark's input generator: EuRoC-shaped camera frames and IMU
samples of a periodic camera path, made from a seed.

A frozen PyTorch rewrite of the port's billboard renderer
(`render_billboards_seq` at ss=1, and the distortion resampling of
`write_euroc_vi`, in rebvo_tpu_torch/io/render.py): seven textured
fronto-parallel billboards over a far textured plane, each texture a
sum of eight sinusoids quantised into flat patches. The scene's
numbers are drawn on the host exactly as the original draws them
(numpy `RandomState`); the frames are ray-cast on the device in
float64, in a few large calls.

The camera path is periodic, so a run can loop one period of frames
for as long as it measures without a jump: a lateral x = amp (1 -
cos w tau)^2 / 2 (0 to 2 amp and back) and a yaw dither yaw_amp (1 -
cos w_yaw tau) about the camera y axis. With both at 0.5 Hz and 20
frames/s one period is 40 frames. A visual-inertial run holds still
for its first `hold` frames (tau = 0 there). The IMU is the exact
derivative of the path (body rate (0, yaw', 0), specific force
R^T (a_w - g_w), gravity +y) plus white noise at the stated noise
densities, drawn from the seed. A stereo run also renders cam1 along
`pair_poses`, through cam1's own intrinsics and distortion, as
`write_euroc_vi(stereo=True)` writes it.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

N_SINES = 8
N_BOARDS = 7
Z_BACKGROUND = 8.0
IMU_HZ = 200.0
G_WORLD = (0.0, 9.8, 0.0)


def scene_seed(seed: int, lane: int = 0) -> int:
    """A scene seed the original renderer accepts (below 2**31 - 2000)
    for a run seed of any size and a lane."""
    s = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(lane)])
    return int(s.generate_state(1)[0]) % (2 ** 31 - 2000)


def texture_table(tex_seed: int) -> np.ndarray:
    """The [N_SINES, 4] (kx, ky, phase, amplitude) of `cartoon_texture`
    for `tex_seed`, drawn in the original's order."""
    rng = np.random.RandomState(tex_seed)
    rows = []
    for _ in range(N_SINES):
        kx, ky = rng.uniform(2.0, 9.0, 2) * rng.choice([-1, 1], 2)
        ph = rng.uniform(0, 2 * np.pi)
        a = rng.uniform(0.5, 1.0)
        rows.append((kx, ky, ph, a))
    return np.asarray(rows, np.float64)


def boards(seed: int) -> np.ndarray:
    """[N_BOARDS, 6] (z, x0, x1, y0, y1, texture seed), nearest first,
    drawn as `render_billboards_seq` draws them."""
    rng = np.random.RandomState(seed + 1000)
    out = []
    for k in range(N_BOARDS):
        z = rng.uniform(1.8, 5.0)
        w = rng.uniform(0.6, 1.6)
        h = rng.uniform(0.5, 1.2)
        x0 = rng.uniform(-1.6, 1.2)
        y0 = rng.uniform(-1.1, 0.6)
        out.append((z, x0, x0 + w, y0, y0 + h, seed + k + 1))
    out.sort(key=lambda b: b[0])
    return np.asarray(out, np.float64)


def _texture(X: torch.Tensor, Y: torch.Tensor, table: np.ndarray,
             levels: int = 6) -> torch.Tensor:
    """`cartoon_texture` at world points (X, Y), float64, summed in the
    original's order. `table` is a host array."""
    f = torch.zeros_like(X)
    amp = 0.0
    for kx, ky, ph, a in table.tolist():
        f = f + a * torch.sin(kx * X + ky * Y + ph)
        amp += a
    span = 0.72 * amp
    q = torch.clamp((f + span) / (2.0 * span + 1e-9), 0.0, 1.0 - 1e-9)
    q = torch.floor(q * levels) / levels
    return q ** 1.7


def render(seed: int, positions: np.ndarray, rotations: np.ndarray, *,
           width: int, height: int, zf: float, cx: float, cy: float,
           device, max_val: float = 765.0) -> torch.Tensor:
    """Frames [N, height, width] float32 (0..max_val) of the billboard
    scene `seed` seen from camera centres `positions` [N, 3] with
    world-from-camera rotations `rotations` [N, 3, 3]: the original at
    ss=1."""
    kw = dict(dtype=torch.float64, device=device)
    bd = boards(seed)
    tables = [texture_table(int(s)) for s in [seed] + [int(b[5]) for b in bd]]
    xs = (torch.arange(width, **kw) - cx) / zf
    ys = (torch.arange(height, **kw) - cy) / zf
    dy, dx = torch.meshgrid(ys, xs, indexing="ij")
    rays = torch.stack([dx, dy, torch.ones_like(dx)], -1)
    R = torch.as_tensor(np.asarray(rotations, np.float64), **kw)
    C = torch.as_tensor(np.asarray(positions, np.float64), **kw)
    rw = torch.einsum("hwj,nij->nhwi", rays, R)
    c = C[:, None, None, :]

    def hit_plane(z):
        t = (z - c[..., 2]) / rw[..., 2]
        return t, c[..., 0] + t * rw[..., 0], c[..., 1] + t * rw[..., 1]

    _, X, Y = hit_plane(Z_BACKGROUND)
    img = _texture(X * 0.7, Y * 0.7, tables[0])
    for k in reversed(range(len(bd))):             # far to near
        z, x0, x1, y0, y1, _ = bd[k]
        t, X, Y = hit_plane(z)
        hit = (t > 0) & (X >= x0) & (X <= x1) & (Y >= y0) & (Y <= y1)
        img = torch.where(hit, _texture(X * 2.0, Y * 2.0, tables[k + 1]),
                          img)
    return (50.0 + img * (max_val - 100.0)).to(torch.float32)


def undistort_points(hx, hy, cam, iters: int = 20):
    """Distorted hom -> ideal hom (the exact inverse of the camera's
    radial-tangential distortion by fixed-point iteration, float64),
    as `write_euroc_vi` computes it."""
    xd, yd = hx / cam.fx, hy / cam.fy
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.kc2 + r2 * (cam.kc4 + r2 * cam.kc6))
        tx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        ty = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        x, y = (xd - tx) / radial, (yd - ty) / radial
    return x * cam.zfm, y * cam.zfm


class ResampleMap(NamedTuple):
    margin: int
    x0: np.ndarray
    y0: np.ndarray
    fx: np.ndarray
    fy: np.ndarray


def resample_map(cam) -> ResampleMap:
    """Where each pixel of `cam`'s distorted image samples an ideal
    pinhole image of focal zfm, oversized by a margin on every side."""
    H, W = cam.height, cam.width
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    ux, uy = undistort_points(xs - cam.cx, ys - cam.cy, cam)
    m = int(np.ceil(max(np.abs(ux + cam.cx - xs).max(),
                        np.abs(uy + cam.cy - ys).max()))) + 2
    sx = np.clip(ux + cam.cx + m, 0, W + 2 * m - 1.001)
    sy = np.clip(uy + cam.cy + m, 0, H + 2 * m - 1.001)
    x0, y0 = sx.astype(np.int64), sy.astype(np.int64)
    return ResampleMap(m, x0, y0, sx - x0, sy - y0)


def camera_frames(seed: int, positions, rotations, cam, device,
                  rm: ResampleMap = None, block: int = 8) -> torch.Tensor:
    """The 8-bit frames [N, H, W] (uint8, on `device`) that `cam` sees
    along the path: the ideal oversized render resampled through the
    camera's distortion (`rm`, computed when not given) and rounded to 8
    bits, as `write_euroc_vi` writes them. Rendered `block` frames a
    call."""
    rm = resample_map(cam) if rm is None else rm
    m = rm.margin
    kw = dict(device=device)
    x0 = torch.as_tensor(rm.x0, **kw)
    y0 = torch.as_tensor(rm.y0, **kw)
    fx = torch.as_tensor(rm.fx, dtype=torch.float64, **kw)
    fy = torch.as_tensor(rm.fy, dtype=torch.float64, **kw)
    out = []
    for i in range(0, len(positions), block):
        img = render(seed, positions[i:i + block], rotations[i:i + block],
                     width=cam.width + 2 * m, height=cam.height + 2 * m,
                     zf=cam.zfm, cx=cam.cx + m, cy=cam.cy + m,
                     device=device).to(torch.float64)
        d = (img[:, y0, x0] * (1 - fx) * (1 - fy)
             + img[:, y0, x0 + 1] * fx * (1 - fy)
             + img[:, y0 + 1, x0] * (1 - fx) * fy
             + img[:, y0 + 1, x0 + 1] * fx * fy)
        out.append(torch.clamp(torch.round(d / 3.0), 0, 255)
                   .to(torch.uint8))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# The periodic path and its IMU
# ---------------------------------------------------------------------------


class PathSpec(NamedTuple):
    amp: float        # half the lateral peak to peak (m)
    hz: float         # lateral frequency
    yaw_amp: float    # rad
    yaw_hz: float

    @staticmethod
    def from_traffic(tr: dict) -> "PathSpec":
        p = tr["path"]
        return PathSpec(p["lateral_peak_to_peak_m"] / 2.0, p["lateral_hz"],
                        p["yaw_amp_rad"], p["yaw_hz"])


def path(spec: PathSpec, tau):
    """(pos [N,3], pos'' [N,3], yaw [N], yaw' [N]) at path times tau
    (s, 0 = the start of the motion; negative values hold still)."""
    tau = np.maximum(np.asarray(tau, np.float64), 0.0)
    w, w2 = 2 * np.pi * spec.hz, 2 * np.pi * spec.yaw_hz
    c, s = np.cos(w * tau), np.sin(w * tau)
    pos = np.zeros(tau.shape + (3,))
    acc = np.zeros(tau.shape + (3,))
    pos[..., 0] = 0.5 * spec.amp * (1.0 - c) ** 2
    acc[..., 0] = spec.amp * w * w * (s * s + (1.0 - c) * c)
    yaw = spec.yaw_amp * (1.0 - np.cos(w2 * tau))
    yaw_dot = spec.yaw_amp * w2 * np.sin(w2 * tau)
    return pos, acc, yaw, yaw_dot


def yaw_rotation(a) -> np.ndarray:
    """World-from-camera rotations [N, 3, 3] of yaw angles `a` about
    the camera y axis."""
    a = np.asarray(a, np.float64)
    c, s = np.cos(a), np.sin(a)
    R = np.zeros(a.shape + (3, 3))
    R[..., 0, 0] = c
    R[..., 0, 2] = s
    R[..., 1, 1] = 1.0
    R[..., 2, 0] = -s
    R[..., 2, 2] = c
    return R


def period_frames(spec: PathSpec, fps: float) -> int:
    """Frames in one period of the path (both motions close)."""
    n = fps / spec.hz
    if abs(n - round(n)) > 1e-9 or abs(spec.hz - spec.yaw_hz) > 1e-12:
        raise ValueError(f"path does not close on a whole frame: "
                         f"{fps} frames/s, {spec.hz} Hz, {spec.yaw_hz} Hz")
    return int(round(n))


def period_poses(spec: PathSpec, fps: float):
    """(positions [P, 3], rotations [P, 3, 3]) of one period's frames."""
    P = period_frames(spec, fps)
    pos, _, yaw, _ = path(spec, np.arange(P) / fps)
    return pos, yaw_rotation(yaw)


def pair_poses(R01, t01, pos, rot):
    """cam1's world poses (positions [N, 3], world-from-camera rotations
    [N, 3, 3]) for cam0's `pos` and `rot`, from the cam0 -> cam1
    extrinsics (X1 = R01 X0 + t01): R_wc1 = R_wc0 R01^T, C1 = C0 -
    R_wc1 t01. The convention of the port's `io/render.pair_poses`."""
    R01 = np.asarray(R01, np.float64)
    t01 = np.asarray(t01, np.float64)
    rot1 = np.asarray(rot, np.float64) @ R01.T
    return np.asarray(pos, np.float64) - np.einsum("nij,j->ni", rot1,
                                                   t01), rot1


def imu_samples(spec: PathSpec, t_hold: float, t_first: float,
                t_last: float, t0: float, gyro_density: float,
                accel_density: float, rng: np.random.Generator) -> np.ndarray:
    """EuRoC-style IMU rows [t, gx, gy, gz, ax, ay, az] at IMU_HZ from
    `t_first` to `t_last` (path seconds, shifted by `t0` in the rows):
    the exact rate and specific force of the path plus white noise of
    the given densities (per square-root hertz)."""
    k = np.arange(int(np.floor(t_first * IMU_HZ)),
                  int(np.floor(t_last * IMU_HZ)) + 1)
    tk = k / IMU_HZ
    _, acc, yaw, yaw_dot = path(spec, tk - t_hold)
    Rt = np.swapaxes(yaw_rotation(yaw), -1, -2)
    f = np.einsum("nij,nj->ni", Rt, acc - np.asarray(G_WORLD))
    rows = np.zeros((tk.shape[0], 7))
    rows[:, 0] = tk + t0
    rows[:, 2] = yaw_dot
    rows[:, 4:7] = f
    sq = np.sqrt(IMU_HZ)
    rows[:, 1:4] += rng.standard_normal((tk.shape[0], 3)) * gyro_density * sq
    rows[:, 4:7] += rng.standard_normal((tk.shape[0], 3)) * accel_density * sq
    return rows


def frame_index(i: int, hold: int, period: int, phase: int = 0) -> int:
    """The period frame that run frame `i` shows: still (phase 0) for
    the first `hold` frames, then the period from `phase` on."""
    return 0 if i < hold else (i - hold + phase) % period


def lane_phases(lanes: int, period: int) -> List[int]:
    """Each lane's starting frame in the period, spread evenly."""
    return [(b * period) // lanes for b in range(lanes)]
