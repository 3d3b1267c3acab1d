"""The input generator against the port's numpy originals."""

import numpy as np
import pytest
import torch

from rebvo_tpu_torch.config import REBVOParameters
from rebvo_tpu_torch.io.png import read_png
from rebvo_tpu_torch.io.render import (_yaw_R, render_billboards_seq,
                                       vi_lateral_path, write_euroc_vi)
from vobench import scene
from vobench.reference.config import REBVOParameters as RefParams
from vobench.reference.core.geometry import CameraModel
from vobench.tests.small import SMALL


@pytest.mark.parametrize("seed", [0, 5, 123456])
def test_render_equals_original(seed):
    pos, _, yaw, _ = vi_lateral_path(np.arange(4) * 0.3, 0.0)
    R = np.stack([_yaw_R(a) for a in yaw])
    kw = dict(width=94, height=60, zf=57.3, cx=46.2, cy=31.1)
    want = render_billboards_seq(4, cam_positions=pos, cam_rotations=R,
                                 seed=seed, ss=1, **kw)
    got = scene.render(seed, pos, R, device="cpu", **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_camera_frames_equal_write_euroc_vi(tmp_path):
    """The distorted 8-bit frames equal the PNGs write_euroc_vi writes
    for the same path (its 0.7 Hz yaw and still start)."""
    p = REBVOParameters().replace(**SMALL)
    n = 9
    write_euroc_vi(p, n, str(tmp_path), seed=3)
    spec = scene.PathSpec(0.15, 0.5, 0.03, 0.7)
    hold = p.InitBiasFrameNum + 2
    pos, _, yaw, _ = scene.path(spec, (np.arange(n) - hold) / p.config_fps)
    cam = CameraModel.from_params(RefParams(**{**RefParams().__dict__,
                                               **SMALL}))
    got = scene.camera_frames(3, pos, scene.yaw_rotation(yaw), cam,
                              "cpu").numpy()
    files = sorted((tmp_path / "cam0" / "data").iterdir())
    want = np.stack([read_png(str(f)) for f in files])
    np.testing.assert_array_equal(got, want)


def test_path_closes_on_itself():
    spec = scene.PathSpec(0.15, 0.5, 0.03, 0.5)
    P = scene.period_frames(spec, 20.0)
    assert P == 40
    t = np.asarray([0.0, P / 20.0, 0.013, P / 20.0 + 0.013])
    pos, acc, yaw, yaw_dot = scene.path(spec, t)
    for a in (pos, acc, yaw, yaw_dot):
        np.testing.assert_allclose(a[1], a[0], atol=1e-12)
        np.testing.assert_allclose(a[3], a[2], atol=1e-12)
    # the frames of the next period are the first period's frames
    pp, rr = scene.period_poses(spec, 20.0)
    pos2, _, yaw2, _ = scene.path(spec, (np.arange(P) + P) / 20.0)
    np.testing.assert_allclose(pos2, pp, atol=1e-12)
    np.testing.assert_allclose(scene.yaw_rotation(yaw2), rr, atol=1e-12)
    with pytest.raises(ValueError):
        scene.period_frames(scene.PathSpec(0.15, 0.5, 0.03, 0.7), 20.0)


def test_frame_index_holds_then_loops():
    assert [scene.frame_index(i, 3, 4) for i in range(9)] == \
        [0, 0, 0, 0, 1, 2, 3, 0, 1]
    assert [scene.frame_index(i, 0, 4, 2) for i in range(5)] == \
        [2, 3, 0, 1, 2]
    assert scene.lane_phases(4, 40) == [0, 10, 20, 30]


def test_imu_equals_path_derivatives_without_noise():
    """Noise off: the samples are vi_lateral_path's yaw rate and specific
    force R^T (a - g) (its 0.7 Hz yaw), and the acceleration is the
    path's second derivative."""
    spec = scene.PathSpec(0.15, 0.5, 0.03, 0.7)
    t_hold = 0.6
    rows = scene.imu_samples(spec, t_hold, -0.1, 3.0, 1.0, 0.0, 0.0,
                             np.random.default_rng(0))
    tk = rows[:, 0] - 1.0
    _, acc, yaw, yaw_dot = vi_lateral_path(tk, t_hold)
    np.testing.assert_allclose(rows[:, 2], yaw_dot, atol=1e-12)
    np.testing.assert_allclose(rows[:, [1, 3]], 0.0, atol=0)
    g = np.asarray([0.0, 9.8, 0.0])
    f = np.stack([_yaw_R(a).T @ (acc[k] - g) for k, a in enumerate(yaw)])
    np.testing.assert_allclose(rows[:, 4:7], f, atol=1e-12)
    h = 1e-4
    tau = np.asarray([0.3, 1.1, 1.7])
    p = [scene.path(spec, tau + d)[0][:, 0] for d in (-h, 0.0, h)]
    np.testing.assert_allclose((p[0] - 2 * p[1] + p[2]) / h ** 2,
                               scene.path(spec, tau)[1][:, 0], rtol=1e-5)


def test_imu_noise_density_and_seed():
    spec = scene.PathSpec(0.15, 0.5, 0.03, 0.5)
    a = scene.imu_samples(spec, 0.0, 0.0, 200.0, 1.0, 1.6968e-4, 2.0e-3,
                          np.random.default_rng(9))
    b = scene.imu_samples(spec, 0.0, 0.0, 200.0, 1.0, 1.6968e-4, 2.0e-3,
                          np.random.default_rng(9))
    clean = scene.imu_samples(spec, 0.0, 0.0, 200.0, 1.0, 0.0, 0.0,
                              np.random.default_rng(9))
    np.testing.assert_array_equal(a, b)
    noise = a[:, 1:] - clean[:, 1:]
    sd = noise.std(axis=0)
    np.testing.assert_allclose(sd[:3], 1.6968e-4 * np.sqrt(200), rtol=0.05)
    np.testing.assert_allclose(sd[3:], 2.0e-3 * np.sqrt(200), rtol=0.05)


def test_scene_seed_is_stable_and_in_range():
    s = [scene.scene_seed(2 ** 31 + 17, b) for b in range(16)]
    assert len(set(s)) == 16
    assert all(0 <= x < 2 ** 31 - 2000 for x in s)
    assert s == [scene.scene_seed(2 ** 31 + 17, b) for b in range(16)]
    assert torch.equal(
        scene.render(s[0], np.zeros((1, 3)), np.eye(3)[None], width=20,
                     height=12, zf=10.0, cx=10.0, cy=6.0, device="cpu"),
        scene.render(s[0], np.zeros((1, 3)), np.eye(3)[None], width=20,
                     height=12, zf=10.0, cx=10.0, cy=6.0, device="cpu"))
