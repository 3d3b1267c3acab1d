"""run_vo --euroc DIR --stereo (with and without --imu) of both packages
on the CPU, on one small write_euroc_vi directory with a cam1 stream
(376x240, the default config's EuRoC intrinsics, distortion and
extrinsics scaled to that size, InitBiasFrameNum=4: the path moves from
frame 6, the scale filter runs from frame 9).

Both run_vo's run the separate scale-space and detector ops here
(UsePallas=0: the JAX package picks them off the TPU), whose keyline
counts differ by one now and then (ROADMAP queue 3); the stereo scale
carry and the VI filter grow such differences frame by frame, so the
trajectories are held to 2.5% of their extent, not 1% (measured 1.3%
stereo, 1.9% stereo + IMU, over 20 frames).
"""

import numpy as np
import pytest

from rebvo_tpu_torch.config import REBVOParameters, save_config
from rebvo_tpu_torch.io.render import write_euroc_vi
from rebvo_tpu_torch.io.trajectory import align_umeyama, ate_rmse, read_tum

N = 20
GAP = 0.025              # of the JAX trajectory's extent
HALF_CAM = dict(ImageWidth=376, ImageHeight=240, ZfX=229.327, ZfY=228.648,
                PPx=183.6075, PPy=124.1875, StereoZfX=228.7935,
                StereoZfY=228.067, StereoPPx=189.9995, StereoPPy=127.619,
                KeylineMax=8192, MaxPoints=8192, ReferencePoints=3000,
                TrackPoints=8192, InitBiasFrameNum=4, UsePallas=0)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("stereo_run_vo")
    p = REBVOParameters().replace(**HALF_CAM)
    _, pos_true = write_euroc_vi(p, N, str(d / "mav0"), workers=4,
                                 stereo=True)
    cfg = str(d / "run.cfg")
    save_config(p, cfg)
    return d, p, cfg, pos_true


@pytest.mark.parametrize("mode", [["--stereo"], ["--stereo", "--imu"]],
                         ids=["stereo", "stereo_imu"])
def test_run_vo_euroc_stereo_matches_jax(fixture_dir, mode, monkeypatch):
    """The same timestamps and N - 1 finite rows; Pos within 2.5% of the
    JAX trajectory's extent on every frame. Vision-only stereo recovers
    the written path's metric scale in both packages, with no scale
    fitted: the similarity alignment's scale within 10% of 1 (measured
    0.974 and 0.982) and the rigidly aligned ATE under 15% of the path's
    extent (measured 8.8% and 8.4%)."""
    from rebvo_tpu.apps import run_vo as jrv
    from rebvo_tpu_torch.apps import run_vo as trv
    d, p, cfg, pos_true = fixture_dir
    tag = "_".join(m[2:] for m in mode)
    monkeypatch.setenv("REBVO_COMPILE_CACHE", str(d / "jax_cache"))
    args = ["--cpu", "--config", cfg, "--euroc", str(d / "mav0")] + mode
    jrv.main(args + ["--out-dir", str(d / f"j_{tag}")])
    trv.main(args + ["--out-dir", str(d / f"t_{tag}")])
    tj, pj, _ = read_tum(str(d / f"j_{tag}" / p.TrayFile))
    tt, pt, qt = read_tum(str(d / f"t_{tag}" / p.TrayFile))
    assert len(tt) == N - 1
    np.testing.assert_array_equal(tj, tt)
    assert np.all(np.isfinite(pt)) and np.all(np.isfinite(qt))
    ext = np.linalg.norm(pj.max(0) - pj.min(0))
    assert ext > 0.05
    np.testing.assert_allclose(pt, pj, atol=GAP * ext, rtol=0)
    if mode == ["--stereo"]:
        on = p.InitBiasFrameNum + 2
        truth = pos_true[on + 1:]
        t_ext = np.ptp(truth, axis=0).max()
        for est in (pj[on:], pt[on:]):
            assert abs(align_umeyama(est, truth)[0] - 1.0) < 0.1
            assert ate_rmse(est, truth, with_scale=False) < 0.15 * t_ext
