"""The port's EuRoC input path against the JAX package's: the PNG codec
(against PIL), the dataset readers and IMU windows, the undistortion map
and its application, and `run_vo` end to end on the CPU, `--euroc --imu`
on a small `write_euroc_vi` directory and `--synthetic` with the
config's distortion on.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rebvo_tpu.core.geometry import CameraModel as JCam
from rebvo_tpu.io import dataset as jds
from rebvo_tpu.io.undistort import apply_undistort as j_apply
from rebvo_tpu.io.undistort import build_undistort_map as j_build
from rebvo_tpu_torch.config import REBVOParameters, save_config
from rebvo_tpu_torch.core.geometry import CameraModel as TCam
from rebvo_tpu_torch.io import dataset as tds
from rebvo_tpu_torch.io.png import read_png, write_png
from rebvo_tpu_torch.io.render import write_euroc_vi
from rebvo_tpu_torch.io.trajectory import ate_rmse, read_tum
from rebvo_tpu_torch.io.undistort import apply_undistort as t_apply
from rebvo_tpu_torch.io.undistort import build_undistort_map as t_build

torch.set_num_threads(2)

# a small EuRoC-like camera: the default config's distortion and focal
# ratios at 188x120
SMALL_CAM = dict(ImageWidth=188, ImageHeight=120, ZfX=114.66, ZfY=114.32,
                 PPx=91.8, PPy=62.1)
SMALL_RUN = dict(SMALL_CAM, KeylineMax=2048, MaxPoints=2048,
                 ReferencePoints=800, TrackPoints=2048,
                 GlobalMatchThreshold=100, DetectorThresh=0.03,
                 DetectorAutoGain=1e-6, InitBiasFrameNum=4, UsePallas=0)


# ---------------------------------------------------------------------------
# PNG codec
# ---------------------------------------------------------------------------


def _image(kind, rng, shape=(23, 37)):
    ch = {"grey": (), "rgb": (3,), "rgba": (4,)}[kind[:-2].rstrip("_")]
    hi = 65536 if kind.endswith("16") else 256
    return rng.integers(0, hi, shape + ch).astype(
        np.uint16 if hi > 256 else np.uint8)


KINDS = ["grey_8", "grey_16", "rgb_8", "rgb_16", "rgba_8", "rgba_16"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_roundtrip_every_filter(tmp_path, kind, ftype):
    """The writer's rows, filtered by each of the five filters, decode to
    the same samples; PIL reads the file to the same samples too (to its
    8-bit view where PIL holds 16-bit colour as 8 bits)."""
    img = _image(kind, np.random.default_rng(ftype))
    path = str(tmp_path / "a.png")
    write_png(path, img, filter_type=ftype)
    got = read_png(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    pil = np.asarray(Image.open(path))
    if kind in ("rgb_16", "rgba_16"):
        np.testing.assert_array_equal(pil, (img >> 8).astype(np.uint8))
    else:
        np.testing.assert_array_equal(pil, img)


@pytest.mark.parametrize("kind", ["grey_8", "grey_16", "rgb_8", "rgba_8"])
def test_png_reads_pil_files(tmp_path, kind):
    """Files written by PIL (its own filter choice) decode exactly; the
    kinds PIL cannot write (16-bit colour) come from the port's writer
    above."""
    img = _image(kind, np.random.default_rng(7), (31, 45))
    path = str(tmp_path / "p.png")
    Image.fromarray(img).save(path)
    np.testing.assert_array_equal(read_png(path), img)


def test_png_refuses_what_it_cannot_read(tmp_path):
    path = str(tmp_path / "pal.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(path)
    with pytest.raises(ValueError, match="palette"):
        read_png(path)
    path = str(tmp_path / "la.png")
    Image.fromarray(np.zeros((4, 4, 2), np.uint8), "LA").save(path)
    with pytest.raises(ValueError, match="grey\\+alpha"):
        read_png(path)
    # PIL writes no interlaced PNG: set the IHDR's interlace byte
    import struct
    import zlib
    path = str(tmp_path / "inter.png")
    write_png(path, np.zeros((9, 9), np.uint8))
    data = bytearray(open(path, "rb").read())
    data[28] = 1                                  # IHDR interlace method
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(path, "wb").write(bytes(data))
    assert Image.open(path).info.get("interlace") == 1
    with pytest.raises(ValueError, match="interlaced"):
        read_png(path)


@pytest.mark.parametrize("kind", ["grey_8", "grey_16", "rgb_8", "rgba_8"])
def test_load_frame_matches_jax(tmp_path, kind):
    """load_frame gives the JAX package's (PIL-based) intensities: grey
    x3, RGB summed, 16-bit /257 after that; exact."""
    img = _image(kind, np.random.default_rng(3), (20, 30))
    path = str(tmp_path / "f.png")
    write_png(path, img)
    a = jds.load_frame(path)
    b = tds.load_frame(path)
    assert b.dtype == np.float32 and b.shape == (20, 30)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Readers, IMU windows, sequences
# ---------------------------------------------------------------------------


def _euroc_dir(tmp_path, n=6, with_pair=False, drop=()):
    """A tiny EuRoC mav0 tree: cam0 (and cam1 with frames `drop`
    missing), IMU at 200 Hz with gx encoding the sample index."""
    mav = tmp_path / "mav0"
    rng = np.random.default_rng(0)
    for cam in ("cam0", "cam1") if with_pair else ("cam0",):
        d = mav / cam / "data"
        d.mkdir(parents=True)
        lines = ["#timestamp [ns],filename"]
        for i in range(n):
            if cam == "cam1" and i in drop:
                continue
            ns = 1_000_000_000 + i * 50_000_000 + (3 if cam == "cam1" else 0)
            write_png(str(d / f"{ns}.png"),
                      rng.integers(0, 256, (12, 16)).astype(np.uint8))
            lines.append(f"{ns},{ns}.png")
        (mav / cam / "data.csv").write_text("\n".join(lines) + "\n")
    (mav / "imu0").mkdir()
    lines = ["#t,gx,gy,gz,ax,ay,az"]
    for k in range(n * 10 + 5):
        ns = 1_000_000_000 - 25_000_000 + k * 5_000_000
        lines.append(f"{ns},{k},{0.01 * k},-0.5,0.1,-9.8,{0.02 * k}")
    (mav / "imu0" / "data.csv").write_text("\n".join(lines) + "\n")
    return str(mav)


def test_readers_match_jax(tmp_path):
    mav = _euroc_dir(tmp_path)
    csv, img_dir = os.path.join(mav, "cam0", "data.csv"), \
        os.path.join(mav, "cam0", "data")
    a = jds.read_image_list(csv, img_dir)
    b = tds.read_image_list(csv, img_dir)
    assert [(r.t, r.path) for r in a] == [(r.t, r.path) for r in b]
    imu_csv = os.path.join(mav, "imu0", "data.csv")
    np.testing.assert_array_equal(jds.read_euroc_imu(imu_csv),
                                  tds.read_euroc_imu(imu_csv))
    se3 = tmp_path / "se3.csv"
    se3.write_text("0,-1,0, 1,0,0, 0,0,1, 0.1,-0.2,0.3\n")
    for x, y in zip(jds.read_cam_imu_se3(str(se3)),
                    tds.read_cam_imu_se3(str(se3))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("desinc", [0.0, 0.012])
@pytest.mark.parametrize("window", [4, 16])
def test_slice_imu_windows_match_jax(tmp_path, desinc, window):
    """Windows of the same samples: gyro/accel/count equal, tsample the
    same float32 median spacing; truncation at `window` and the
    TimeDesinc offset included."""
    imu = tds.read_euroc_imu(os.path.join(_euroc_dir(tmp_path), "imu0",
                                          "data.csv"))
    ts = [1.0 + 0.05 * i for i in range(6)]
    a = jds.slice_imu_windows(imu, ts, window, desinc)
    b = tds.slice_imu_windows(imu, ts, window, desinc)
    assert len(a) == len(b) == 6
    for wa, wb in zip(a, b):
        for f in wa._fields:
            x, y = np.asarray(getattr(wa, f)), getattr(wb, f).numpy()
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_imu_window_size_matches_jax():
    from rebvo_tpu.config import REBVOParameters as JP
    for kw in ({}, dict(config_fps=30.0), dict(SampleTime=0.005),
               dict(config_fps=200.0)):
        assert jds.imu_window_size(JP().replace(**kw)) == \
            tds.imu_window_size(REBVOParameters().replace(**kw))


def _items(seq):
    return [tuple(np.asarray(x) if x is not None and not hasattr(x, "gyro")
                  else x for x in item) for item in seq]


@pytest.mark.parametrize("mode", ["mono", "imu", "pair_dropout"])
def test_dataset_sequence_matches_jax(tmp_path, mode):
    """DatasetSequence.euroc yields the same (t, frame, window[, pair])
    items as the JAX package's, with the cam1 pairing's dropout rule (a
    frame with no pair frame within half a period gets None)."""
    stereo = mode == "pair_dropout"
    mav = _euroc_dir(tmp_path, with_pair=stereo, drop=(2, 3))
    kw = dict(with_imu=mode != "mono", stereo=stereo, window_size=16)
    if stereo:
        with pytest.warns(UserWarning, match="dropouts"):
            a = _items(jds.DatasetSequence.euroc(mav, **kw))
        with pytest.warns(UserWarning, match="dropouts"):
            b = _items(tds.DatasetSequence.euroc(mav, **kw))
    else:
        a = _items(jds.DatasetSequence.euroc(mav, **kw))
        b = _items(tds.DatasetSequence.euroc(mav, **kw))
    assert len(a) == len(b) == 6
    for ia, ib in zip(a, b):
        assert len(ia) == len(ib) == (4 if stereo else 3)
        assert ia[0] == ib[0]
        np.testing.assert_array_equal(ia[1], ib[1])
        if mode == "mono":
            assert ia[2] is None and ib[2] is None
        else:
            np.testing.assert_array_equal(np.asarray(ia[2].gyro),
                                          ib[2].gyro.numpy())
            assert int(ia[2].count) == int(ib[2].count)
        if stereo:
            assert (ia[3] is None) == (ib[3] is None)
            if ia[3] is not None:
                np.testing.assert_array_equal(ia[3], ib[3])
    if stereo:
        assert [x[3] is None for x in b] == [False, False, True, True,
                                            False, False]


def test_dataset_from_params_matches_jax(tmp_path):
    from rebvo_tpu.config import REBVOParameters as JP
    mav = _euroc_dir(tmp_path)
    kw = dict(DataSetFile=os.path.join(mav, "cam0", "data.csv"),
              DataSetDir=os.path.join(mav, "cam0", "data"), ImuMode=2,
              ImuFile=os.path.join(mav, "imu0", "data.csv"),
              TimeDesinc=0.004)
    a = _items(jds.DatasetSequence.from_params(JP().replace(**kw)))
    b = _items(tds.DatasetSequence.from_params(
        REBVOParameters().replace(**kw)))
    for ia, ib in zip(a, b):
        assert ia[0] == ib[0]
        np.testing.assert_array_equal(ia[1], ib[1])
        np.testing.assert_array_equal(np.asarray(ia[2].accel),
                                      ib[2].accel.numpy())


# ---------------------------------------------------------------------------
# Undistortion
# ---------------------------------------------------------------------------


def _cams(**kw):
    p = REBVOParameters().replace(**kw)
    args = (p.ZfX, p.ZfY, p.PPx, p.PPy, p.KcR2, p.KcR4, p.KcR6, p.KcP1,
            p.KcP2, p.ImageWidth, p.ImageHeight)
    return JCam.make(*args), TCam.make(*args)


@pytest.mark.parametrize("size", ["small", "euroc"])
def test_undistort_map_and_apply_match_jax(size):
    """The map's source coordinates within 2e-4 px (float32 rounding of
    the same expression in another order), and the resampled frame
    within 0.05 on the 0-765 scale (2e-4 px times the steepest step of
    a random image)."""
    kw = SMALL_CAM if size == "small" else {}
    jc, tc = _cams(**kw)
    a, b = j_build(jc), t_build(tc, device="cpu")
    for f in ("src_x", "src_y"):
        np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                   getattr(b, f).numpy(), atol=2e-4,
                                   rtol=0)
    img = np.random.default_rng(1).uniform(
        0, 765, (2, tc.height, tc.width)).astype(np.float32)
    ja = np.asarray(j_apply(a, jnp.asarray(img)))
    tb = t_apply(b, torch.as_tensor(img)).numpy()
    assert tb.shape == img.shape
    np.testing.assert_allclose(ja, tb, atol=0.05, rtol=0)
    # on the port's own map, the port's apply is JAX's apply
    tj = np.asarray(j_apply(type(a)(jnp.asarray(b.src_x.numpy()),
                                    jnp.asarray(b.src_y.numpy())),
                            jnp.asarray(img)))
    np.testing.assert_allclose(tj, tb, atol=1e-3, rtol=0)


def test_write_euroc_vi_undistorts_to_the_pinhole_view(tmp_path):
    """write_euroc_vi's distortion is the exact inverse of the camera's:
    undistorting its first frame lands within 3 grey levels (x3) of the
    same scene rendered by the ideal pinhole camera, inside the frame."""
    from rebvo_tpu_torch.io.render import render_billboards_seq
    p = REBVOParameters().replace(**SMALL_CAM)
    write_euroc_vi(p, 2, str(tmp_path / "mav0"))
    seq = tds.DatasetSequence.euroc(str(tmp_path / "mav0"), window_size=64)
    t, frame, win = next(iter(seq))
    und = t_apply(t_build(TCam.from_params(p), device="cpu"),
                  torch.as_tensor(frame)).numpy()
    ref = render_billboards_seq(1, width=p.ImageWidth, height=p.ImageHeight,
                                zf=p.zf_mean, cx=p.PPx, cy=p.PPy, ss=1)[0]
    inner = (slice(10, -10), slice(10, -10))
    err = np.abs(und - ref)[inner]
    assert np.median(err) < 3.0 * 3, np.median(err)
    assert int(win.count) == 21 and win.gyro.shape == (64, 3)


def test_write_euroc_vi_imu_is_the_path_derivative(tmp_path):
    """The IMU that write_euroc_vi writes is the exact derivative of its
    camera path: vi_lateral_path's acceleration and yaw rate against
    central differences of its position and yaw (1e-4 s steps, within
    1e-4), zero velocity and acceleration where the motion starts (no
    jump the accelerometer sees and the camera does not), and the written
    samples R^T (a_w - g_w) and (0, yaw', 0) to the 9 printed digits."""
    from rebvo_tpu_torch.io.render import (IMU_HZ, T0_NS, _yaw_R,
                                           vi_lateral_path)
    t_hold, h = 0.3, 1e-4
    t = np.linspace(0.0, 3.0, 301)
    pos, acc, yaw, yaw_dot = vi_lateral_path(t, t_hold)
    p_hi, _, y_hi, _ = vi_lateral_path(t + h, t_hold)
    p_lo, _, y_lo, _ = vi_lateral_path(t - h, t_hold)
    np.testing.assert_allclose((p_hi - 2 * pos + p_lo) / h ** 2, acc,
                               atol=1e-4)
    np.testing.assert_allclose((y_hi - y_lo) / (2 * h), yaw_dot, atol=1e-4)
    at = np.asarray([t_hold, t_hold + 1e-6])
    p0, a0, _, w0 = vi_lateral_path(at, t_hold)
    np.testing.assert_allclose(np.diff(p0, axis=0) / 1e-6, 0.0, atol=1e-6)
    np.testing.assert_allclose(a0, 0.0, atol=1e-6)
    np.testing.assert_allclose(w0, 0.0, atol=1e-6)
    assert np.ptp(pos[:, 0]) > 0.2 and np.abs(acc[:, 0]).max() > 1.0

    p = REBVOParameters().replace(**SMALL_CAM)
    write_euroc_vi(p, 2, str(tmp_path / "mav0"))
    imu = tds.read_euroc_imu(str(tmp_path / "mav0" / "imu0" / "data.csv"))
    tk = imu[:, 0] - T0_NS * 1e-9
    np.testing.assert_allclose(np.diff(tk), 1.0 / IMU_HZ, atol=1e-9)
    _, ak, yk, wk = vi_lateral_path(tk, (p.InitBiasFrameNum + 2) /
                                    p.config_fps)
    f = np.stack([_yaw_R(y).T @ (a - [0.0, 9.8, 0.0])
                  for y, a in zip(yk, ak)])
    np.testing.assert_allclose(imu[:, 4:7], f, atol=1e-9)
    np.testing.assert_allclose(imu[:, 2], wk, atol=1e-9)
    np.testing.assert_array_equal(imu[:, [1, 3]], 0.0)


# ---------------------------------------------------------------------------
# run_vo of both packages
# ---------------------------------------------------------------------------


def _run_both(tmp_path, monkeypatch, args, params):
    from rebvo_tpu.apps import run_vo as jrv
    from rebvo_tpu_torch.apps import run_vo as trv
    cfg = str(tmp_path / "run.cfg")
    save_config(params, cfg)
    monkeypatch.setenv("REBVO_COMPILE_CACHE", str(tmp_path / "jax_cache"))
    jrv.main(["--cpu", "--config", cfg, "--out-dir", str(tmp_path / "j")]
             + args)
    trv.main(["--cpu", "--config", cfg, "--out-dir", str(tmp_path / "t")]
             + args)
    return (read_tum(str(tmp_path / "j" / params.TrayFile)),
            read_tum(str(tmp_path / "t" / params.TrayFile)))


def test_run_vo_euroc_imu_matches_jax(tmp_path, monkeypatch):
    """run_vo --cpu --euroc DIR --imu of both packages on 40 frames of a
    small write_euroc_vi directory (188x120, EuRoC distortion,
    InitBiasFrameNum=4: the filter runs from frame 9, and the path moves
    from frame 6): the same timestamps, Pos within 5% of the path's
    extent per frame, and the similarity-aligned ATE between them under
    2% of it (measured 0.4% and 0.08%). Both recover the written path's
    metric scale over the filtered frames: the rigidly aligned ATE under
    10% of the path's extent and the similarity alignment's scale within
    10% of 1 (measured 5% and 0.97 in both)."""
    from rebvo_tpu_torch.io.trajectory import align_umeyama
    n = 40
    p = REBVOParameters().replace(**SMALL_RUN)
    _, pos_true = write_euroc_vi(p, n, str(tmp_path / "mav0"))
    (tj, pj, _), (tt, pt, qt) = _run_both(
        tmp_path, monkeypatch, ["--euroc", str(tmp_path / "mav0"), "--imu"],
        p)
    assert len(tt) == n - 1
    np.testing.assert_array_equal(tj, tt)
    assert np.all(np.isfinite(pt)) and np.all(np.isfinite(qt))
    ext = np.linalg.norm(pj.max(0) - pj.min(0))
    assert ext > 0
    np.testing.assert_allclose(pt, pj, atol=0.05 * ext, rtol=0)
    assert ate_rmse(pt, pj, with_scale=True) < 0.02 * ext
    on = 5 + p.InitBiasFrameNum
    truth = pos_true[on:]
    t_ext = np.ptp(truth, axis=0).max()
    for est in (pj[on - 1:], pt[on - 1:]):
        assert ate_rmse(est, truth, with_scale=False) < 0.1 * t_ext
        assert abs(align_umeyama(est, truth)[0] - 1.0) < 0.1


def test_run_vo_synthetic_distorted_matches_jax(tmp_path, monkeypatch):
    """run_vo --cpu --synthetic 6 of both packages, the config's
    distortion on (UseUndistort=1, EuRoC coefficients): the JAX run_vo
    undistorts every synthetic frame, so the port must too. Pos within
    1% of the path's extent per frame (measured 0.4%: the two maps differ
    by up to 2e-4 px, the resampled frames by up to 0.05), orientation
    quaternions within 1e-3."""
    p = REBVOParameters().replace(**SMALL_RUN)
    (tj, pj, qj), (tt, pt, qt) = _run_both(tmp_path, monkeypatch,
                                           ["--synthetic", "6"], p)
    assert len(tt) == 5
    np.testing.assert_array_equal(tj, tt)
    ext = np.linalg.norm(pj.max(0) - pj.min(0))
    assert ext > 0
    np.testing.assert_allclose(pt, pj, atol=0.01 * ext, rtol=0)
    np.testing.assert_allclose(qt, qj, atol=1e-3, rtol=0)


def test_run_vo_euroc_without_cuda_exits(tmp_path, monkeypatch):
    """No fallback hides the card: run_vo --euroc DIR --imu without --cpu
    on a machine with no CUDA device exits with an error."""
    from rebvo_tpu_torch.apps import run_vo as trv
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mav = _euroc_dir(tmp_path)
    with pytest.raises(SystemExit, match="no CUDA device"):
        trv.main(["--euroc", mav, "--imu", "--out-dir", str(tmp_path)])
