"""Dataset readers: EuRoC / TUM image lists and EuRoC CSV IMU (PyTorch
counterpart of rebvo_tpu/io/dataset.py).

Replaces the reference's DataSetCam (src/VideoLib/datasetcam.cpp:32-240:
`timestamp,filename` CSV lists, grayscale replicated to RGB,
TimeScale=1e-9 for EuRoC nanoseconds) and ImuGrabber::LoadDataSet
(src/UtilLib/imugrabber.cpp:80-130: EuRoC `t,gx,gy,gz,ax,ay,az` CSV) on
the host, and packs the IMU samples into the fixed-size per-frame
windows the step consumes. Frames come back as numpy arrays and windows
as CPU tensors; the step moves both to its device. Images are decoded by
the port's own PNG codec (io/png.py), not PIL.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import warnings
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from rebvo_tpu_torch.frontend.imu import ImuWindow
from rebvo_tpu_torch.io.png import read_png


@dataclass
class FrameRecord:
    t: float
    path: str


def read_image_list(csv_path: str, image_dir: str,
                    time_scale: float = 1e-9) -> List[FrameRecord]:
    """Parse a EuRoC/TUM `timestamp,filename` list (datasetcam.cpp:32).

    Lines starting with '#' are comments; a missing filename column means
    the filename is `<timestamp>.png` (EuRoC layout).
    """
    records = []
    with open(csv_path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.replace(";", ",").split(",")]
            t = float(parts[0]) * time_scale
            fname = parts[1] if len(parts) > 1 and parts[1] else \
                f"{parts[0]}.png"
            records.append(FrameRecord(t=t, path=os.path.join(image_dir,
                                                              fname)))
    records.sort(key=lambda r: r.t)
    return records


def load_frame(path: str) -> np.ndarray:
    """Load an image as float32 [H, W] on the reference's RGB-sum
    intensity scale (Image::ConvertRGB2BW sums channels, image.h:195:
    grayscale datasets are replicated to RGB first, i.e. x3); 16-bit
    images are divided by 257 after that."""
    arr = read_png(path)
    if arr.ndim == 2:
        out = arr.astype(np.float32) * 3.0
    else:
        out = arr[..., :3].astype(np.float32).sum(axis=-1)
    if arr.dtype == np.uint16:
        out = out / 257.0
    return out


def read_euroc_imu(csv_path: str, time_scale: float = 1e-9) -> np.ndarray:
    """EuRoC IMU CSV -> array [N, 7]: t, gx, gy, gz, ax, ay, az
    (imugrabber.cpp:80: file stores gyro then accel)."""
    rows = []
    with open(csv_path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(";", ",").split(",")
            vals = [float(p) for p in parts[:7]]
            vals[0] *= time_scale
            rows.append(vals)
    arr = np.asarray(rows, np.float64)
    return arr[np.argsort(arr[:, 0])]


def read_cam_imu_se3(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Camera->IMU SE3 file: 12 comma/space-separated values, row-major
    R then T (ImuGrabber::LoadCamImuSE3, imugrabber.cpp:135-160)."""
    with open(path) as fh:
        txt = fh.read().replace(",", " ").split()
    vals = [float(v) for v in txt[:12]]
    R = np.asarray(vals[:9], np.float64).reshape(3, 3)
    T = np.asarray(vals[9:12], np.float64)
    return R, T


def slice_imu_windows(imu: np.ndarray, frame_times: List[float],
                      window_size: int = 32,
                      time_desinc: float = 0.0) -> List[ImuWindow]:
    """Pack per-frame IMU windows (CPU tensors) using the reference's
    search semantics (SeachByTimeStamp, imugrabber.cpp:174-210): samples
    with t_prev < t <= t_frame, both offset by `time_desinc`, at most
    `window_size` of them; `tsample` is the median sample spacing, in
    float32."""
    ts = np.median(np.diff(imu[:, 0])) if imu.shape[0] > 1 else 0.005
    windows = []
    t_prev = -np.inf
    for tf in frame_times:
        lo = imu[:, 0] > (t_prev + time_desinc)
        hi = imu[:, 0] <= (tf + time_desinc + 1e-12)
        sel = imu[lo & hi]
        n = min(sel.shape[0], window_size)
        gyro = np.zeros((window_size, 3), np.float32)
        accel = np.zeros((window_size, 3), np.float32)
        gyro[:n] = sel[:n, 1:4]
        accel[:n] = sel[:n, 4:7]
        windows.append(ImuWindow(
            gyro=torch.from_numpy(gyro), accel=torch.from_numpy(accel),
            count=torch.tensor(n, dtype=torch.int32),
            tsample=torch.tensor(ts, dtype=torch.float32)))
        t_prev = tf
    return windows


class DatasetSequence:
    """A replayable dataset sequence (frames + optional IMU windows),
    prefetching frames on host threads — the replacement for the
    reference's capture thread + Pipeline buffer."""

    def __init__(self, records: List[FrameRecord],
                 imu: Optional[np.ndarray] = None, window_size: int = 32,
                 time_desinc: float = 0.0,
                 records_pair: Optional[List[FrameRecord]] = None):
        self.records = records
        self.windows = (slice_imu_windows(imu, [r.t for r in records],
                                          window_size, time_desinc)
                        if imu is not None else None)
        # stereo pair frames, aligned to `records` by timestamp (EuRoC
        # cam0/cam1 are hardware-synchronised; the reference warns and
        # drops on mismatch, rebvo_first_t.cpp:185-200). A frame whose
        # nearest pair frame is more than half the frame period away
        # gets no pair (None).
        self.records_pair = None
        if records_pair:
            pair_ts = np.asarray([r.t for r in records_pair])
            cam_ts = np.asarray([r.t for r in records])
            max_dt = (np.inf if len(cam_ts) < 2 else
                      0.5 * float(np.median(np.diff(cam_ts))))
            self.records_pair = []
            warned = False
            for r in records:
                j = int(np.argmin(np.abs(pair_ts - r.t)))
                if abs(pair_ts[j] - r.t) > max_dt:
                    if not warned:
                        warnings.warn(
                            "stereo pair stream has temporal dropouts; "
                            "unmatched frames run mono")
                        warned = True
                    self.records_pair.append(None)
                else:
                    self.records_pair.append(records_pair[j])

    @property
    def stereo(self) -> bool:
        return self.records_pair is not None

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self) -> Iterator:
        """Yields (t, frame, imu_window|None) — or, for a stereo
        sequence, (t, frame, imu_window|None, frame_pair) — prefetching
        the next frame('s pair) on host threads."""

        def load(i):
            frame = load_frame(self.records[i].path)
            if self.records_pair is not None and \
                    self.records_pair[i] is not None:
                return frame, load_frame(self.records_pair[i].path)
            return frame, None

        with cf.ThreadPoolExecutor(max_workers=2) as pool:
            fut = pool.submit(load, 0)
            for i, rec in enumerate(self.records):
                frame, pair = fut.result()
                if i + 1 < len(self.records):
                    fut = pool.submit(load, i + 1)
                win = self.windows[i] if self.windows is not None else None
                if self.records_pair is not None:
                    yield rec.t, frame, win, pair
                else:
                    yield rec.t, frame, win

    @staticmethod
    def euroc(mav_dir: str, cam: str = "cam0",
              with_imu: bool = True, stereo: bool = False,
              window_size: int = 32,
              time_desinc: float = 0.0) -> "DatasetSequence":
        """Open a EuRoC `mav0` directory (the reference's
        GlobalConfig_EuRoC dataset layout); `stereo=True` also pairs the
        cam1 stream (DataSetDirStereo/DataSetFileStereo role)."""
        cam_dir = os.path.join(mav_dir, cam)
        records = read_image_list(os.path.join(cam_dir, "data.csv"),
                                  os.path.join(cam_dir, "data"))
        imu = None
        if with_imu:
            imu_csv = os.path.join(mav_dir, "imu0", "data.csv")
            if os.path.exists(imu_csv):
                imu = read_euroc_imu(imu_csv)
        records_pair = None
        if stereo:
            pair_dir = os.path.join(mav_dir, "cam1")
            records_pair = read_image_list(
                os.path.join(pair_dir, "data.csv"),
                os.path.join(pair_dir, "data"))
        return DatasetSequence(records, imu, window_size=window_size,
                               time_desinc=time_desinc,
                               records_pair=records_pair)

    @staticmethod
    def from_params(params) -> "DatasetSequence":
        """Open the dataset the config points at (DataSetDir/DataSetFile
        + stereo twin + IMU file), honouring TimeScale keys and sizing
        the per-frame IMU windows from the sample/frame rates."""
        records = read_image_list(params.DataSetFile, params.DataSetDir,
                                  time_scale=params.CamTimeScale)
        imu = None
        if params.ImuMode > 0 and params.ImuFile:
            imu = read_euroc_imu(params.ImuFile,
                                 time_scale=params.ImuTimeScale)
        records_pair = None
        if params.StereoAvaiable and params.DataSetFileStereo:
            records_pair = read_image_list(params.DataSetFileStereo,
                                           params.DataSetDirStereo,
                                           time_scale=params.CamTimeScale)
        return DatasetSequence(
            records, imu,
            window_size=imu_window_size(params),
            time_desinc=params.TimeDesinc,
            records_pair=records_pair)


def imu_window_size(params) -> int:
    """Static per-frame IMU window capacity: samples per frame interval
    (SampleTime vs FPS) padded with 50% slack, at least 8."""
    per_frame = (1.0 / max(params.config_fps, 1e-6)) / \
        max(params.SampleTime, 1e-6)
    return max(8, int(np.ceil(per_frame * 1.5)))
