"""Video encoders/decoders for the telemetry and logging planes.

The reference carries an encoded camera frame alongside every edge-map
packet and can buffer the encoded stream to disk (rebvo_third_t.cpp
:223-256, flushed at exit :351-366). Its three encoders share one
interface (include/VideoLib/video_encoder.h:31-48): RAW (identity copy,
src/VideoLib/video_encoder.cpp:40-60), MJPEG (per-frame JPEG via libgd,
src/VideoLib/video_mjpeg.cpp:29-80) and MFC (Samsung Exynos hardware
MPEG4, src/VideoLib/video_mfc.cpp — device-specific, not reproducible
off that SoC). The visualizer side decodes with libav
(src/VideoLib/videodecoder.cpp:35-140).

Here: the same push/pop interface and wire type codes, with PIL as the
JPEG codec (import-gated — everything else in this module works without
it). Frames are the framework's RGB-sum grayscale floats (0..765,
image.h:195-202 semantics); codecs convert to/from uint8 internally.
A concatenated-JPEG file is a valid MJPEG stream, matching the
reference's VideoSave output semantics.

PyTorch counterpart of rebvo_tpu/io/video.py: the same classes and wire
format. A frame may also be a tensor on any device; it is converted to
uint8 where it lies and moved to the host once, as uint8.
"""

from __future__ import annotations

import io as _io
import struct
from collections import deque
from typing import Iterator, Optional

import numpy as np
import torch

# Wire codes (video_encoder.h:31) — embedded in telemetry headers.
VIDEO_ENCODER_TYPE_RAW = 0x00
VIDEO_ENCODER_TYPE_MJPEG = 0x01
VIDEO_ENCODER_TYPE_MFC = 0x02


def _to_u8(frame) -> np.ndarray:
    """Grayscale float (0..765 RGB-sum scale) or uint8 -> uint8 [H, W]
    (a tensor: the same float32 operations where it lies, then one copy
    of the uint8 image to the host)."""
    if isinstance(frame, torch.Tensor):
        if frame.dtype != torch.uint8:
            frame = torch.clamp(frame.to(torch.float32) / 3.0 + 0.5, 0,
                                255).to(torch.uint8)
        return frame.cpu().numpy()
    arr = np.asarray(frame)
    if arr.dtype == np.uint8:
        return arr
    return np.clip(np.asarray(arr, np.float32) / 3.0 + 0.5,
                   0, 255).astype(np.uint8)


def _from_u8(arr: np.ndarray) -> np.ndarray:
    return np.asarray(arr, np.float32) * 3.0


class VideoEncoder:
    """RAW identity encoder: PushFrame copies, PopFrame hands the bytes
    back (video_encoder.cpp:40-60)."""

    encoder_type = VIDEO_ENCODER_TYPE_RAW

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self._q: deque = deque()

    def push_frame(self, frame) -> None:
        self._q.append(_to_u8(frame).tobytes())

    def pop_frame(self) -> Optional[bytes]:
        return self._q.popleft() if self._q else None


class MJPEGEncoder(VideoEncoder):
    """Per-frame JPEG (video_mjpeg.cpp:29-80; libgd -> PIL)."""

    encoder_type = VIDEO_ENCODER_TYPE_MJPEG

    def __init__(self, width: int, height: int, quality: int = 90):
        super().__init__(width, height)
        from PIL import Image  # gated: only MJPEG needs PIL
        self._Image = Image
        self.quality = quality

    def push_frame(self, frame) -> None:
        buf = _io.BytesIO()
        self._Image.fromarray(_to_u8(frame), mode="L").save(
            buf, format="JPEG", quality=self.quality)
        self._q.append(buf.getvalue())


class EncoderMFC:
    """The reference's Exynos hardware encoder (video_mfc.cpp) has no
    equivalent off that SoC; constructing it states so explicitly."""

    encoder_type = VIDEO_ENCODER_TYPE_MFC

    def __init__(self, *a, **k):
        raise NotImplementedError(
            "EncoderMFC is Samsung-Exynos V4L2 M2M hardware; use "
            "MJPEGEncoder or VideoEncoder (raw) on this platform")


def make_encoder(etype: int, width: int, height: int, **kw):
    if etype == VIDEO_ENCODER_TYPE_RAW:
        return VideoEncoder(width, height)
    if etype == VIDEO_ENCODER_TYPE_MJPEG:
        return MJPEGEncoder(width, height, **kw)
    if etype == VIDEO_ENCODER_TYPE_MFC:
        return EncoderMFC()
    raise ValueError(f"unknown encoder type {etype}")


class VideoDecoder:
    """Decode one telemetry payload back to the float grayscale frame
    (videodecoder.cpp:35-140 role; RAW + MJPEG)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height

    def decode(self, data: bytes, etype: int) -> np.ndarray:
        if etype == VIDEO_ENCODER_TYPE_RAW:
            arr = np.frombuffer(data, np.uint8).reshape(
                self.height, self.width)
            return _from_u8(arr)
        if etype == VIDEO_ENCODER_TYPE_MJPEG:
            from PIL import Image
            img = Image.open(_io.BytesIO(data)).convert("L")
            return _from_u8(np.asarray(img))
        raise ValueError(f"cannot decode encoder type {etype}")


# ---------------------------------------------------------------------------
# Encoded-stream file (the VideoSave RAM buffer -> file path,
# rebvo_third_t.cpp:249-256,351-366). Length-prefixed packets keep RAW
# and MJPEG streams in one container; an MJPEG stream concatenation is
# also exported for standard players.

_PKT = struct.Struct("<dBI")  # t, encoder type, payload size


class VideoStreamWriter:
    def __init__(self, path: str, width: int, height: int):
        self.fh = open(path, "wb")
        self.fh.write(struct.pack("<4sII", b"RVV1", width, height))
        self.count = 0

    def write(self, t: float, data: bytes, etype: int) -> None:
        self.fh.write(_PKT.pack(float(t), etype, len(data)))
        self.fh.write(data)
        self.count += 1

    def close(self) -> None:
        self.fh.close()


def read_video_stream(path: str) -> Iterator[tuple]:
    """Yields (t, etype, payload) packets; pair with VideoDecoder."""
    with open(path, "rb") as fh:
        magic, w, h = struct.unpack("<4sII", fh.read(12))
        if magic != b"RVV1":
            raise ValueError(f"not a video stream: {path}")
        while True:
            hdr = fh.read(_PKT.size)
            if len(hdr) < _PKT.size:
                return
            t, etype, size = _PKT.unpack(hdr)
            yield t, etype, fh.read(size)


def stream_dims(path: str) -> tuple:
    with open(path, "rb") as fh:
        magic, w, h = struct.unpack("<4sII", fh.read(12))
        if magic != b"RVV1":
            raise ValueError(f"not a video stream: {path}")
    return w, h
