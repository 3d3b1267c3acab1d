"""Edge-map telemetry channel (PyTorch counterpart of
rebvo_tpu/io/telemetry.py; the same packets, byte for byte).

Functional replacement for the reference's third-thread network output
(reference src/CommLib/net_keypoint.* + edgemap_com.*, sent by
rebvo_third_t.cpp:192-236): per-frame packets carrying the nav state and
the quantized edge map, streamed fire-and-forget over the native
fragmented-UDP transport with a CRC16 integrity word.

Packet layout (little endian):
    u32  magic 'RVTP'
    u32  frame id
    u16  width, height
    u32  keyline count
    f32  k_scale
    f32[3]  Pos
    f32[9]  Pose (row major)
    f32  t
    u16  crc16 of the keyline payload
    u16  reserved
    keyline records (io.native wire format)
    [optional video section: u16 magic 'VD', u16 encoder type,
     u32 byte length, encoded frame — the reference streams the encoded
     camera frame in the same channel (rebvo_third_t.cpp:223-236)]

`EdgeMapSender.send` takes the port's KeylineMap and nav values as
tensors on any device and moves them to the host in one transfer
(`frontend/state.keylines_to_host`); the EdgeMapDelay ring holds host
copies, so a later step that reuses the state's buffers cannot change a
held frame.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from rebvo_tpu_torch.frontend.state import keylines_to_host
from rebvo_tpu_torch.io import native

_MAGIC = 0x52565450  # 'RVTP'
_HDR = struct.Struct("<IIHHIf3f9ffHH")
_VMAGIC = 0x5644     # 'VD'
_VHDR = struct.Struct("<HHI")


def pack_edgemap(frame_id: int, width: int, height: int, klm, k_scale: float,
                 pos, pose, t: float, video: bytes = None,
                 video_etype: int = 0) -> bytes:
    """One packet. `klm` is a KeylineMap (tensors or numpy) or a
    `keylines_to_host` dict of native.WIRE_FIELDS; pos and pose are host
    arrays."""
    payload, n = native.quantize_keylines(klm, k_scale)
    crc = native.crc16(payload)
    pos = np.asarray(pos, np.float32)
    pose = np.asarray(pose, np.float32).reshape(-1)
    hdr = _HDR.pack(_MAGIC, frame_id, width, height, n, float(k_scale),
                    *pos.tolist(), *pose.tolist(), float(t), crc, 0)
    pkt = hdr + payload
    if video is not None:
        pkt += _VHDR.pack(_VMAGIC, video_etype, len(video)) + video
    return pkt


def unpack_edgemap(data: bytes) -> Optional[dict]:
    if len(data) < _HDR.size:
        return None
    fields = _HDR.unpack_from(data)
    if fields[0] != _MAGIC:
        return None
    (_, frame_id, width, height, n, k_scale) = fields[:6]
    pos = np.asarray(fields[6:9], np.float32)
    pose = np.asarray(fields[9:18], np.float32).reshape(3, 3)
    t = fields[18]
    crc = fields[19]
    rec = native.net_keyline_size()
    payload = data[_HDR.size:_HDR.size + n * rec]
    if len(payload) < n * rec or native.crc16(payload) != crc:
        return None                     # corrupted: drop (lossy channel)
    kls = native.dequantize_keylines(payload, k_scale)
    video = None
    video_etype = None
    rest = data[_HDR.size + n * rec:]
    if len(rest) >= _VHDR.size:
        vmagic, etype, vlen = _VHDR.unpack_from(rest)
        if vmagic == _VMAGIC and len(rest) >= _VHDR.size + vlen:
            video = rest[_VHDR.size:_VHDR.size + vlen]
            video_etype = etype
    return dict(frame_id=frame_id, width=width, height=height, n=n,
                k_scale=k_scale, Pos=pos, Pose=pose, t=t, keylines=kls,
                video=video, video_etype=video_etype)


class EdgeMapSender:
    """Streams per-frame edge maps (+ optionally the encoded camera
    frame) to a remote viewer (VideoNetHost/Port semantics)."""

    def __init__(self, host: str, port: int, width: int, height: int,
                 video_etype: int = None, edgemap_delay: int = 0):
        self.port = native.UdpPort(host, port)
        self.width = width
        self.height = height
        self.frame_id = 0
        self.encoder = None
        if video_etype is not None:
            from rebvo_tpu_torch.io.video import make_encoder
            self.encoder = make_encoder(video_etype, width, height)
        # EdgeMapDelay ring (rebvo_third_t.cpp:71-83,192-236): a hardware
        # encoder (the reference's MFC) emits the compressed frame
        # EdgeMapDelay frames late, so the keyline payload is held back
        # the same number of frames to stay in sync with the video it is
        # drawn over.
        self.edgemap_delay = max(0, int(edgemap_delay))
        self._delay_ring: list = []

    def send(self, klm, k_scale, pos, pose, t, frame=None) -> int:
        """Queue this frame's edge map and send the one EdgeMapDelay
        frames old. Returns the fragments sent, 0 while the ring fills,
        -1 when the socket refused a fragment (the channel is lossy)."""
        video = etype = None
        if self.encoder is not None and frame is not None:
            self.encoder.push_frame(frame)
            video = self.encoder.pop_frame()
            etype = self.encoder.encoder_type
        h = keylines_to_host(klm, native.WIRE_FIELDS,
                             extra=(k_scale, pos, pose, t))
        e = h.pop("extra")
        self._delay_ring.append((h, e[0], e[1:4], e[4:13], e[13]))
        if len(self._delay_ring) <= self.edgemap_delay:
            return 0            # ring still filling: nothing to pair yet
        d_klm, d_k, d_pos, d_pose, d_t = self._delay_ring.pop(0)
        pkt = pack_edgemap(self.frame_id, self.width, self.height, d_klm,
                           d_k, d_pos, d_pose, d_t,
                           video=video, video_etype=etype or 0)
        self.frame_id += 1
        return self.port.send(pkt)

    def close(self):
        self.port.close()


class EdgeMapReceiver:
    def __init__(self, host: str, port: int):
        self.port = native.UdpPort(host, port, bind=True)

    def recv(self, timeout_ms: int = 1000) -> Optional[dict]:
        data = self.port.recv(timeout_ms=timeout_ms)
        if data is None:
            return None
        return unpack_edgemap(data)

    def close(self):
        self.port.close()
