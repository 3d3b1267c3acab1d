"""Compressed edge-map channel: chain -> 3-D line-segment compression.

Functional replacement for the reference's edgemap_com
(src/CommLib/edgemap_com.cpp:168-330): edge chains are walked, split
into runs, robust-fitted as 3-D segments in (x, y, inverse depth) space
and transmitted as quantized endpoints — an order-of-magnitude smaller
than the per-keyline format, for bandwidth-limited telemetry (the MAV
teleoperation path). Packets carry a CRC16 like the reference.

Wire record (10 bytes per endpoint, 2 endpoints per segment):
    u16 x*8, u16 y*8     endpoint position (1/8 px)
    u16 rho_q            inverse depth * (10000/k)
    u16 s_rho_q          uncertainty    * (10000/k)
    u16 reserved

PyTorch counterpart of rebvo_tpu/io/edgemap_compress.py (the same bytes
for the same edge map): the fits run in numpy on the host, so
`compress_edgemap` first moves the fields it reads to the host in one
transfer.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from rebvo_tpu_torch.core.linefitting import robust_fit_segment_3d
from rebvo_tpu_torch.frontend.state import keylines_to_host

_SEG = struct.Struct("<10H")     # two endpoints, 5 u16 each
_HDR = struct.Struct("<IIfHH")   # magic, nseg, k_scale, crc, reserved
_MAGIC = 0x52564345              # 'RVCE'

MAX_RUN = 24                     # points per fitted segment
MIN_RUN = 3


def _walk_chains(n_id: np.ndarray, p_id: np.ndarray,
                 valid: np.ndarray) -> List[np.ndarray]:
    """Extract chains (lists of keyline indices) following n_id links."""
    K = n_id.shape[0]
    visited = np.zeros(K, bool)
    heads = np.where(valid & ((p_id < 0) | ~valid[np.clip(p_id, 0, K - 1)]))[0]
    chains = []
    for h in heads:
        if visited[h]:
            continue
        chain = []
        i = h
        while i >= 0 and not visited[i] and valid[i]:
            visited[i] = True
            chain.append(i)
            i = n_id[i]
        if len(chain) >= MIN_RUN:
            chains.append(np.asarray(chain))
    return chains


def compress_edgemap(klm, k_scale: float) -> bytes:
    """Fit chain runs into segments and pack them with a CRC."""
    h = keylines_to_host(klm, ("valid", "x", "y", "rho", "s_rho", "n_id",
                               "p_id"))
    valid, n_id, p_id = h["valid"], h["n_id"], h["p_id"]
    x = np.asarray(h["x"], np.float64)
    y = np.asarray(h["y"], np.float64)
    rho = np.asarray(h["rho"], np.float64)
    s_rho = np.asarray(h["s_rho"], np.float64)

    rs = 10000.0 / max(k_scale, 1e-9)
    q16 = lambda v: int(np.clip(round(v), 0, 65535))

    recs = []
    for chain in _walk_chains(n_id, p_id, valid):
        for s in range(0, len(chain) - MIN_RUN + 1, MAX_RUN):
            run = chain[s:s + MAX_RUN]
            if run.size < MIN_RUN:
                break
            seg, _ = robust_fit_segment_3d(
                x[run][None], y[run][None], rho[run][None],
                s_rho[run][None], sigma_thresh=2.0)
            p0 = seg.p0[0]
            p1 = seg.p1[0]
            s_mean = float(np.mean(s_rho[run]))
            recs.append(_SEG.pack(
                q16(p0[0] * 8), q16(p0[1] * 8), q16(p0[2] * rs),
                q16(s_mean * rs), 0,
                q16(p1[0] * 8), q16(p1[1] * 8), q16(p1[2] * rs),
                q16(s_mean * rs), 0))
    payload = b"".join(recs)
    from rebvo_tpu_torch.io import native
    crc = native.crc16(payload) if native.native_available() else 0
    hdr = _HDR.pack(_MAGIC, len(recs), float(k_scale), crc, 0)
    return hdr + payload


def decompress_edgemap(data: bytes) -> Optional[dict]:
    if len(data) < _HDR.size:
        return None
    magic, nseg, k_scale, crc, _ = _HDR.unpack_from(data)
    if magic != _MAGIC:
        return None
    payload = data[_HDR.size:]
    from rebvo_tpu_torch.io import native
    if native.native_available() and crc and native.crc16(payload) != crc:
        return None
    rs = max(k_scale, 1e-9) / 10000.0
    segs = []
    for i in range(nseg):
        vals = _SEG.unpack_from(payload, i * _SEG.size)
        p0 = (vals[0] / 8.0, vals[1] / 8.0, vals[2] * rs, vals[3] * rs)
        p1 = (vals[5] / 8.0, vals[6] / 8.0, vals[7] * rs, vals[8] * rs)
        segs.append((p0, p1))
    return dict(k_scale=k_scale, segments=segs)


# ---------------------------------------------------------------------------
# Receiver-side accumulated map + visibility hiding
# (reference edgemap_com_decoder, src/CommLib/edgemap_com.cpp:431-640)
# ---------------------------------------------------------------------------


class EdgeMapAccumulator:
    """Accumulates decoded segments across packets into a persistent 3-D
    map, retiring ('hiding') previously-received segments whenever they
    re-project into the current view — the fresh edge map supersedes the
    accumulated one in the visible region (HideVisible,
    edgemap_com.cpp:444-472) — and seeding the dense depth filler from
    the current packet's segments with the reference's quality gates
    (fillDepthMap, edgemap_com.cpp:475-527).

    Each endpoint is (x, y, rho, s_rho) in its emission camera frame;
    the emission pose (Pose cam-to-world, Pos world, K gauge scale) is
    stored alongside so re-projection into any later view is exact."""

    def __init__(self, zf: float, cx: float, cy: float,
                 width: int, height: int):
        self.zf = float(zf)
        self.cx = float(cx)
        self.cy = float(cy)
        self.width = int(width)
        self.height = int(height)
        # batches: (endpoints [N,2,4], Pose [3,3], Pos [3], K, visible [N])
        self._batches: List[list] = []

    # -- geometry ----------------------------------------------------------

    def _unproject(self, pts: np.ndarray) -> np.ndarray:
        """[.., 4] (x, y, rho, s) -> camera-frame 3-D points [.., 3]."""
        z = 1.0 / np.clip(pts[..., 2], 1e-6, None)
        X = (pts[..., 0] - self.cx) / self.zf * z
        Y = (pts[..., 1] - self.cy) / self.zf * z
        return np.stack([X, Y, z], axis=-1)

    def _reproject(self, P: np.ndarray):
        """camera-frame 3-D -> (x, y, rho); rho < 0 marks behind-camera."""
        Z = P[..., 2]
        safe = np.where(np.abs(Z) > 1e-9, Z, 1e-9)
        x = P[..., 0] * self.zf / safe + self.cx
        y = P[..., 1] * self.zf / safe + self.cy
        return x, y, np.where(Z > 0, 1.0 / safe, -1.0)

    def _in_view(self, ep: np.ndarray, Pose_e, Pos_e, K_e,
                 Pose_c, Pos_c, K_c) -> np.ndarray:
        """Per endpoint [.., 4]: does it re-project inside the current
        view with positive depth? (the HideVisible test,
        edgemap_com.cpp:457-461)."""
        P_em = self._unproject(ep) * K_e
        Pw = P_em @ np.asarray(Pose_e).T + np.asarray(Pos_e)
        Pc = (Pw - np.asarray(Pos_c)) @ np.asarray(Pose_c) / max(K_c, 1e-12)
        x, y, rho = self._reproject(Pc)
        return (x >= 0) & (x < self.width) & (y >= 0) & (y < self.height) \
            & (rho > 0)

    # -- accumulation ------------------------------------------------------

    def hide_visible(self, Pose, Pos, K: float = 1.0) -> int:
        """Retire accumulated segments visible from the given pose;
        returns the number of segments still visible (the reference's
        s_num return)."""
        alive = 0
        for b in self._batches:
            ep, Pose_e, Pos_e, K_e, vis = b
            if not vis.any():
                continue
            inv = self._in_view(ep, Pose_e, Pos_e, K_e, Pose, Pos, K)
            # hide when EITHER endpoint is in the current view
            b[4] = vis & ~(inv[:, 0] | inv[:, 1])
            alive += int(b[4].sum())
        return alive

    def add_packet(self, pkt: dict, Pose, Pos) -> int:
        """hide_visible against the packet's pose, then append its
        segments; returns the surviving accumulated segment count."""
        K_s = float(pkt.get("k_scale", 1.0))
        alive = self.hide_visible(Pose, Pos, K_s)
        segs = pkt.get("segments")
        segs = np.asarray(segs, np.float64) if segs is not None else \
            np.zeros((0, 2, 4))
        if segs.shape[0]:
            ep = segs                                # [N, 2, 4]
            self._batches.append([
                ep, np.asarray(Pose, np.float64),
                np.asarray(Pos, np.float64), K_s,
                np.ones(ep.shape[0], bool)])
            alive += ep.shape[0]
        return alive

    def visible_segments_world(self) -> np.ndarray:
        """All still-visible segments as world-frame 3-D endpoint pairs
        [M, 2, 3] (for map rendering / export)."""
        out = []
        for ep, Pose_e, Pos_e, K_e, vis in self._batches:
            if not vis.any():
                continue
            P = self._unproject(ep[vis]) * K_e
            out.append(P @ Pose_e.T + Pos_e)
        if not out:
            return np.zeros((0, 2, 3))
        return np.concatenate(out, axis=0)


def segments_to_fill_seed(segments, *, zf: float, cx: float, cy: float,
                          v_thresh: float = 2.0, a_thresh_deg: float = 45.0,
                          max_pts: int = 16384):
    """Sample segment spans into depth-fill seed points with the
    reference's gates (fillDepthMap, edgemap_com.cpp:475-527):

      * endpoint uncertainty must not dominate (s0+s1 <= rho0+rho1);
      * confidence rho/s_rho >= v_thresh at both endpoints;
      * near-line-of-sight segments rejected: the angle between the
        segment direction and the viewing ray of p0 must exceed
        a_thresh (those spans are depth discontinuities, not surface);
      * inverse depth interpolated linearly along the pixel span, each
        sample carrying the endpoints' mean uncertainty.

    Returns (x, y, rho, s_rho) float32 arrays ready to seed
    kernels.depth_filler.fill_depth via a KeylineMap."""
    xs, ys, rs, ss = [], [], [], []
    cang_max = np.cos(np.deg2rad(a_thresh_deg))
    n_total = 0
    for (p0, p1) in segments:
        x0, y0, r0, s0 = p0
        x1, y1, r1, s1 = p1
        if s0 + s1 > r0 + r1:
            continue
        if r0 / max(s0, 1e-12) < v_thresh or r1 / max(s1, 1e-12) < v_thresh:
            continue
        z0 = 1.0 / max(r0, 1e-6)
        z1 = 1.0 / max(r1, 1e-6)
        P0 = np.array([(x0 - cx) / zf * z0, (y0 - cy) / zf * z0, z0])
        P1 = np.array([(x1 - cx) / zf * z1, (y1 - cy) / zf * z1, z1])
        d = P0 - P1
        nd = np.linalg.norm(d) * np.linalg.norm(P0)
        if nd > 1e-12 and abs(d @ P0) / nd > cang_max:
            continue
        nt = int(np.hypot(x1 - x0, y1 - y0))
        if nt < 1:
            continue
        i = np.arange(nt, dtype=np.float64)
        xs.append(x0 + (x1 - x0) / nt * i)
        ys.append(y0 + (y1 - y0) / nt * i)
        rs.append(r0 + (r1 - r0) / nt * i)
        ss.append(np.full(nt, 0.5 * (s0 + s1)))
        n_total += nt
        if n_total >= max_pts:
            break
    if not xs:
        z = np.zeros(0, np.float32)
        return z, z, z, z
    cat = lambda a: np.concatenate(a)[:max_pts].astype(np.float32)
    return cat(xs), cat(ys), cat(rs), cat(ss)
