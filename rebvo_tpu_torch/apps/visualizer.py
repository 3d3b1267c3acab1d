"""Telemetry receiver app: the reference's second-process visualizer
(reference src/visualizer/visualizer.cpp:245-535) as a headless
receive-decode-render loop.

Receives edge-map packets over the native fragmented-UDP transport,
decodes the embedded video frame, and renders per packet:

  * an edge overlay (keylines coloured by inverse depth over the
    decoded camera frame — OnPaint, visualizer.cpp:44-124);
  * a top-down depth view (keylines projected onto the camera x/z
    plane — OnPaintDepth, visualizer.cpp:126-243);
  * optionally a dense depth map filled from the sparse keylines
    (depth_filler seeding, the receiver-side use in
    edgemap_com.cpp:431-640 / visualizer.cpp).

Interactive GL windows are out of scope in this headless environment
(SURVEY.md §2.9); the renders are written as PNGs, which is the same
capability exercised offline.

PyTorch counterpart of rebvo_tpu/apps/visualizer.py: the dense depth
runs the port's `fill_depth` on the card unless `--cpu` (run(...,
device="cpu")); the PNGs are written by the port's own `io/png`.

    # terminal 1 — any VOSystem run with VideoNetEnabled=1
    # terminal 2:
    python -m rebvo_tpu_torch.apps.visualizer --port 2708 --out-dir ./view
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np


def _depth_colors(rho: np.ndarray) -> np.ndarray:
    """Map inverse depth to RGB (near = red, far = blue), like the
    reference's depth-coloured keylines (gl_viewer.cpp:635-750)."""
    r = np.clip(rho, 1e-3, 20.0)
    tnorm = np.clip(np.log(r / 0.05) / np.log(20.0 / 0.05), 0.0, 1.0)
    out = np.zeros((r.shape[0], 3), np.uint8)
    out[:, 0] = (tnorm * 255).astype(np.uint8)          # near -> red
    out[:, 2] = ((1 - tnorm) * 255).astype(np.uint8)    # far  -> blue
    out[:, 1] = (np.minimum(tnorm, 1 - tnorm) * 2 * 160).astype(np.uint8)
    return out


def render_edge_overlay(pkt: dict, frame: Optional[np.ndarray] = None
                        ) -> np.ndarray:
    """RGB overlay of the received keylines on the decoded frame."""
    H, W = pkt["height"], pkt["width"]
    if frame is None:
        img = np.zeros((H, W, 3), np.uint8)
    else:
        g = np.clip(np.asarray(frame, np.float32) / 3.0, 0, 255)
        img = np.repeat(g.astype(np.uint8)[..., None], 3, axis=-1)
    kls = pkt["keylines"]
    x = np.clip(np.round(kls["x"]).astype(int), 0, W - 1)
    y = np.clip(np.round(kls["y"]).astype(int), 0, H - 1)
    img[y, x] = _depth_colors(kls["rho"])
    return img


def render_topdown(pkt: dict, *, zf: float, cx: float,
                   size: int = 400, span: float = 10.0) -> np.ndarray:
    """Top-down (camera x/z plane) scatter of the keyline 3-D points,
    camera at the bottom centre (OnPaintDepth role)."""
    kls = pkt["keylines"]
    rho = np.clip(kls["rho"], 1e-3, 20.0)
    z = 1.0 / rho
    X = (kls["x"] - cx) * z / zf
    img = np.zeros((size, size, 3), np.uint8)
    px = np.round((X / span + 0.5) * (size - 1)).astype(int)
    py = np.round((1.0 - z / span) * (size - 1)).astype(int)
    ok = (px >= 0) & (px < size) & (py >= 0) & (py < size)
    img[py[ok], px[ok]] = _depth_colors(rho[ok])
    img[size - 3:, size // 2 - 2:size // 2 + 2] = (255, 255, 0)  # camera
    return img


def render_dense_depth(pkt: dict, block: int = 8,
                       device="cuda") -> np.ndarray:
    """Dense depth image from the sparse keylines via the depth filler
    (kernels/depth_filler.py, the visualizer-side fill), on `device`."""
    import torch

    from rebvo_tpu_torch.frontend.state import KeylineMap
    from rebvo_tpu_torch.kernels.depth_filler import fill_depth
    H, W = pkt["height"], pkt["width"]
    kls = pkt["keylines"]
    K = kls["x"].shape[0]
    klm = KeylineMap.empty(max(K, 1), device=device)
    if K:
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(device)
        klm = klm._replace(
            valid=torch.ones((K,), dtype=torch.bool, device=device),
            x=f32(kls["x"]), y=f32(kls["y"]),
            rho=f32(np.clip(kls["rho"], 1e-3, 20.0)),
            s_rho=f32(kls["s_rho"]))
    fill = fill_depth(klm, width=W, height=H, block=block)
    z = 1.0 / np.clip(fill.rho.cpu().numpy(), 1e-3, 20.0)
    zn = np.clip(z / 10.0, 0, 1)
    img = np.zeros(zn.shape + (3,), np.uint8)
    img[..., 0] = ((1 - zn) * 255).astype(np.uint8)
    img[..., 2] = (zn * 255).astype(np.uint8)
    return img


def _save_png(path: str, img: np.ndarray) -> None:
    from rebvo_tpu_torch.io.png import write_png
    write_png(path, img)


def render_world_map(acc, size: int = 500, span: float = 12.0
                     ) -> np.ndarray:
    """Top-down (world x/z) scatter of the accumulated, visibility-
    filtered map (EdgeMapAccumulator), the persistent-map view the
    reference's receiver builds from decoded segments."""
    img = np.zeros((size, size, 3), np.uint8)
    segs = acc.visible_segments_world()
    if segs.shape[0]:
        P = segs.reshape(-1, 3)
        px = np.round((P[:, 0] / span + 0.5) * (size - 1)).astype(int)
        py = np.round((1.0 - (P[:, 2] + 0.2 * span) / span)
                      * (size - 1)).astype(int)
        ok = (px >= 0) & (px < size) & (py >= 0) & (py < size)
        img[py[ok], px[ok]] = (0, 220, 120)
    return img


def run(host: str, port: int, out_dir: str, max_packets: int = 0,
        timeout_ms: int = 2000, zf: float = 458.0, cx: float = None,
        dense_every: int = 0, quiet: bool = False,
        map_every: int = 0, device="cuda") -> int:
    """The receive loop (visualizer::Run). Returns packets rendered; the
    dense fills run on `device`."""
    from rebvo_tpu_torch.io.edgemap_compress import EdgeMapAccumulator
    from rebvo_tpu_torch.io.telemetry import EdgeMapReceiver
    from rebvo_tpu_torch.io.video import VideoDecoder

    os.makedirs(out_dir, exist_ok=True)
    rx = EdgeMapReceiver(host, port)
    decoder = None
    acc = None
    n_done = 0
    trajectory = []
    try:
        while True:
            pkt = rx.recv(timeout_ms=timeout_ms)
            if pkt is None:
                if n_done:                # stream ended / sender stopped
                    break
                continue
            frame = None
            if pkt.get("video") is not None:
                if decoder is None:
                    decoder = VideoDecoder(pkt["width"], pkt["height"])
                try:
                    frame = decoder.decode(pkt["video"],
                                           pkt["video_etype"])
                except (ValueError, OSError):
                    frame = None          # lossy channel: a bad payload
            fid = pkt["frame_id"]
            _save_png(os.path.join(out_dir, f"edges_{fid:06d}.png"),
                      render_edge_overlay(pkt, frame))
            _save_png(os.path.join(out_dir, f"topdown_{fid:06d}.png"),
                      render_topdown(pkt, zf=zf,
                                     cx=cx if cx is not None
                                     else pkt["width"] / 2.0))
            if dense_every and n_done % dense_every == 0:
                _save_png(os.path.join(out_dir, f"depth_{fid:06d}.png"),
                          render_dense_depth(pkt, device=device))
            if map_every:
                if acc is None:
                    acc = EdgeMapAccumulator(
                        zf, cx if cx is not None else pkt["width"] / 2.0,
                        pkt["height"] / 2.0, pkt["width"], pkt["height"])
                # accumulate received keylines as point segments; the
                # fresh packet supersedes the accumulated map where the
                # current view covers it (HideVisible semantics)
                kls = pkt["keylines"]
                pts = np.stack([kls["x"], kls["y"],
                                np.clip(kls["rho"], 1e-3, 20.0),
                                kls["s_rho"]], axis=-1)
                segs = np.stack([pts, pts], axis=1)[::4]   # subsample
                acc.add_packet(dict(k_scale=1.0, segments=segs),
                               pkt["Pose"], pkt["Pos"])
                if n_done % map_every == 0:
                    _save_png(os.path.join(out_dir, f"map_{fid:06d}.png"),
                              render_world_map(acc))
            trajectory.append((pkt["t"], *pkt["Pos"].tolist()))
            n_done += 1
            if not quiet:
                print(f"pkt {fid}: {pkt['n']} keylines, "
                      f"video={'yes' if frame is not None else 'no'}, "
                      f"pos={np.round(pkt['Pos'], 3)}", flush=True)
            if max_packets and n_done >= max_packets:
                break
    finally:
        rx.close()
    if trajectory:
        with open(os.path.join(out_dir, "received_tray.txt"), "w") as fh:
            for row in trajectory:
                fh.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    return n_done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=2708)
    ap.add_argument("--out-dir", default="./view")
    ap.add_argument("--max-packets", type=int, default=0)
    ap.add_argument("--timeout-ms", type=int, default=2000)
    ap.add_argument("--zf", type=float, default=458.0)
    ap.add_argument("--cx", type=float, default=None)
    ap.add_argument("--dense-every", type=int, default=0,
                    help="render a dense depth fill every N packets")
    ap.add_argument("--map-every", type=int, default=0,
                    help="accumulate a visibility-filtered world map "
                         "and render it every N packets")
    ap.add_argument("--cpu", action="store_true",
                    help="run the dense fills on the CPU")
    args = ap.parse_args(argv)
    n = run(args.host, args.port, args.out_dir, args.max_packets,
            args.timeout_ms, args.zf, args.cx, args.dense_every,
            map_every=args.map_every,
            device="cpu" if args.cpu else "cuda")
    print(f"rendered {n} packets -> {args.out_dir}")


if __name__ == "__main__":
    main()
