"""The port's run_vo `--interactive` and `--save-video`, and VOSystem's
telemetry sender, on the CPU at 188x120 (a REBVO-format config written
from the port's parameters), mirroring tests/test_run_vo_interactive.py
and tests/test_io.py::test_run_vo_save_video.

The interactive runs are subprocesses fed on stdin; the 's' run steps
frame by frame ('f', then 'a' per frame), so the keys, not a sleep,
decide how far it gets.
"""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from rebvo_tpu_torch.config import REBVOParameters, save_config
from rebvo_tpu_torch.io import native
from rebvo_tpu_torch.io.png import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(ImageWidth=188, ImageHeight=120, ZfX=100.0, ZfY=100.0,
            PPx=94.0, PPy=60.0)

torch.set_num_threads(2)


def tiny_params(**kw):
    return REBVOParameters().replace(
        KcR2=0.0, KcR4=0.0, KcP1=0.0, KcP2=0.0, KeylineMax=2048,
        MaxPoints=2048, ReferencePoints=800, TrackPoints=2048,
        GlobalMatchThreshold=50, DetectorThresh=0.03, DetectorAutoGain=1e-6,
        **TINY, **kw)


@pytest.fixture()
def cfg(tmp_path):
    path = str(tmp_path / "tiny.cfg")
    save_config(tiny_params(), path)
    return path


def _run_vo(args, stdin_at=None, timeout=240):
    """python -m rebvo_tpu_torch.apps.run_vo ARGS; `stdin_at` is
    (line prefix, text): the text goes to stdin once a line of standard
    output starts with the prefix (None: stdin closes at once)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "rebvo_tpu_torch.apps.run_vo", *args],
        cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=REPO))
    lines = []
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    try:
        if stdin_at is None:
            out, _ = proc.communicate("q\n")
            lines = out.splitlines()
        else:
            prefix, text = stdin_at
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                if line.startswith(prefix):
                    proc.stdin.write(text)
                    proc.stdin.flush()
                    break
            out, _ = proc.communicate()
            lines += out.splitlines()
    finally:
        timer.cancel()
    return proc.returncode, lines


def test_interactive_quit(tmp_path, cfg):
    """'q' before the first frame: exit 0, nothing saved, the launch
    line last."""
    out = str(tmp_path / "out")
    rc, lines = _run_vo(["--config", cfg, "--synthetic", "30", "--cpu",
                         "--interactive", "--out-dir", out])
    assert rc == 0, "\n".join(lines[-30:])
    assert not os.path.exists(os.path.join(out, "kf_list.npz"))
    assert "processed 0 frames (interactive)" in lines
    assert lines[-1].startswith("kernel_launches=")


def test_interactive_snapshot_and_save(tmp_path, cfg):
    """'f' (frame-by-frame), four 'a' (one frame each), 'p' (a snapshot
    of the current frame through the port's io/png), then 's' (keyframes
    and pose log saved, then quit): exit 0 after n of 2000 frames, n >= 5
    (frames run before 'f' arrives), both files written and readable, the
    snapshot's pixels those of frame n, the one the gate held."""
    from rebvo_tpu_torch.backend.keyframe import load_keyframes
    from rebvo_tpu_torch.backend.posegraph import PoseGraphLog
    from rebvo_tpu_torch.io.render import synth_frames
    out = str(tmp_path / "out")
    rc, lines = _run_vo(["--config", cfg, "--synthetic", "2000", "--cpu",
                         "--interactive", "--out-dir", out],
                        stdin_at=("Interactive commands", "faaaaps\n"))
    text = "\n".join(lines[-30:])
    assert rc == 0, text
    assert any(ln.startswith("saved KF ->") for ln in lines), text
    kf = load_keyframes(os.path.join(out, "kf_list.npz"), device="cpu")
    assert int(kf.count) >= 1
    pg = PoseGraphLog.load(os.path.join(out, "poses_list.npz"))
    n = int(next(ln for ln in lines if ln.startswith("processed ")).split()[1])
    assert 5 <= n < 2000
    assert len(pg.meas) == n - 1
    assert os.path.exists(os.path.join(out, "rebvo_tray.txt"))
    snaps = [f for f in os.listdir(out) if f.startswith("snapshot_")]
    assert snaps == [f"snapshot_{n:06d}.png"]
    frames = synth_frames(tiny_params(), 8)
    want = np.clip(frames[n % 8] / 3.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(read_png(os.path.join(out, snaps[0])),
                                  want)
    assert lines[-1].startswith("kernel_launches=")


@pytest.mark.parametrize("codec", ["raw", "mjpeg"])
def test_run_vo_save_video(tmp_path, cfg, codec):
    """--save-video: one packet per input frame in <out-dir>/video.rvv at
    the config's size; raw pixels equal io/video._to_u8 of the frames."""
    if codec == "mjpeg":
        pytest.importorskip("PIL")
    from rebvo_tpu_torch.apps.run_vo import main
    from rebvo_tpu_torch.io.render import render_lateral
    from rebvo_tpu_torch.io.video import (VideoDecoder, _to_u8,
                                          read_video_stream, stream_dims)
    main(["--config", cfg, "--render", "6", "--out-dir", str(tmp_path),
          "--cpu", "--save-video", codec])
    vp = str(tmp_path / "video.rvv")
    pkts = list(read_video_stream(vp))
    assert len(pkts) == 6 and stream_dims(vp) == (188, 120)
    frames = render_lateral(tiny_params(), 6)
    dec = VideoDecoder(188, 120)
    for (t, etype, data), f in zip(pkts, frames):
        if codec == "raw":
            assert data == _to_u8(f).tobytes()
        else:
            assert np.abs(dec.decode(data, etype) - f).mean() < 30.0


@pytest.mark.skipif(not native.native_available(),
                    reason="g++ could not build the transport")
@pytest.mark.parametrize("delay", [0, 1])
def test_vosystem_sends_every_frame(delay):
    """VOSystem with VideoNetEnabled=1 (raw video, EdgeMapDelay 0 and 1):
    one packet per frame after the bootstrap (the ring holds `delay`
    back), each carrying that frame's edge map as the host quantizes it,
    its nav position and its frame."""
    from rebvo_tpu_torch.io.render import render_lateral
    from rebvo_tpu_torch.io.telemetry import EdgeMapReceiver
    from rebvo_tpu_torch.io.video import VideoDecoder, _from_u8, _to_u8
    from rebvo_tpu_torch.system import VOSystem
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    n = 5
    p = tiny_params(VideoNetEnabled=1, VideoNetPort=port, EncoderType=0,
                    EdgeMapDelay=delay)
    frames = render_lateral(p, n)
    rx = EdgeMapReceiver("127.0.0.1", port)
    pkts = []

    def receive():
        while len(pkts) < n - 1 - delay:
            pkt = rx.recv(timeout_ms=5000)
            if pkt is None:
                return
            pkts.append(pkt)

    th = threading.Thread(target=receive)
    th.start()
    sys_ = VOSystem(p, device="cpu")
    want, pos = [], []
    for i in range(n):
        out = sys_.process_frame(frames[i], i / 20.0)
        if out is not None:
            want.append(native.dequantize_keylines(*[native.quantize_keylines(
                sys_.state.klm, float(out.nav.scale))[0],
                float(out.nav.scale)]))
            pos.append(out.nav.Pos.numpy())
    th.join()
    sys_.sender.close()
    rx.close()
    assert sys_.telemetry_dropped == 0
    assert [q["frame_id"] for q in pkts] == list(range(n - 1 - delay))
    dec = VideoDecoder(188, 120)
    for k, q in enumerate(pkts):
        assert q["n"] > 100
        for f, v in want[k].items():
            np.testing.assert_array_equal(q["keylines"][f], v, err_msg=f)
        np.testing.assert_array_equal(q["Pos"], pos[k])
        # the video is the frame sent with the packet: `delay` later
        np.testing.assert_array_equal(
            dec.decode(q["video"], q["video_etype"]),
            _from_u8(_to_u8(frames[k + 1 + delay])))
