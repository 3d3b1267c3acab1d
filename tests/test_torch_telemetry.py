"""The port's telemetry channel and the host-side modules around it
against the JAX package's, on the CPU: the transport copy
(rebvo_tpu_torch/csrc/rebvo_transport.cpp) byte for byte against the
library built from native/rebvo_native.cpp, the edge-map packets and the
compressed edge map byte for byte, loopback round trips with and without
video and EdgeMapDelay, and the line fitting, recorder, video and
receiver-side accumulator modules.

Every socket binds a port the kernel just reported free and is closed at
the end of its test (the suite runs in parallel workers).
"""

import os
import socket
import threading

import numpy as np
import pytest
import torch

from rebvo_tpu.core import linefitting as jlf
from rebvo_tpu.io import edgemap_compress as jec
from rebvo_tpu.io import native as jnative
from rebvo_tpu.io import recorder as jrec
from rebvo_tpu.io import telemetry as jtel
from rebvo_tpu.io import video as jvid
from rebvo_tpu_torch.core import linefitting as tlf
from rebvo_tpu_torch.frontend.state import KeylineMap, keylines_to_host
from rebvo_tpu_torch.io import edgemap_compress as tec
from rebvo_tpu_torch.io import native as tnative
from rebvo_tpu_torch.io import recorder as trec
from rebvo_tpu_torch.io import telemetry as ttel
from rebvo_tpu_torch.io import video as tvid

pytestmark = pytest.mark.skipif(
    not (jnative.native_available() and tnative.native_available()),
    reason="g++ could not build the native libraries")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def edge_map(K=256, n=180, seed=0, chains=True):
    """A numpy edge map (dict of the KeylineMap fields the channel
    reads): n valid slots spread over K, linked in chains of 12 along
    straight lines when `chains`."""
    rng = np.random.RandomState(seed)
    slots = np.sort(rng.choice(K, n, replace=False))
    f = {k: np.zeros(K, np.float32) for k in
         ("x", "y", "gx", "gy", "n_m", "rho", "s_rho", "px", "py")}
    i = {k: np.full(K, -1, np.int32) for k in ("n_id", "p_id", "m_id")}
    valid = np.zeros(K, bool)
    valid[slots] = True
    t = np.arange(n) % 12
    base = rng.uniform(20, 340, (n // 12 + 1, 2))[np.arange(n) // 12]
    f["x"][slots] = (base[:, 0] + 2.0 * t).astype(np.float32)
    f["y"][slots] = (base[:, 1] + 0.7 * t + rng.normal(0, 0.2, n)).astype(
        np.float32)
    f["gx"][slots] = rng.randn(n)
    f["gy"][slots] = rng.randn(n)
    f["n_m"][slots] = np.hypot(f["gx"][slots], f["gy"][slots])
    f["rho"][slots] = rng.uniform(0.1, 2.0, n)
    f["s_rho"][slots] = rng.uniform(0.01, 0.5, n)
    f["px"][slots] = f["x"][slots] - 188.0
    f["py"][slots] = f["y"][slots] - 120.0
    if chains:
        nxt = np.where(t < 11, np.roll(slots, -1), -1)
        nxt[-1] = -1
        i["n_id"][slots] = nxt
        prv = np.where(t > 0, np.roll(slots, 1), -1)
        i["p_id"][slots] = prv
    i["m_id"][slots] = rng.randint(-1, K, n)
    m_num = np.zeros(K, np.int32)
    m_num[slots] = rng.randint(0, 300, n)
    return dict(valid=valid, m_num=m_num, **f, **i)


def jax_klm(d):
    import jax.numpy as jnp

    from rebvo_tpu.frontend.state import KeylineMap as JKeylineMap
    K = d["valid"].shape[0]
    return JKeylineMap.empty(K)._replace(
        **{k: jnp.asarray(v) for k, v in d.items()})


def port_klm(d):
    K = d["valid"].shape[0]
    return KeylineMap.empty(K, device="cpu")._replace(
        **{k: torch.as_tensor(v) for k, v in d.items()})


# ---------------------------------------------------------------------------
# the transport copy against native/rebvo_native.cpp
# ---------------------------------------------------------------------------


CRC_DATA = {"empty": b"", "check": b"123456789",
            "ramp": bytes(range(256)) * 7,
            "random": np.random.RandomState(0).bytes(4099)}


@pytest.mark.parametrize("kind", list(CRC_DATA))
def test_crc16_equals_native(kind):
    data = CRC_DATA[kind]
    assert tnative.crc16(data) == jnative.crc16(data)
    if kind == "check":
        assert tnative.crc16(data) == 0x4B37      # Modbus check value


@pytest.mark.parametrize("k_scale", [1.0, 1.7, 1e-12])
def test_quantized_records_equal_native(k_scale):
    """The port's quantizer on the port's KeylineMap gives the bytes the
    native library gives on the JAX package's, and dequantizes alike."""
    d = edge_map(seed=3)
    # saturation and link cases: a link past K, m_num above 255, x < 0
    d["n_id"][np.flatnonzero(d["valid"])[0]] = 10_000
    d["x"][np.flatnonzero(d["valid"])[1]] = -3.0
    tb, tn = tnative.quantize_keylines(port_klm(d), k_scale)
    jb, jn = jnative.quantize_keylines(jax_klm(d), k_scale)
    assert tn == jn == int(d["valid"].sum())
    assert tb == jb
    assert tnative.net_keyline_size() == jnative.net_keyline_size() == 16
    td = tnative.dequantize_keylines(tb, k_scale)
    jd = jnative.dequantize_keylines(jb, k_scale)
    for k in jd:
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)


def test_keylines_to_host_one_copy_is_exact():
    """The one-transfer host copy keeps every field bit for bit (the int32
    fields ride in a float32 view), and carries the extra values."""
    d = edge_map(seed=5)
    h = keylines_to_host(port_klm(d), tnative.WIRE_FIELDS, extra=(
        torch.tensor(1.25), torch.arange(3.0), torch.eye(3), 0.5))
    for k in ("x", "y", "gx", "gy", "n_m", "rho", "s_rho", "n_id", "m_num",
              "valid"):
        np.testing.assert_array_equal(h[k], d[k], err_msg=k)
    assert h["n_id"].dtype == np.int32
    np.testing.assert_array_equal(
        h["extra"], np.concatenate([[1.25], np.arange(3.0),
                                    np.eye(3).ravel(), [0.5]]))


@pytest.mark.parametrize("direction", ["port_to_native", "native_to_port"])
def test_loopback_packet_between_builds(direction):
    """A 150,000-byte packet (5 fragments) sent by one build arrives
    whole through the other's receiver."""
    port = free_port()
    tx_mod, rx_mod = ((tnative, jnative) if direction == "port_to_native"
                      else (jnative, tnative))
    rx = rx_mod.UdpPort("127.0.0.1", port, bind=True)
    tx = tx_mod.UdpPort("127.0.0.1", port)
    payload = os.urandom(150_000)
    got = {}
    th = threading.Thread(target=lambda: got.update(
        data=rx.recv(max_size=1 << 20, timeout_ms=3000)))
    th.start()
    nfrag = tx.send(payload)
    th.join()
    tx.close()
    rx.close()
    assert nfrag == 5
    assert got["data"] == payload


def test_receiver_buffer_holds_a_full_width_packet():
    """A bound port asks for RCVBUF_BYTES; a 650,000-byte burst (21
    fragments: 16384 keylines and a raw 752x480 frame) arrives whole."""
    port = free_port()
    rx = tnative.UdpPort("127.0.0.1", port, bind=True)
    tx = tnative.UdpPort("127.0.0.1", port)
    assert rx.rcvbuf > 0 and tx.rcvbuf == 0
    payload = os.urandom(650_000)
    got = {}
    th = threading.Thread(target=lambda: got.update(
        data=rx.recv(timeout_ms=3000)))
    th.start()
    tx.send(payload)
    th.join()
    assert rx.recv(max_size=1024, timeout_ms=50) is None   # timeout path
    tx.close()
    rx.close()
    assert got["data"] == payload


def test_pipeline_ring_semantics():
    lib = tnative.load_native()
    h = lib.rn_pipeline_create(2, 2)
    assert lib.rn_pipeline_request(h, 0, 100) == 0
    lib.rn_pipeline_release(h, 0)
    assert lib.rn_pipeline_request(h, 0, 100) == 1
    assert lib.rn_pipeline_request(h, 1, 100) == 0
    lib.rn_pipeline_release(h, 0)                       # releases slot 1
    assert lib.rn_pipeline_request(h, 0, 50) == -1      # slot 0 still held
    lib.rn_pipeline_release(h, 1)
    assert lib.rn_pipeline_request(h, 0, 100) == 0
    lib.rn_pipeline_destroy(h)


def test_native_frame_loader(tmp_path):
    """NativeFrameLoader through native/rebvo_native.cpp built whole
    into build/native (libpng), against the port's own PNG decoder."""
    from rebvo_tpu_torch.io.png import read_png, write_png
    img_dir = tmp_path / "data"
    img_dir.mkdir()
    W, H = 32, 24
    lines, truth = [], []
    for i in range(4):
        ts = 1000000000 + i * 50000000
        arr = (np.random.RandomState(i).rand(H, W) * 255).astype(np.uint8)
        write_png(str(img_dir / f"{ts}.png"), arr)
        lines.append(f"{ts},{ts}.png")
        truth.append(read_png(str(img_dir / f"{ts}.png")).astype(
            np.float32) * 3.0)
    (tmp_path / "data.csv").write_text("#header\n" + "\n".join(lines))
    try:
        ld = tnative.NativeFrameLoader(str(tmp_path / "data.csv"),
                                       str(img_dir), W, H)
    except RuntimeError as e:
        assert "libpng" in str(e)
        pytest.skip("libpng headers missing: the loader refuses, as stated")
    frames = list(ld)
    n = len(ld)
    ld.close()
    assert n == 4 and len(frames) == 4
    for i, (t, f) in enumerate(frames):
        assert abs(t - (1.0 + i * 0.05)) < 1e-6
        np.testing.assert_array_equal(f, truth[i])


# ---------------------------------------------------------------------------
# packets, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("video", [None, "raw"])
def test_pack_edgemap_byte_equal(video):
    d = edge_map(seed=1)
    W, H = 376, 240
    pos = np.asarray([0.25, -1.5, 3.0], np.float32)
    pose = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                      np.float32)
    vid = None
    if video:
        frame = np.random.RandomState(2).uniform(0, 765, (H, W)).astype(
            np.float32)
        enc_t = tvid.make_encoder(tvid.VIDEO_ENCODER_TYPE_RAW, W, H)
        enc_j = jvid.make_encoder(jvid.VIDEO_ENCODER_TYPE_RAW, W, H)
        enc_t.push_frame(torch.as_tensor(frame))
        enc_j.push_frame(frame)
        vid = enc_t.pop_frame()
        assert vid == enc_j.pop_frame()
    tp = ttel.pack_edgemap(7, W, H, port_klm(d), 1.3, pos, pose, 4.125,
                           video=vid, video_etype=0)
    jp = jtel.pack_edgemap(7, W, H, jax_klm(d), 1.3, pos, pose, 4.125,
                           video=vid, video_etype=0)
    assert tp == jp
    out = ttel.unpack_edgemap(tp)
    assert out["n"] == int(d["valid"].sum()) and out["frame_id"] == 7
    assert (out["video"] is None) == (video is None)
    assert ttel.unpack_edgemap(tp[:-1] if video is None else tp[:40]) \
        is None


def test_compress_edgemap_byte_equal():
    d = edge_map(K=512, n=300, seed=4)
    tb = tec.compress_edgemap(port_klm(d), k_scale=1.2)
    jb = jec.compress_edgemap(jax_klm(d), k_scale=1.2)
    assert tb == jb
    assert len(tb) < int(d["valid"].sum()) * 16
    to, jo = tec.decompress_edgemap(tb), jec.decompress_edgemap(jb)
    assert to["segments"] == jo["segments"] and len(to["segments"]) > 10
    bad = tb[:20] + bytes([tb[20] ^ 1]) + tb[21:]
    assert tec.decompress_edgemap(bad) is None          # crc mismatch


@pytest.mark.parametrize("video,delay", [(None, 0), ("raw", 0),
                                         ("mjpeg", 0), ("raw", 2)])
def test_telemetry_roundtrip(video, delay):
    """EdgeMapSender -> loopback -> EdgeMapReceiver: the packet holds the
    sender's edge map as the host quantizes it, the nav values and the
    frame; with EdgeMapDelay=2 the first two sends emit nothing and the
    third carries frame 0's edge map and nav state."""
    if video == "mjpeg":
        pytest.importorskip("PIL")
    etype = {None: None, "raw": tvid.VIDEO_ENCODER_TYPE_RAW,
             "mjpeg": tvid.VIDEO_ENCODER_TYPE_MJPEG}[video]
    W, H = 376, 240
    port = free_port()
    rx = ttel.EdgeMapReceiver("127.0.0.1", port)
    tx = ttel.EdgeMapSender("127.0.0.1", port, W, H, video_etype=etype,
                            edgemap_delay=delay)
    maps = [edge_map(seed=10 + k) for k in range(delay + 1)]
    frames = [np.random.RandomState(k).uniform(0, 765, (H, W)).astype(
        np.float32) for k in range(delay + 1)]
    for k in range(delay):
        assert tx.send(port_klm(maps[k]), 1.0, torch.zeros(3),
                       torch.eye(3), 10.0 + k, frame=frames[k]) == 0
    got = {}
    th = threading.Thread(target=lambda: got.update(
        pkt=rx.recv(timeout_ms=3000)))
    th.start()
    n = tx.send(port_klm(maps[delay]), torch.tensor(1.5),
                torch.tensor([1.0, 2.0, 3.0]), torch.eye(3),
                torch.tensor(10.0 + delay), frame=frames[delay])
    th.join()
    tx.close()
    rx.close()
    assert n > 0
    pkt = got["pkt"]
    assert pkt is not None and pkt["frame_id"] == 0
    want = jnative.dequantize_keylines(
        *[jnative.quantize_keylines(jax_klm(maps[0]), pkt["k_scale"])[0],
          pkt["k_scale"]])
    for k, v in want.items():
        np.testing.assert_array_equal(pkt["keylines"][k], v, err_msg=k)
    assert abs(pkt["t"] - 10.0) < 1e-6
    if delay:
        np.testing.assert_array_equal(pkt["Pos"], np.zeros(3))
    else:
        np.testing.assert_array_equal(pkt["Pos"], [1.0, 2.0, 3.0])
        assert pkt["k_scale"] == 1.5
    if video is None:
        assert pkt["video"] is None
    else:
        dec = tvid.VideoDecoder(W, H).decode(pkt["video"],
                                             pkt["video_etype"])
        # the video is the current frame's (the ring delays the map only)
        err = np.abs(dec - tvid._from_u8(tvid._to_u8(frames[delay])))
        assert (err.max() == 0) if video == "raw" else err.mean() < 30.0


# ---------------------------------------------------------------------------
# line fitting, recorder, video, accumulator
# ---------------------------------------------------------------------------


def test_linefitting_equals_jax():
    rng = np.random.RandomState(0)
    t = np.linspace(0, 20, 24)
    x = (100 + 3.0 * t)[None] + rng.normal(0, 0.3, (5, 24))
    y = (50 + 1.0 * t)[None] + rng.normal(0, 0.3, (5, 24))
    y[:, 7] += 25.0
    rho = (0.4 + 0.01 * t)[None] + rng.normal(0, 0.01, (5, 24))
    s = rng.uniform(0.02, 0.1, (5, 24))
    mask = rng.rand(5, 24) > 0.1
    for a, b in zip(tlf.fit_line_2d(x, y), jlf.fit_line_2d(x, y)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tlf.fit_segment_3d(x, y, rho, s, mask),
                    jlf.fit_segment_3d(x, y, rho, s, mask)):
        np.testing.assert_array_equal(a, b)
    (ts, tk), (js, jk) = (tlf.robust_fit_segment_3d(x, y, rho, s, 1.0),
                          jlf.robust_fit_segment_3d(x, y, rho, s, 1.0))
    np.testing.assert_array_equal(tk, jk)
    assert not tk[:, 7].any()
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a, b)


def test_recorder_roundtrip(tmp_path):
    """FrameRecorder (numpy and tensor frames) -> SimReplay under a
    simulated clock; the file equals the JAX package's for the same
    frames."""
    H, W = 12, 16
    frames = [np.random.RandomState(i).rand(H, W).astype(np.float32) * 765
              for i in range(4)]
    tp, jp = str(tmp_path / "t.rvsim"), str(tmp_path / "j.rvsim")
    tr, jr = trec.FrameRecorder(tp, W, H), jrec.FrameRecorder(jp, W, H)
    for i, f in enumerate(frames):
        tr.push(0.05 * i, torch.as_tensor(f) if i % 2 else f)
        jr.push(0.05 * i, f)
    tr.close()
    jr.close()
    assert open(tp, "rb").read() == open(jp, "rb").read()
    clock = trec.SimClock()
    clock.turn_simu_on(start=0.0)
    rp = trec.SimReplay(tp, clock=clock)
    got = list(rp)
    rp.close()
    assert len(got) == 4 and clock.now() == pytest.approx(0.15)
    for i, (t, f) in enumerate(got):
        assert t == pytest.approx(0.05 * i)
        np.testing.assert_array_equal(f, frames[i])
    assert clock.tick(10) == pytest.approx(0.16)


def test_video_stream_roundtrip(tmp_path):
    """Raw and MJPEG streams through VideoStreamWriter and back; the raw
    payloads equal the JAX encoder's, tensor frames included."""
    H, W = 48, 64
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = [(380 + 370 * np.sin(xx / 9 + i) * np.cos(yy / 7)).astype(
        np.float32) for i in range(3)]
    etypes = [tvid.VIDEO_ENCODER_TYPE_RAW]
    try:
        import PIL  # noqa: F401
        etypes.append(tvid.VIDEO_ENCODER_TYPE_MJPEG)
    except ImportError:
        pass
    path = str(tmp_path / "video.rvv")
    wr = tvid.VideoStreamWriter(path, W, H)
    for etype in etypes:
        enc = tvid.make_encoder(etype, W, H)
        jenc = jvid.make_encoder(etype, W, H)
        assert enc.pop_frame() is None
        for i, f in enumerate(frames):
            enc.push_frame(torch.as_tensor(f))
            jenc.push_frame(f)
            data = enc.pop_frame()
            assert data == jenc.pop_frame()
            wr.write(float(i), data, etype)
    wr.close()
    assert tvid.stream_dims(path) == (W, H)
    dec = tvid.VideoDecoder(W, H)
    pkts = list(tvid.read_video_stream(path))
    assert len(pkts) == 3 * len(etypes)
    for k, (t, etype, data) in enumerate(pkts):
        out = dec.decode(data, etype)
        assert out.shape == (H, W) and t == k % 3
        if etype == tvid.VIDEO_ENCODER_TYPE_RAW:
            np.testing.assert_array_equal(
                out, tvid._from_u8(tvid._to_u8(frames[k % 3])))
        else:
            assert np.abs(out - frames[k % 3]).mean() < 30.0
    with pytest.raises(NotImplementedError):
        tvid.EncoderMFC()
    with pytest.raises(ValueError):
        tvid.make_encoder(7, W, H)


def test_accumulator_and_fill_seed_equal_jax():
    """EdgeMapAccumulator and segments_to_fill_seed on the same packets
    give the JAX package's arrays (both are numpy on the host)."""
    ZF, CX, CY, W, H = 400.0, 376.0, 240.0, 752, 480
    rng = np.random.RandomState(0)
    segs = []
    for _ in range(40):
        x0, y0 = rng.uniform(50, 700), rng.uniform(50, 430)
        r0, r1 = rng.uniform(0.1, 1.0, 2)
        s0, s1 = rng.uniform(0.005, 0.3, 2)
        segs.append(((x0, y0, r0, s0),
                     (x0 + rng.uniform(-60, 60), y0 + rng.uniform(-60, 60),
                      r1, s1)))
    for a, b in zip(tec.segments_to_fill_seed(segs, zf=ZF, cx=CX, cy=CY),
                    jec.segments_to_fill_seed(segs, zf=ZF, cx=CX, cy=CY)):
        np.testing.assert_array_equal(a, b)
    accs = [m.EdgeMapAccumulator(ZF, CX, CY, W, H) for m in (tec, jec)]
    poses = [(np.eye(3), np.zeros(3)),
             (np.eye(3), np.asarray([0.3, 0.0, 1.5]))]
    for k, (R, P) in enumerate(poses):
        pkt = dict(k_scale=1.0, segments=segs[k * 20:(k + 1) * 20])
        assert accs[0].add_packet(pkt, R, P) == accs[1].add_packet(pkt, R, P)
    np.testing.assert_array_equal(accs[0].visible_segments_world(),
                                  accs[1].visible_segments_world())
