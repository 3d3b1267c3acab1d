"""The port's telemetry receiver app (apps/visualizer.py) and ROS bridge
builders (apps/ros_bridge.py) against the JAX package's, on the CPU,
mirroring tests/test_visualizer.py and tests/test_ros_bridge.py.

The renders that are numpy on both sides (edge overlay, top-down view,
world map) and the ROS payloads are equal; the dense-depth render goes
through each package's fill_depth, whose grids agree to float32 roundoff
(tests/test_torch_depth_filler.py), so its colours may differ by one
level at a counted share of DENSE_MISMATCH of the pixels (measured 0).
"""

import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from rebvo_tpu.apps import ros_bridge as jros
from rebvo_tpu.apps import visualizer as jvis
from rebvo_tpu_torch.apps import ros_bridge as tros
from rebvo_tpu_torch.apps import visualizer as tvis
from rebvo_tpu_torch.frontend.state import KeylineMap
from rebvo_tpu_torch.io import native
from rebvo_tpu_torch.io.png import read_png
from rebvo_tpu_torch.io.telemetry import (EdgeMapSender, pack_edgemap,
                                          unpack_edgemap)

DENSE_MISMATCH = 0.001

torch.set_num_threads(2)


def fake_klm(K=400, W=376, H=240, seed=0, valid_n=None):
    """tests/test_visualizer.py's random edge map (plus the ROS fields)
    as numpy, then as the port's and the JAX package's KeylineMaps."""
    rng = np.random.RandomState(seed)
    v = np.ones(K, bool) if valid_n is None else np.arange(K) < valid_n
    d = dict(
        valid=v, x=rng.uniform(2, W - 2, K).astype(np.float32),
        y=rng.uniform(2, H - 2, K).astype(np.float32),
        gx=rng.uniform(-1, 1, K).astype(np.float32),
        gy=rng.uniform(-1, 1, K).astype(np.float32),
        n_m=np.ones(K, np.float32),
        px=rng.uniform(-50, 50, K).astype(np.float32),
        py=rng.uniform(-50, 50, K).astype(np.float32),
        rho=rng.uniform(0.1, 2.0, K).astype(np.float32),
        s_rho=rng.uniform(0.05, 1.0, K).astype(np.float32),
        m_id=rng.randint(-1, K, K).astype(np.int32),
        m_num=rng.randint(0, 9, K).astype(np.int32),
        p_id=rng.randint(-1, K, K).astype(np.int32),
        n_id=rng.randint(-1, K, K).astype(np.int32))
    import jax.numpy as jnp

    from rebvo_tpu.frontend.state import KeylineMap as JKeylineMap
    tk = KeylineMap.empty(K, device="cpu")._replace(
        **{k: torch.as_tensor(a) for k, a in d.items()})
    jk = JKeylineMap.empty(K)._replace(
        **{k: jnp.asarray(a) for k, a in d.items()})
    return tk, jk


@pytest.mark.skipif(not native.native_available(),
                    reason="g++ could not build the transport")
def test_renders_match_jax():
    """One packet rendered by both apps: overlay (with and without a
    frame), top-down and world map equal; dense depth (port on the CPU)
    within DENSE_MISMATCH."""
    W, H = 160, 120
    tk, _ = fake_klm(K=128, W=W, H=H)
    pkt = unpack_edgemap(pack_edgemap(0, W, H, tk, 1.0, np.zeros(3),
                                      np.eye(3), 0.0))
    frame = np.random.RandomState(3).uniform(0, 765, (H, W)).astype(
        np.float32)
    for f in (None, frame):
        np.testing.assert_array_equal(tvis.render_edge_overlay(pkt, f),
                                      jvis.render_edge_overlay(pkt, f))
    td = tvis.render_topdown(pkt, zf=100.0, cx=W / 2.0, size=128)
    assert td.shape == (128, 128, 3) and td.max() > 0
    np.testing.assert_array_equal(
        td, jvis.render_topdown(pkt, zf=100.0, cx=W / 2.0, size=128))
    tdd = tvis.render_dense_depth(pkt, device="cpu")
    jdd = jvis.render_dense_depth(pkt)
    assert tdd.shape == jdd.shape == (15, 20, 3) and tdd.max() > 0
    diff = np.abs(tdd.astype(int) - jdd.astype(int))
    assert diff.max() <= 1 and np.mean(diff > 0) <= DENSE_MISMATCH
    from rebvo_tpu.io import edgemap_compress as jec
    from rebvo_tpu_torch.io import edgemap_compress as tec
    segs = [((20.0, 30.0, 0.5, 0.02), (60.0, 30.0, 0.5, 0.02)),
            ((10.0, 90.0, 0.2, 0.02), (15.0, 95.0, 0.25, 0.02))]
    accs = [m.EdgeMapAccumulator(100.0, W / 2.0, H / 2.0, W, H)
            for m in (tec, jec)]
    for a in accs:
        a.add_packet(dict(k_scale=1.0, segments=segs), np.eye(3),
                     np.zeros(3))
    wm = tvis.render_world_map(accs[0])
    assert wm.max() > 0
    np.testing.assert_array_equal(wm, jvis.render_world_map(accs[1]))


@pytest.mark.skipif(not native.native_available(),
                    reason="g++ could not build the transport")
def test_receiver_loop_end_to_end(tmp_path):
    """EdgeMapSender -> UDP loopback -> visualizer.run (dense fills on
    the CPU): packets arrive, the raw video decodes, every render lands
    on disk as a PNG the port's reader reads back."""
    W, H, n_pkts = 376, 240, 5
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_dir = str(tmp_path / "view")
    result = {}

    def rx_loop():
        result["n"] = tvis.run("127.0.0.1", port, out_dir,
                               max_packets=n_pkts, timeout_ms=4000,
                               zf=200.0, cx=W / 2.0, dense_every=2,
                               quiet=True, map_every=2, device="cpu")

    rx = threading.Thread(target=rx_loop)
    rx.start()
    tx = EdgeMapSender("127.0.0.1", port, W, H, video_etype=0)
    frame = (np.random.RandomState(1).rand(H, W) * 765).astype(np.float32)
    # the channel is lossy: keep sending until the receiver has its count
    for i in range(200):
        tx.send(fake_klm(seed=i)[0], 1.0, np.zeros(3), np.eye(3), 0.05 * i,
                frame=frame)
        time.sleep(0.02)
        if not rx.is_alive():
            break
    rx.join(timeout=60)
    tx.close()
    assert result.get("n", 0) == n_pkts
    files = sorted(os.listdir(out_dir))
    assert sum(f.startswith("edges_") for f in files) == n_pkts
    assert sum(f.startswith("topdown_") for f in files) == n_pkts
    assert any(f.startswith("depth_") for f in files)
    assert any(f.startswith("map_") for f in files)
    assert "received_tray.txt" in files
    img = read_png(os.path.join(out_dir, next(f for f in files
                                              if f.startswith("edges_"))))
    assert img.shape == (H, W, 3) and img.max() > 0
    # the overlay is drawn over the decoded raw frame
    g = np.clip(frame / 3.0 + 0.5, 0, 255).astype(np.uint8)
    assert np.mean(img[..., 0] == g) > 0.9


def test_ros_builders_match_jax():
    """build_edgemap_dict, unproject_keylines, build_pointcloud2 and
    build_tf on the port's tensors give the JAX package's arrays."""
    tk, jk = fake_klm(K=16, W=100, H=100, valid_n=10)
    te, je = tros.build_edgemap_dict(tk, 1.0), jros.build_edgemap_dict(jk, 1.0)
    assert te.keys() == je.keys()
    for k in je:
        assert te[k].dtype == je[k].dtype, k
        np.testing.assert_array_equal(te[k], je[k], err_msg=k)
    for K_scale in (1.0, 2.0):
        tp = tros.unproject_keylines(tk, K_scale, 200.0)
        np.testing.assert_array_equal(
            tp, jros.unproject_keylines(jk, K_scale, 200.0))
    assert tros.build_pointcloud2(tp) == jros.build_pointcloud2(tp)
    for rot in (np.zeros(3), np.asarray([0.0, 0.0, np.pi / 2]),
                np.asarray([0.3, -0.2, 0.1])):
        for a, b in zip(tros.build_tf(rot, np.arange(3.0)),
                        jros.build_tf(rot, np.arange(3.0))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="rospy unavailable"):
        tros.make_node()
