"""The PyTorch port stands alone: it imports neither JAX nor rebvo_tpu.

tests/conftest.py imports JAX into the test process, so the run happens
in a fresh interpreter.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "rebvo_tpu_torch"

_SCRIPT = r"""
import sys
import numpy as np
import rebvo_tpu_torch
from rebvo_tpu_torch.config import REBVOParameters
from rebvo_tpu_torch.frontend.step import VOFrontend
from rebvo_tpu_torch.io.render import synth_frames
import rebvo_tpu_torch.apps.run_vo, rebvo_tpu_torch.convert
import rebvo_tpu_torch.kernels.cuda_scale_space, rebvo_tpu_torch.backend.kfvo
import rebvo_tpu_torch.profiling, rebvo_tpu_torch.bench
import rebvo_tpu_torch.io.dataset, rebvo_tpu_torch.io.undistort
import rebvo_tpu_torch.io.png
from rebvo_tpu_torch.io.dataset import slice_imu_windows
p = REBVOParameters().replace(ImageWidth=96, ImageHeight=64, PPx=48.0,
                              PPy=32.0, KeylineMax=512, NavLogCap=8,
                              ImuMode=2)
fr = synth_frames(p, 3)
fe = VOFrontend(p, device="cpu")
st = fe.bootstrap(fe.init(), fr[0], 0.0)
st, out = fe.step(st, fr[1], 0.05)
assert np.all(np.isfinite(out.nav.Pos.numpy()))
assert int(st.last_kl_num) > 0
imu = np.zeros((30, 7))
imu[:, 0] = np.arange(30) * 0.005
imu[:, 5] = -9.8
win = slice_imu_windows(imu, [0.0, 0.05, 0.1], window_size=16)[2]
st, out = fe.step_imu(st, fr[2], 0.1, win)
assert np.all(np.isfinite(out.nav.Pos.numpy()))
assert int(win.count) == 10
# a stereo step (the cam1 frame: the cam0 frame shifted 2 px) and a
# VOSystem frame
from rebvo_tpu_torch.system import VOSystem
import rebvo_tpu_torch.backend.posegraph, rebvo_tpu_torch.kernels.stereo
ps = p.replace(ImuMode=0, StereoAvaiable=1, StereoPPx=48.0, StereoPPy=32.0)
fs = VOFrontend(ps, device="cpu")
pair = [np.roll(f, -2, axis=1) for f in fr]
st = fs.bootstrap(fs.init(), fr[0], 0.0, pair[0])
st, out = fs.step(st, fr[1], 0.05, pair[1])
assert np.all(np.isfinite(out.nav.Pos.numpy()))
assert int(st.last_kl_num_pair) > 0
sys_ = VOSystem(ps, device="cpu")
for i in range(2):
    out = sys_.process_frame(fr[i], 0.05 * i, frame_pair=pair[i])
assert len(sys_.pose_log.meas) == 1 and sys_.kf_store.capacity == 64
# the offline backend and the apps around it: a small BA solve, a problem
# from the system's keyframe store
import rebvo_tpu_torch.apps.run_ba, rebvo_tpu_torch.apps.parity
import rebvo_tpu_torch.apps.evaluate, rebvo_tpu_torch.apps.view_map
import torch
from rebvo_tpu_torch.backend import ba
R, p_true, _, prob = ba.synth_ring_problem(4, 16, 2, 200.0, device="cpu")
_, _, _, costs = ba.ba_solve(torch.as_tensor(R),
                             torch.as_tensor(p_true) + 0.01, prob, 200.0,
                             iters=2)
assert costs.shape == (2,) and bool(costs.isfinite().all())
pb = ba.problem_from_keyframes(sys_.kf_store, 48.0, width=96, height=64,
                               cx=48.0, cy=32.0)
assert pb.obs_lm.shape[0] > 0
# the parallel layer: the batched step, the sharded BA, their apps
import rebvo_tpu_torch.parallel.mesh, rebvo_tpu_torch.parallel.distributed
import rebvo_tpu_torch.apps.run_batch, rebvo_tpu_torch.apps.run_multihost
import rebvo_tpu_torch.entry
pos = rebvo_tpu_torch.entry.dryrun_multichip(2)
assert pos.shape == (2, 3) and np.all(np.isfinite(pos))
part = ba.partition_problem(prob, 2)
_, _, _, costs = ba.ba_solve_sharded(torch.as_tensor(R),
                                     torch.as_tensor(p_true) + 0.01, part,
                                     200.0, n_shards=2, iters=2)
assert costs.shape == (2,) and bool(costs.isfinite().all())
# the last modules: telemetry, video, recorder, the visualizer, the depth
# filler and surface grid, the ROS builders, checkpoints
import socket, tempfile
import rebvo_tpu_torch.io.recorder, rebvo_tpu_torch.core.linefitting
from rebvo_tpu_torch import runtime_utils
from rebvo_tpu_torch.apps import ros_bridge, visualizer
from rebvo_tpu_torch.backend import surface
from rebvo_tpu_torch.io import edgemap_compress, native, telemetry, video
from rebvo_tpu_torch.kernels import depth_filler
fill = depth_filler.fill_depth(sys_.state.klm, width=96, height=64, block=8,
                               iters=4, bound_mode="full")
P = depth_filler.grid_points_3d(fill, 48.0, 48.0, 32.0)
lo, _ = surface.world_bounds(P)
grid = surface.build_ocgrid(P, torch.ones_like(fill.fixed), lo, 0.5, nx=8,
                            ny=8, nz=8)
vis = surface.ray_cut_visibility(grid, torch.zeros(3), P)
assert vis.shape == fill.rho.shape and int(grid.count.sum()) > 0
assert len(edgemap_compress.compress_edgemap(sys_.state.klm, 1.0)) > 16
assert ros_bridge.build_edgemap_dict(sys_.state.klm, 1.0)["KlGrad"].ndim == 2
with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s_:
    s_.bind(("127.0.0.1", 0))
    udp = s_.getsockname()[1]
rx = telemetry.EdgeMapReceiver("127.0.0.1", udp)
tel = VOSystem(p.replace(ImuMode=0, VideoNetEnabled=1, VideoNetPort=udp),
               device="cpu")
for i in range(2):
    tel.process_frame(fr[i], 0.05 * i)
pkt = rx.recv(timeout_ms=3000)
rx.close()
assert pkt is not None and pkt["n"] > 0 and pkt["video"] is not None
assert visualizer.render_dense_depth(pkt, device="cpu").ndim == 3
with tempfile.TemporaryDirectory() as d:
    runtime_utils.save_state(d + "/c.npz", tel.state)
    back = runtime_utils.load_state(d + "/c.npz", tel.frontend.init())
assert torch.equal(back.Pos, tel.state.Pos)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "rebvo_tpu" or m.startswith("rebvo_tpu."))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_runs_without_jax_or_rebvo_tpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=str(ROOT),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|rebvo_tpu)\b"
    r"|from\s+(jax|jaxlib|rebvo_tpu)(\.|\s+import\b))", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")) +
    ["chip_smoke.py", "tools/kernel_ab.py", "tools/stereo_bars.py",
     "tools/vi_scale_cpu.py", "tools/parity_cpu.py",
     "tools/loop_st_probe.py"])
def test_source_imports_no_jax(path):
    """No module of the port (nor chip_smoke.py and the port's tools)
    imports jax, jaxlib or rebvo_tpu, even lazily inside a function."""
    src = (ROOT / path).read_text()
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(src)]
    assert not hits, hits
