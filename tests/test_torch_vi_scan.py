"""The port's visual-inertial `step_scan` (N `step_imu_donated` steps a
call, the frames' IMU windows stacked) and `run_vo --imu --chunk`, on
`write_euroc_vi` directories; and the port's `step_imu` against the
benchmark's plain reference (`vobench/reference`, plain PyTorch).

At test_torch_vi_step.py's size (376x240, K=8192, InitBiasFrameNum=4:
the camera holds still for 6 frames and the scale/gravity filter runs
from frame_count 9 on), with the IMU mounted rotated 90 degrees about z
(`CamImuSE3File`, the written IMU rows rotated to match), so that a
chunk that dropped the frontend's extrinsics would part from the
per-frame steps. On the CPU `step_scan` runs its steps in a loop and
must give the per-frame steps' floats bit for bit. On the card (test
marked `card`) the steps are one CUDA graph, held bit for bit against
the eager steps there; this file imports no JAX, so it runs on the card
with `python -m pytest --noconftest tests/test_torch_vi_scan.py -m card`.
"""

import os

import numpy as np
import pytest
import torch

from rebvo_tpu_torch import obs
from rebvo_tpu_torch.config import REBVOParameters, save_config
from rebvo_tpu_torch.frontend.imu import ImuWindow, stack_windows
from rebvo_tpu_torch.frontend.step import (VOFrontend, tree_leaves,
                                          tree_map)
from rebvo_tpu_torch.io.dataset import (DatasetSequence, imu_window_size,
                                        read_euroc_imu, slice_imu_windows)
from rebvo_tpu_torch.io.png import read_png
from rebvo_tpu_torch.io.render import write_euroc_vi

torch.set_num_threads(2)

SMALL = dict(ImageWidth=376, ImageHeight=240, ZfX=200.0, ZfY=200.0,
             PPx=188.0, PPy=120.0, KcR2=0.0, KcR4=0.0, KcP1=0.0, KcP2=0.0,
             useUndistort=0, KeylineMax=8192, MaxPoints=8192,
             ReferencePoints=3000, TrackPoints=8192,
             GlobalMatchThreshold=200, DetectorThresh=0.03,
             DetectorAutoGain=1e-6, ImuMode=2, InitBiasFrameNum=4,
             SampleTime=0.005)
# run_vo's fixture: the 188x120 camera of test_torch_dataset.py
SMALL_RUN = dict(ImageWidth=188, ImageHeight=120, ZfX=114.66, ZfY=114.32,
                 PPx=91.8, PPy=62.1, KeylineMax=2048, MaxPoints=2048,
                 ReferencePoints=800, TrackPoints=2048,
                 GlobalMatchThreshold=100, DetectorThresh=0.03,
                 DetectorAutoGain=1e-6, InitBiasFrameNum=4, UsePallas=0,
                 SampleTime=0.005)
RZ = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
N_CHUNK = 4
N_STEPS = 12                  # three chunks; the filter starts in the third


def _mounted(mav: str, R: np.ndarray) -> str:
    """Rotate a write_euroc_vi directory's IMU rows into an IMU mounted
    at x_imu = R x_cam, and write that mounting as a CamImuSE3File."""
    csv = os.path.join(mav, "imu0", "data.csv")
    with open(csv) as fh:
        head, *rows = [ln for ln in fh.read().splitlines() if ln]
    out = [head]
    for ln in rows:
        v = ln.split(",")
        g = R @ np.asarray(v[1:4], np.float64)
        a = R @ np.asarray(v[4:7], np.float64)
        out.append(",".join([v[0]] + [f"{x:.9f}" for x in (*g, *a)]))
    with open(csv, "w") as fh:
        fh.write("\n".join(out) + "\n")
    se3 = os.path.join(mav, "cam_imu.txt")
    with open(se3, "w") as fh:
        fh.write(" ".join(f"{x:.17g}" for x in (*R.ravel(), 0.0, 0.0, 0.0)))
    return se3


@pytest.fixture(scope="module")
def vi_dir(tmp_path_factory):
    """N_STEPS + 1 frames (bootstrap first) and their IMU, rotated."""
    mav = str(tmp_path_factory.mktemp("vi_scan") / "mav0")
    p = REBVOParameters().replace(**SMALL)
    write_euroc_vi(p, 4 * N_CHUNK + 1, mav, workers=4)
    se3 = _mounted(mav, RZ)
    p = p.replace(CamImuSE3File=se3)
    seq = DatasetSequence.euroc(mav, window_size=imu_window_size(p))
    items = list(seq)
    return dict(params=p, mav=mav, items=items)


def _run(fe, items, n_steps, chunk, device):
    """Bootstrap, then n_steps frames: through step_scan in chunks of
    `chunk` (with the windows stacked), or one step_imu_donated a frame
    with the frontend's extrinsics (chunk 0). The final state and the
    stacked outputs, on the host."""
    def dev(x):
        return torch.as_tensor(x).to(device)
    t0, f0, _ = items[0]
    st = fe.bootstrap(fe.init(), dev(f0), t0)
    outs = []
    body = items[1:n_steps + 1]
    if chunk:
        for c in range(0, n_steps, chunk):
            part = body[c:c + chunk]
            st, o = fe.step_scan(
                st, torch.stack([dev(f) for _, f, _ in part]),
                np.asarray([t for t, _, _ in part], np.float32),
                stack_windows([w for _, _, w in part]))
            outs.append(tree_map(lambda x: x.cpu(), o))
    else:
        for t, f, w in body:
            st, o = fe.step_imu_donated(st, dev(f), t, w, fe.R_cam2imu,
                                        fe.T_cam2imu)
            outs.append(tree_map(lambda x: x[None].cpu(), o))
    outs = tree_map(lambda *xs: torch.cat(xs), *outs)
    return tree_map(lambda x: x.cpu().clone(), st), outs


def _assert_same(a, b, what):
    la, lb = [], []
    tree_map(lambda x: la.append(x), a)
    tree_map(lambda x: lb.append(x), b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        # NaN where the state keeps empty slots (the scale windows)
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                   msg=f"{what}: leaf {i}")


def test_step_scan_with_windows_equals_per_frame_steps(vi_dir):
    """Three chunks of 4 frames with their windows give the per-frame
    step_imu_donated's state and outputs bit for bit, through the
    filter's start (frame_count 9, inside the third chunk), and count
    the windows' samples: 10 a frame at 200 Hz and 20 frames/s, none
    filled to S = 15."""
    p = vi_dir["params"]
    fe = VOFrontend(p, device="cpu")
    np.testing.assert_array_equal(fe.R_cam2imu.numpy(), RZ)
    c0 = obs.counters()
    scan = _run(fe, vi_dir["items"], N_STEPS, N_CHUNK, "cpu")
    c1 = obs.counters()
    assert c1.get("imu.samples", 0) - c0.get("imu.samples", 0) == \
        10 * N_STEPS
    assert c1.get("imu.truncated", 0) == c0.get("imu.truncated", 0)
    frame = _run(VOFrontend(p, device="cpu"), vi_dir["items"], N_STEPS, 0,
                 "cpu")
    assert int(scan[0].frame_count) == N_STEPS + 1
    assert bool(scan[0].imu.init)
    # the filter ran in the last chunk: K moved off its start
    assert float(scan[1].nav.scale[-1]) != float(scan[1].nav.scale[0])
    _assert_same(scan, frame, "step_scan vs step_imu_donated")


def test_step_scan_counts_full_windows_and_refuses_bad_ones(vi_dir):
    """A window filled to S is counted in `imu.truncated`; windows of
    another chunk length, and windows given to a vision-only frontend,
    are refused."""
    p = vi_dir["params"]
    items = vi_dir["items"]
    fe = VOFrontend(p, device="cpu")
    st = fe.bootstrap(fe.init(), items[0][1], items[0][0])
    part = items[1:3]
    frames = torch.stack([torch.as_tensor(f) for _, f, _ in part])
    ts = np.asarray([t for t, _, _ in part], np.float32)
    wins = stack_windows([w for _, _, w in part])
    S = wins.gyro.shape[1]
    full = wins._replace(count=torch.tensor([S, 3], dtype=torch.int32))
    c0 = obs.counters()
    fe.step_scan(st, frames, ts, full)
    c1 = obs.counters()
    assert c1["imu.truncated"] - c0.get("imu.truncated", 0) == 1
    assert c1["imu.samples"] - c0.get("imu.samples", 0) == S + 3
    short = ImuWindow(*[x[:1] for x in wins])
    with pytest.raises(ValueError, match="windows must be"):
        fe.step_scan(st, frames, ts, short)
    mono = VOFrontend(p.replace(ImuMode=0), device="cpu")
    with pytest.raises(ValueError, match="vision-only"):
        mono.step_scan(st, frames, ts, wins)


# ---------------------------------------------------------------------------
# The port's step_imu against the plain reference
# ---------------------------------------------------------------------------


START = 8          # steps before the compared ones: the filter's start next


def _reference_inputs(vi_dir):
    """The fixture as the benchmark's reference takes it: 8-bit frames
    [1, P, H, W] (its frame index = the run frame) and the IMU rows."""
    p = vi_dir["params"]
    recs = sorted(os.listdir(os.path.join(vi_dir["mav"], "cam0", "data")))
    u8 = torch.stack([torch.as_tensor(read_png(os.path.join(
        vi_dir["mav"], "cam0", "data", r))) for r in recs])[None]
    rows = read_euroc_imu(os.path.join(vi_dir["mav"], "imu0", "data.csv"))
    # the reference steps step_imu without extrinsics: rows in the
    # camera frame, as written
    rows[:, 1:4] = rows[:, 1:4] @ RZ
    rows[:, 4:7] = rows[:, 4:7] @ RZ
    return dict(p.__dict__, CamImuSE3File=""), u8, rows


def _program_window(rows, p, t_prev, t):
    """The window the reference cuts (vobench.check.Reference.window),
    through the port's packer."""
    sel = rows[(rows[:, 0] > t_prev + p.TimeDesinc)
               & (rows[:, 0] <= t + p.TimeDesinc + 1e-12)]
    return slice_imu_windows(sel, [t], imu_window_size(p),
                             p.TimeDesinc)[0]


@pytest.mark.parametrize("n", [1, 8])
def test_step_imu_equals_the_reference(vi_dir, n):
    """From the port's state after START steps, n port step_imu steps
    against n of the reference's: every gap of vobench.check is 0. The
    tolerance is 0 because on the CPU both run the same plain float32
    arithmetic in the same order (the float64 sums and solves included),
    and the windows are cut from the same rows by copies of one packer.
    The same steps from that state rounded to bfloat16 (the
    configuration's float32 state at the next precision down) read
    nonzero gaps, so they fail these bars."""
    from vobench import check
    params, u8, rows = _reference_inputs(vi_dir)
    p = REBVOParameters(**params)
    fe = VOFrontend(p, device="cpu")
    ts = [float(t) for t, _, _ in vi_dir["items"]]

    def frame(i):
        return u8[0, i].to(torch.float32) * 3.0
    st = fe.bootstrap(fe.init(), frame(0), ts[0])
    for i in range(1, START + 1):
        st, _ = fe.step_imu_donated(st, frame(i), ts[i],
                                    _program_window(rows, p, ts[i - 1],
                                                    ts[i]))
    before = check.snapshot(st, "state", None)
    outs = []
    for i in range(START + 1, START + 1 + n):
        st, o = fe.step_imu(st, frame(i), ts[i],
                            _program_window(rows, p, ts[i - 1], ts[i]))
        outs.append(check.snapshot(o, "out", None))
    got = {**check.snapshot(st, "state", None),
           **check.stack_named(outs, 1)}
    frames = [(i, ts[i]) for i in range(START + 1, START + 1 + n)]
    lane = check.lane_state(before, 0)
    zero = dict.fromkeys(check.NUMBERS, 0.0)
    ref = check.Reference(params, "cpu", u8, rows)
    after, routs = ref.run(0, lane, frames, ts[START])
    assert check.gaps(got, {**after, **routs}) == zero
    bf16 = check.Reference(params, "cpu", u8, rows, variant="bf16")
    b_after, b_outs = bf16.run(0, lane, frames, ts[START])
    g = check.gaps({**b_after, **b_outs}, {**after, **routs})
    assert g != zero, g
    assert g["imu_filter_gap"] > 0 and g["leaf_gap"] > 0, g


# ---------------------------------------------------------------------------
# On the card: the captured graph
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured VI graph runs on "
                    "the card only")
    return torch.device("cuda")


@pytest.mark.card
def test_vi_graph_equals_eager_steps_on_the_card(vi_dir, card, tmp_path):
    """16 frames as two replays of the captured N=8 VI graph give the
    eager step_imu_donated's state and outputs bit for bit on the card,
    the filter running from the first chunk's end; one capture, two
    replays, and the VI stages timed inside the graph. The graph's
    static state has the memory layout the eager steps leave (the
    filter's inverses come back column-major): with the initial state's
    layout the graph's first step picked other cuBLAS kernels than an
    eager step does, and its P7 parted from the eager one by an ulp."""
    p = REBVOParameters().replace(**SMALL)
    mav = str(tmp_path / "mav0")
    write_euroc_vi(p, 17, mav, workers=4)
    items = list(DatasetSequence.euroc(mav,
                                       window_size=imu_window_size(p)))
    c0 = obs.counters()
    fe = VOFrontend(p, device=card)
    graph = _run(fe, items, 16, 8, card)
    c1 = obs.counters()
    eager = _run(VOFrontend(p, device=card), items, 16, 0, card)
    static, = fe._graphs.states.values()
    layout = [x.stride() for x in tree_leaves(static)]
    assert layout == [x.stride() for x in tree_leaves(eager[0])]
    assert c1["graph.captures"] - c0.get("graph.captures", 0) == 1
    assert c1["graph.replays"] - c0.get("graph.replays", 0) == 2
    assert c1.get("imu.truncated", 0) == c0.get("imu.truncated", 0)
    staged = {r.name for r in obs.records() if r.device_ms is not None}
    assert {"vo.imu", "vo.pose", "vo.imu_filter"} <= staged
    _assert_same(graph, eager, "VI graph vs eager on the card")


# ---------------------------------------------------------------------------
# run_vo --imu --chunk
# ---------------------------------------------------------------------------


def _tum(path):
    with open(path) as fh:
        return [ln for ln in fh if ln.strip()]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A 188x120 write_euroc_vi directory of 14 frames, with cam1, and
    its config: a bootstrap, three chunks of 4 and a tail of one."""
    root = tmp_path_factory.mktemp("vi_run_vo")
    p = REBVOParameters().replace(**SMALL_RUN)
    write_euroc_vi(p, 14, str(root / "mav0"), workers=4, stereo=True)
    cfg = str(root / "run.cfg")
    save_config(p, cfg)
    return root, cfg


def test_run_vo_imu_chunk_writes_same_tum(run_dir, capsys):
    """run_vo --euroc DIR --imu --chunk 4 writes the TUM rows of the
    per-frame run: 13 steps, three chunks of 4 and a tail of one."""
    from rebvo_tpu_torch.apps import run_vo
    root, cfg = run_dir
    rows = {}
    for name, extra in (("frame", []), ("chunk", ["--chunk", "4"])):
        out = root / name
        run_vo.main(["--cpu", "--config", cfg, "--euroc",
                     str(root / "mav0"), "--imu", "--out-dir", str(out)]
                    + extra)
        rows[name] = _tum(out / "rebvo_tray.txt")
    assert "--chunk is not used" not in capsys.readouterr().err
    assert len(rows["frame"]) == 13
    assert rows["chunk"] == rows["frame"]


@pytest.fixture(scope="module")
def dropped_dir(run_dir):
    """A copy of run_dir's directory with cam1's third frame removed
    (its row and its file): run frame 2 has no pair."""
    import shutil
    root, _ = run_dir
    mav = root / "dropped" / "mav0"
    shutil.copytree(root / "mav0", mav)
    csv = mav / "cam1" / "data.csv"
    head, *rows = [ln for ln in csv.read_text().splitlines() if ln]
    gone = rows.pop(2)
    os.remove(mav / "cam1" / "data" / gone.split(",")[1].strip())
    csv.write_text("\n".join([head] + rows) + "\n")
    return mav


@pytest.mark.parametrize("extra", [["--stereo"], ["--kf-every", "2"],
                                   ["--stereo", "dropped"]],
                         ids=["stereo", "kf_every", "stereo_dropped"])
def test_run_vo_chunk_refused_with_stereo_or_keyframes(run_dir, dropped_dir,
                                                       capsys, extra):
    """--chunk with --kf-every prints its refusal and steps each frame on
    its own; with --stereo it prints none and chunks the pairs (stereo-VI
    here: --imu too). Either way the rows are the run's without --chunk:
    6 frames, a bootstrap, a chunk of 4 and a tail of one. With cam1's
    third frame gone (10 frames), the chunked run steps the frame
    collected before the unpaired one, then that frame without its pair,
    then a chunk of 4 pairs and a tail of three: `stereo.pairs` counts
    the chunk's 4, `stereo.unpaired` the one frame, as in the run
    without --chunk."""
    from rebvo_tpu_torch.apps import run_vo
    root, cfg = run_dir
    mav = dropped_dir if "dropped" in extra else root / "mav0"
    flags = [x for x in extra if x != "dropped"]
    refused = "--kf-every" in flags
    n = 10 if "dropped" in extra else 6
    rows, counts = {}, {}
    for name, chunk in (("plain", []), ("chunk", ["--chunk", "4"])):
        out = root / f"{'_'.join(x.strip('-') for x in extra)}_{name}"
        c0 = obs.counters()
        run_vo.main(["--cpu", "--config", cfg, "--euroc", str(mav), "--imu",
                     "--max-frames", str(n), "--out-dir", str(out)]
                    + flags + chunk)
        c1 = obs.counters()
        counts[name] = [c1.get(k, 0) - c0.get(k, 0)
                        for k in ("stereo.pairs", "stereo.unpaired")]
        rows[name] = _tum(out / "rebvo_tray.txt")
        err = capsys.readouterr().err
        assert ("--chunk is not used with --kf-every" in err) == \
            (refused and bool(chunk))
        assert ("--chunk is not used" in err) == (refused and bool(chunk))
    assert len(rows["plain"]) == n - 1      # none for the bootstrap
    assert rows["chunk"] == rows["plain"]
    if "--stereo" in flags:
        unpaired = int("dropped" in extra)
        assert counts == {"plain": [0, unpaired], "chunk": [4, unpaired]}
