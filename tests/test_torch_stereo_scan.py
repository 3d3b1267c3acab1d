"""The port's stereo `step_scan` (N donated stereo steps a call, cam1's N
frames stacked beside cam0's as `frames_pair`), on the CPU and the card.

On the CPU, on tests/test_stereo_step.py's scene (a rig with a 0.11 m
baseline translating past a tilted plane, 376x240, `stereo_params`): a
bootstrap with the pair and two chunks of 4 give the per-frame
`step_donated(..., pair)` floats bit for bit, and with IMU windows the
per-frame `step_imu_donated(..., pair)` (stereo-VI); the chunks match
the JAX package's per-frame stereo steps within the bars of
tests/test_torch_stereo_step.py; pairs given to a mono frontend, or of
another shape than the frames, are refused; and the obs counters
`stereo.pairs` and `stereo.unpaired` count the pairs handed over and the
frames stepped without one.

On the card (test marked `card`) the steps are one CUDA graph, held bit
for bit against the eager stereo steps there, on a `write_euroc_vi`
stereo directory. This module imports no JAX at its top (the CPU tests
import it inside their fixture and test), so the card test runs with
`python -m pytest --noconftest tests/test_torch_stereo_scan.py -m card`.
"""

import numpy as np
import pytest
import torch

from rebvo_tpu_torch import obs
from rebvo_tpu_torch.config import REBVOParameters
from rebvo_tpu_torch.frontend.imu import ImuWindow, stack_windows
from rebvo_tpu_torch.frontend.step import (VOFrontend, tree_leaves,
                                          tree_map)
from rebvo_tpu_torch.io.dataset import DatasetSequence
from rebvo_tpu_torch.io.render import write_euroc_vi

torch.set_num_threads(2)

N_CHUNK = 4
N_STEPS = 8                   # a bootstrap, then two chunks of 4
# the bars of tests/test_torch_stereo_step.py's sequence: Pos absolute,
# VScaleC relative on every frame and on the last, stereo_num and
# klm_num relative
SEQ_POS, SEQ_VSC, SEQ_VSC_LAST, SEQ_NUM = 1e-3, 1e-2, 1e-3, 0.01
# and of one step from the same state: Pos absolute, stereo_num and
# klm_num relative
ONE_POS, ONE_NUM = 1e-4, 0.005
# the card's fixture: test_torch_vi_scan.py's 376x240 camera as cam0 and
# cam1 (no distortion), EuRoC's cam0 -> cam1 extrinsics (the defaults)
CARD = dict(ImageWidth=376, ImageHeight=240, ZfX=200.0, ZfY=200.0,
            PPx=188.0, PPy=120.0, KcR2=0.0, KcR4=0.0, KcP1=0.0, KcP2=0.0,
            StereoZfX=200.0, StereoZfY=200.0, StereoPPx=188.0,
            StereoPPy=120.0, StereoKcR2=0.0, StereoKcR4=0.0,
            StereoKcP1=0.0, StereoKcP2=0.0, useUndistort=0,
            KeylineMax=8192, MaxPoints=8192, ReferencePoints=3000,
            TrackPoints=8192, GlobalMatchThreshold=200, DetectorThresh=0.03,
            DetectorAutoGain=1e-6, InitBiasFrameNum=4, StereoAvaiable=1)


def _gravity_window() -> ImuWindow:
    """tests/test_torch_stereo_step.py's IMU window: 8 samples of
    gravity alone at 160 Hz."""
    return ImuWindow(gyro=torch.zeros((8, 3)),
                     accel=torch.tensor([0.0, -9.8, 0.0]).repeat(8, 1),
                     count=torch.tensor(8, dtype=torch.int32),
                     tsample=torch.tensor(1.0 / 160.0))


@pytest.fixture(scope="module")
def scene():
    """N_STEPS + 1 frames of cam0 and cam1, the JAX configuration and
    the port's (stereo_params: 376x240, identity rotation, -x baseline);
    the IMU variant with InitBiasFrameNum=2, whose filter starts at
    frame_count 7."""
    from rebvo_tpu_torch.convert import params_from_jax
    from tests.test_torch_stereo_step import _scene
    from tests.test_stereo_step import stereo_params
    f0, f1 = _scene(N_STEPS + 1)
    jp = stereo_params()
    jp_vi = stereo_params(ImuMode=2, InitBiasFrameNum=2)
    return dict(f0=f0, f1=f1, jp=jp, p=params_from_jax(jp),
                jp_vi=jp_vi, p_vi=params_from_jax(jp_vi))


def _items(scene, wins=False, n=N_STEPS + 1):
    """(t, cam0, window or None, cam1) a frame."""
    win = _gravity_window() if wins else None
    return [(i / 20.0, scene["f0"][i], win, scene["f1"][i])
            for i in range(n)]


def _run(fe, items, n_steps, chunk, device, pairs=True):
    """Bootstrap with the first pair, then n_steps frames: through
    step_scan in chunks of `chunk` (cam1's frames stacked as
    frames_pair, the windows stacked when there are windows), or one
    donated step a frame (chunk 0). `pairs=False` hands no cam1 frame to
    the steps. The final state and the stacked outputs, on the host."""
    def dev(x):
        return torch.as_tensor(x, dtype=torch.float32).to(device)
    t0, f0, _, p0 = items[0]
    st = fe.bootstrap(fe.init(), dev(f0), t0, dev(p0))
    outs = []
    body = items[1:n_steps + 1]
    if chunk:
        for c in range(0, n_steps, chunk):
            part = body[c:c + chunk]
            wins = [w for _, _, w, _ in part]
            st, o = fe.step_scan(
                st, torch.stack([dev(f) for _, f, _, _ in part]),
                np.asarray([t for t, _, _, _ in part], np.float32),
                stack_windows(wins) if wins[0] is not None else None,
                torch.stack([dev(pr) for _, _, _, pr in part])
                if pairs else None)
            outs.append(tree_map(lambda x: x.cpu(), o))
    else:
        for t, f, w, pr in body:
            pair = dev(pr) if pairs else None
            if w is not None:
                st, o = fe.step_imu_donated(st, dev(f), t, w, fe.R_cam2imu,
                                            fe.T_cam2imu, pair)
            else:
                st, o = fe.step_donated(st, dev(f), t, pair)
            outs.append(tree_map(lambda x: x[None].cpu(), o))
    outs = tree_map(lambda *xs: torch.cat(xs), *outs)
    return tree_map(lambda x: x.cpu().clone(), st), outs


def _assert_same(a, b, what):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        # NaN where the state keeps empty slots (the scale windows)
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                   msg=f"{what}: leaf {i}")


def _delta(c0, c1, name):
    return c1.get(name, 0) - c0.get(name, 0)


@pytest.fixture(scope="module")
def scan(scene):
    """The stereo chunks on the CPU, with the counters they moved."""
    c0 = obs.counters()
    res = _run(VOFrontend(scene["p"], device="cpu"), _items(scene), N_STEPS,
               N_CHUNK, "cpu")
    return res, c0, obs.counters()


def test_stereo_step_scan_equals_per_frame_steps(scene, scan):
    """Two chunks of 4 stereo frames give the per-frame
    step_donated(..., pair)'s state and outputs bit for bit, through the
    bootstrap re-gauge and the scale carry's start; every frame
    stereo-matches."""
    res, _, _ = scan
    frame = _run(VOFrontend(scene["p"], device="cpu"), _items(scene),
                 N_STEPS, 0, "cpu")
    assert int(res[0].frame_count) == N_STEPS + 1
    assert int(res[1].stereo_num.min()) > 1000
    _assert_same(res, frame, "stereo step_scan vs step_donated")


def test_stereo_vi_step_scan_equals_per_frame_steps(scene):
    """With IMU windows too, the chunks give the per-frame
    step_imu_donated(..., pair)'s floats bit for bit (stereo-VI), the
    filter running in the second chunk."""
    items = _items(scene, wins=True)
    scan = _run(VOFrontend(scene["p_vi"], device="cpu"), items, N_STEPS,
                N_CHUNK, "cpu")
    frame = _run(VOFrontend(scene["p_vi"], device="cpu"), items, N_STEPS,
                 0, "cpu")
    assert int(scan[1].stereo_num.min()) > 500
    assert float(scan[1].nav.scale[-1]) != float(scan[1].nav.scale[0])
    _assert_same(scan, frame, "stereo-VI step_scan vs step_imu_donated")


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def test_stereo_step_scan_matches_jax_steps(scene):
    """Each chunk of 4, stepped by the port's step_scan from the JAX
    package's state at the chunk's start, against JAX's per-frame stereo
    steps (its fused detector in the Pallas interpreter) on the same
    frames, with tests/test_torch_stereo_step.py's bars: on every frame
    the sequence's (kl_num equal, stereo_num and klm_num within 1%, Pos
    within 1e-3, VScaleC within 1e-2 relative), on each chunk's first
    frame, one step from the same state, the single step's (stereo_num
    and klm_num within 0.5%, Pos within 1e-4), and VScaleC within 1e-3
    on the last frame. From one start the float32
    noise grows past the sequence bars after 5 frames (the scale carry's
    deadband, as that file says): Pos parts by 2.2e-3 at the sixth."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from rebvo_tpu.frontend.step import VOFrontend as JaxFrontend
    from rebvo_tpu_torch.convert import state_from_numpy
    f0, f1 = scene["f0"], scene["f1"]
    fe = JaxFrontend(scene["jp"])
    fe.use_pallas = True
    with pltpu.force_tpu_interpret_mode():
        js = fe.bootstrap(fe.init(), jnp.asarray(f0[0]), jnp.asarray(0.0),
                          jnp.asarray(f1[0]))
        states, jouts = [js], []
        for i in range(1, N_STEPS + 1):
            js, jo = fe.step(js, jnp.asarray(f0[i]), jnp.asarray(i / 20.0),
                             jnp.asarray(f1[i]))
            states.append(js)
            jouts.append(jo)
    tfe = VOFrontend(scene["p"], device="cpu")
    for c in range(1, N_STEPS + 1, N_CHUNK):
        st = state_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                     states[c - 1]),
                              device="cpu")
        idx = range(c, c + N_CHUNK)
        st, outs = tfe.step_scan(
            st, torch.stack([torch.as_tensor(f0[i]) for i in idx]),
            np.asarray([i / 20.0 for i in idx], np.float32),
            frames_pair=torch.stack([torch.as_tensor(f1[i]) for i in idx]))
        for k, i in enumerate(idx):
            jo = jouts[i - 1]
            pos, num = (ONE_POS, ONE_NUM) if k == 0 else (SEQ_POS, SEQ_NUM)
            assert int(jo.nav.kl_num) == int(outs.nav.kl_num[k]), i
            assert _rel(outs.stereo_num[k], jo.stereo_num) <= num, i
            assert _rel(outs.nav.klm_num[k], jo.nav.klm_num) <= num, i
            np.testing.assert_allclose(outs.nav.Pos[k].numpy(),
                                       np.asarray(jo.nav.Pos), atol=pos,
                                       rtol=0, err_msg=str(i))
            assert bool(outs.nav.estimation_ok[k]), i
        js = states[c + N_CHUNK - 1]
        vsc = SEQ_VSC_LAST if c + N_CHUNK > N_STEPS else SEQ_VSC
        assert _rel(st.VScaleC, js.VScaleC) <= vsc, c
        assert int(st.last_kl_num_pair) == int(js.last_kl_num_pair), c
        assert int(st.aAge) == int(js.aAge), c


def test_stereo_step_scan_counts_pairs_and_unpaired_frames(scene, scan):
    """`stereo.pairs` counts the cam1 frames handed to step_scan (8 over
    the two chunks) and `stereo.unpaired` the frames a stereo
    frontend's entry calls step without one: none in the paired chunks;
    N for a chunk given no pairs, whose steps are the per-frame steps
    without the pair, bit for bit; one for an eager step without it."""
    _, c0, c1 = scan
    assert _delta(c0, c1, "stereo.pairs") == N_STEPS
    assert _delta(c0, c1, "stereo.unpaired") == 0
    items = _items(scene, n=3)
    c2 = obs.counters()
    bare = _run(VOFrontend(scene["p"], device="cpu"), items, 2, 2, "cpu",
                pairs=False)
    c3 = obs.counters()
    assert _delta(c2, c3, "stereo.unpaired") == 2
    assert _delta(c2, c3, "stereo.pairs") == 0
    frame = _run(VOFrontend(scene["p"], device="cpu"), items, 2, 0, "cpu",
                 pairs=False)
    assert _delta(c3, obs.counters(), "stereo.unpaired") == 2
    assert int(bare[1].stereo_num.max()) == 0
    _assert_same(bare, frame, "unpaired stereo step_scan vs step_donated")


def test_step_scan_refuses_pairs_to_mono_or_of_another_shape(scene):
    """Pairs given to a mono frontend (StereoAvaiable=0) raise, as
    windows given to a vision-only one do; so do pairs whose shape is
    not the frames'."""
    items = _items(scene, n=3)
    frames = torch.stack([torch.as_tensor(f) for _, f, _, _ in items[1:]])
    pairs = torch.stack([torch.as_tensor(p) for _, _, _, p in items[1:]])
    ts = np.asarray([t for t, _, _, _ in items[1:]], np.float32)
    mono = VOFrontend(scene["p"].replace(StereoAvaiable=0), device="cpu")
    st = mono.bootstrap(mono.init(), items[0][1], items[0][0])
    with pytest.raises(ValueError, match="StereoAvaiable=0"):
        mono.step_scan(st, frames, ts, frames_pair=pairs)
    fe = VOFrontend(scene["p"], device="cpu")
    st = fe.bootstrap(fe.init(), items[0][1], items[0][0], items[0][3])
    for bad in (pairs[:1], pairs[:, :-1]):
        with pytest.raises(ValueError, match="frames_pair must have"):
            fe.step_scan(st, frames, ts, frames_pair=bad)


# ---------------------------------------------------------------------------
# On the card: the captured graph
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured stereo graph runs "
                    "on the card only")
    return torch.device("cuda")


@pytest.mark.card
def test_stereo_graph_equals_eager_steps_on_the_card(card, tmp_path):
    """16 stereo frames as two replays of the captured N=8 graph give the
    eager step_donated(..., pair)'s state and outputs bit for bit on the
    card: one capture, two replays, 16 pairs counted, none unpaired, and
    the `vo.stereo` stage timed inside the graph."""
    p = REBVOParameters().replace(**CARD)
    mav = str(tmp_path / "mav0")
    write_euroc_vi(p, 17, mav, workers=4, stereo=True)
    items = list(DatasetSequence.euroc(mav, with_imu=False, stereo=True))
    c0 = obs.counters()
    fe = VOFrontend(p, device=card)
    graph = _run(fe, items, 16, 8, card)
    c1 = obs.counters()
    eager = _run(VOFrontend(p, device=card), items, 16, 0, card)
    assert _delta(c0, c1, "graph.captures") == 1
    assert _delta(c0, c1, "graph.replays") == 2
    assert _delta(c0, c1, "stereo.pairs") == 16
    assert _delta(c0, c1, "stereo.unpaired") == 0
    assert int(graph[1].stereo_num.max()) > 0
    staged = {r.name for r in obs.records() if r.device_ms is not None}
    assert {"vo.stereo", "vo.match_depth"} <= staged
    _assert_same(graph, eager, "stereo graph vs eager on the card")
