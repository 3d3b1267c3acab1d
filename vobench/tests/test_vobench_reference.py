"""The plain reference: its step at a small size against a recorded
expectation, and bit for bit against the program's step on the CPU
(where the program runs the same plain arithmetic)."""

import numpy as np
import pytest
import torch

from vobench import check, scene
from vobench.reference.config import REBVOParameters
from vobench.reference.core.geometry import CameraModel
from vobench.tests.small import SMALL

torch.set_num_threads(2)

# bootstrap on frame 0, then frames 1..5 of scene seed 11's period
# (188x120, tests/small.py): (kl_num, klm_num) of each frame and the
# last frame's Pos, as the reference gave them when it was frozen
RECORDED_COUNTS = [(2048, 1991), (2048, 2002), (2048, 1959), (2048, 1987),
                   (2048, 1887)]
RECORDED_POS = [0.0003097161534242332, 0.0012897850247099996,
                -0.0009914017282426357]


def small_params(**kw):
    return {**REBVOParameters().__dict__, **SMALL, **kw}


def frames_u8(n, seed=11):
    p = REBVOParameters(**small_params())
    pos, rot = scene.period_poses(scene.PathSpec(0.15, 0.5, 0.03, 0.5),
                                  p.config_fps)
    return scene.camera_frames(seed, pos[:n], rot[:n],
                               CameraModel.from_params(p), "cpu")


def test_reference_matches_recorded():
    ref = check.Reference(small_params(), "cpu", frames_u8(6)[None])
    frames = [(i, 1.0 + i / 20) for i in range(6)]
    _, outs = ref.run(0, None, frames, 0.0)
    got = list(zip(outs["out.nav.kl_num"][0].tolist(),
                   outs["out.nav.klm_num"][0].tolist()))
    assert got == RECORDED_COUNTS
    np.testing.assert_allclose(outs["out.nav.Pos"][0, -1].numpy(),
                               RECORDED_POS, rtol=0, atol=1e-7)


def _program_run(params, frames, imu):
    """The program's own step over the same frames: (state, outputs)."""
    from rebvo_tpu_torch.config import REBVOParameters as P
    from rebvo_tpu_torch.frontend.step import VOFrontend
    from rebvo_tpu_torch.io.dataset import (imu_window_size,
                                            slice_imu_windows)
    from rebvo_tpu_torch.io.undistort import (apply_undistort,
                                              build_undistort_map)
    p = P(**params)
    fe = VOFrontend(p, device="cpu")
    um = build_undistort_map(fe.cam, device="cpu")

    def f(i):
        return apply_undistort(um, frames[i].to(torch.float32) * 3.0)
    ts = [1.0 + i / 20 for i in range(len(frames))]
    wins = (slice_imu_windows(imu, ts, imu_window_size(p))
            if imu is not None else None)
    st = fe.bootstrap(fe.init(), f(0), ts[0])
    outs = []
    for i in range(1, len(frames)):
        if wins is not None:
            st, o = fe.step_imu_donated(st, f(i), ts[i], wins[i])
        else:
            st, o = fe.step_donated(st, f(i), ts[i])
        outs.append(o)
    return st, outs


@pytest.mark.parametrize("vi", [False, True])
def test_reference_equals_program_on_cpu(vi):
    n = 10 if vi else 5
    params = small_params(ImuMode=2 if vi else 0)
    fr = frames_u8(n)
    imu = None
    if vi:
        spec = scene.PathSpec(0.15, 0.5, 0.03, 0.5)
        hold = params["InitBiasFrameNum"] + 2
        imu = scene.imu_samples(spec, hold / 20, -0.1, n / 20, 1.0,
                                1.6968e-4, 2.0e-3, np.random.default_rng(4))
        idx = [scene.frame_index(i, hold, 40) for i in range(n)]
        fr = fr[idx] if max(idx) < len(fr) else fr
    st, outs = _program_run(params, fr, imu)
    ref = check.Reference(params, "cpu", fr[None], imu)
    rst, routs = ref.run(0, None, [(i, 1.0 + i / 20) for i in range(n)],
                         0.0)
    prog = {**check.snapshot(st, "state", None),
            **check.stack_named([check.snapshot(o, "out", None)
                                 for o in outs], 1)}
    g = check.gaps(prog, {**rst, **routs})
    assert g == dict.fromkeys(check.NUMBERS, 0.0), g


def test_reference_system_equals_program_on_cpu():
    """The system layer (keyframe store, pose-graph log, counters) of
    the program's VOSystem against the reference's, from the start and
    from the program's state after the first frames."""
    from rebvo_tpu_torch.config import REBVOParameters as P
    from rebvo_tpu_torch.io.undistort import (apply_undistort,
                                              build_undistort_map)
    from rebvo_tpu_torch.system import VOSystem
    from vobench.runners.system import Runner
    params = small_params()
    fr = frames_u8(8)
    sys_ = VOSystem(P(**params), device="cpu")
    um = build_undistort_map(sys_.frontend.cam, device="cpu")
    live = Runner.__new__(Runner)
    live.sys = sys_

    def step(i):
        live.out = sys_.process_frame(
            apply_undistort(um, fr[i].to(torch.float32) * 3.0),
            1.0 + i / 20)
    for i in range(5):
        step(i)
    ref = check.Reference(params, "cpu", fr[None], system=True)
    start = ref.run(0, None, [(i, 1.0 + i / 20) for i in range(5)], 0.0)[0]
    before = live.state()
    assert int(before["sys.kf.count"]) >= 1
    assert check.gaps(before, start) == dict.fromkeys(check.NUMBERS, 0.0)
    for i in range(5, 8):
        step(i)
    after, outs = ref.run(0, check.lane_state(before, 0),
                          [(i, 1.0 + i / 20) for i in range(5, 8)],
                          1.0 + 4 / 20)
    got = {**live.state(), **live.outputs()}
    want = {**after, **{k: v[:, -1:] for k, v in outs.items()}}
    assert check.gaps(got, want) == dict.fromkeys(check.NUMBERS, 0.0)


def test_reordered_sums_read_nothing_on_cpu():
    """The reference with its float64 sums in reverse order steps as the
    reference does (the stand-in of a sound reordering change)."""
    params = small_params()
    fr = frames_u8(4)
    frames = [(i, 1.0 + i / 20) for i in range(4)]
    a = check.Reference(params, "cpu", fr[None]).run(0, None, frames, 0.0)
    b = check.Reference(params, "cpu", fr[None], variant="reorder").run(
        0, None, frames, 0.0)
    assert check.gaps({**b[0], **b[1]}, {**a[0], **a[1]}) == \
        dict.fromkeys(check.NUMBERS, 0.0)


def test_gaps_read_each_layer():
    """A planted difference in one leaf moves its own number."""
    base = {"state.klm.valid": torch.tensor([[True, True, False]]),
            "state.klm.x": torch.zeros(1, 3), "state.klm.y": torch.zeros(1, 3),
            "state.klm.rho": torch.ones(1, 3), "state.Pos": torch.zeros(1, 3),
            "state.imu.X7": torch.ones(1, 7), "out.nav.Vel": torch.zeros(1, 1, 3),
            "out.nav.RotLie": torch.zeros(1, 1, 3),
            "out.nav.kl_num": torch.tensor([[5]], dtype=torch.int32)}
    for key, delta, number, want in [
            ("state.klm.x", 0.5, "keyline_gap_px", 0.5),
            ("state.klm.rho", 0.25, "rho_gap", 0.25),
            ("state.Pos", 0.01, "pos_gap_m", 0.01),
            ("out.nav.Vel", 0.02, "vel_gap_mps", 0.02),
            ("out.nav.RotLie", 0.003, "rot_gap_rad", 0.003),
            ("state.imu.X7", 0.5, "imu_filter_gap", 0.5 / (1.5 + 1 + 1)),
            ("out.nav.kl_num", 2, "count_gap", 2.0)]:
        prog = {k: v.clone() for k, v in base.items()}
        prog[key] = prog[key] + delta
        g = check.gaps(prog, base)
        assert g[number] == pytest.approx(want), (key, g)
    # a keyline the reference does not hold is not compared
    prog = {k: v.clone() for k, v in base.items()}
    prog["state.klm.x"][0, 2] = 99.0
    assert check.gaps(prog, base)["keyline_gap_px"] == 0.0
    nan = {k: v.clone() for k, v in base.items()}
    nan["state.Pos"][0, 0] = float("nan")
    assert check.gaps(nan, base)["pos_gap_m"] == float("inf")
