"""The harness on a stereo pair, on the CPU at a small size: cam1's
poses, the stereo runner driven past the look for a card (correct as it
stands, not correct with the pair broken underneath it once set-up is
done: dropped, a frame late, or swapped with cam0), the frozen
reference's stereo step bit for bit against the program's, the
reference's refusals, and K1's roofline counting both images."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rebvo_tpu_torch.frontend import step as program_step
from vobench import check, peaks, run, scene, trace
from vobench.metrics import _read
from vobench.reference.config import REBVOParameters
from vobench.reference.core.geometry import CameraModel
from vobench.tests.small import SMALL
from vobench.tests.test_vobench_metrics import synthetic_trace

torch.set_num_threads(2)

CELL = "euroc_mono.replay"
# SMALL scales cam0's intrinsics by 1/4 (752x480 -> 188x120); cam1's alike
_CAM1 = REBVOParameters(**run.load_cell(CELL).config["params"])
STEREO = dict(SMALL, StereoAvaiable=1, StereoZfX=_CAM1.StereoZfX / 4,
              StereoZfY=_CAM1.StereoZfY / 4, StereoPPx=_CAM1.StereoPPx / 4,
              StereoPPy=_CAM1.StereoPPy / 4)
# chunks of 4 frames stepped one at a time; the two units after the
# window are checked
TRAFFIC = {"runner": "stereo", "chunk": 4,
           "check": {"units": 2, "spacing": 1}}
SEED = 4_000_000_007


def stereo_params(**kw):
    return {**run.load_cell(CELL).config["params"], **STEREO, **kw}


def broken_pair(orig, fault, active):
    """step_donated with cam1's frame dropped, taken from the previous
    call, or swapped with cam0's."""
    last = [None]

    def step(self, state, frame, t, frame_pair=None):
        given = frame_pair
        if active[0]:
            if fault == "dropped":
                frame_pair = None
            elif fault == "late" and last[0] is not None:
                frame_pair = last[0]
            elif fault == "swapped":
                frame, frame_pair = frame_pair, frame
        last[0] = given
        return orig(self, state, frame, t, frame_pair)
    return step


def arm(monkeypatch, fault):
    """Patch the program so that `fault` acts once set-up is done."""
    active = [False]
    real_load = run.load_module

    def load(path):
        mod = real_load(path)
        if "runners" in path.parts:
            base = mod.Runner

            class Runner(base):
                def setup(self):
                    super().setup()
                    active[0] = True
            mod.Runner = Runner
        return mod
    monkeypatch.setattr(run, "load_module", load)
    if fault is not None:
        VF = program_step.VOFrontend
        monkeypatch.setattr(VF, "step_donated",
                            broken_pair(VF.step_donated, fault, active))


def test_sound_run_reads_every_gap_zero(monkeypatch):
    arm(monkeypatch, None)
    r = run.drive(CELL, SEED, 1.0, False, "cpu", params_update=STEREO,
                  traffic_update=TRAFFIC)
    assert r.reading.images_per_frame == 2
    assert r.frames_pair_u8.shape == r.frames_u8.shape
    assert len(r.units) == 2 and r.failed == 0
    # the pair is used: stereo matches on every checked frame
    for u in r.units:
        assert int(u.outs["out.stereo_num"].min()) > 0
    numbers, note = run.correctness(r)
    assert not note
    assert numbers == dict.fromkeys(check.NUMBERS, 0.0), numbers
    assert check.judge(numbers, r.cell.limits)


@pytest.mark.parametrize("fault", ["dropped", "late", "swapped"])
def test_broken_pair_is_not_correct(fault, monkeypatch):
    arm(monkeypatch, fault)
    r = run.run_cell(CELL, SEED, 1.0, False, "cpu", params_update=STEREO,
                     traffic_update=TRAFFIC)
    assert r["run"]["units_checked"] == 2
    assert not r["correct"], r["checks"]


def pair_frames(n, seed=11):
    """cam0's and cam1's first n period frames of scene seed `seed`."""
    p = REBVOParameters(**stereo_params())
    pos, rot = scene.period_poses(scene.PathSpec(0.15, 0.5, 0.03, 0.5),
                                  p.config_fps)
    pos1, rot1 = scene.pair_poses(*p.stereo_extrinsics(), pos[:n], rot[:n])
    return (scene.camera_frames(seed, pos[:n], rot[:n],
                                CameraModel.from_params(p), "cpu"),
            scene.camera_frames(seed, pos1, rot1,
                                CameraModel.from_params(p, stereo=True),
                                "cpu"))


def test_reference_stereo_equals_program_on_cpu():
    from rebvo_tpu_torch.config import REBVOParameters as P
    from rebvo_tpu_torch.frontend.step import VOFrontend
    from rebvo_tpu_torch.io.undistort import (apply_undistort,
                                              build_undistort_map)
    n = 6
    params = stereo_params()
    fr0, fr1 = pair_frames(n)
    fe = VOFrontend(P(**params), device="cpu")
    um0 = build_undistort_map(fe.cam, device="cpu")
    um1 = build_undistort_map(fe.cam_pair, device="cpu")

    def image(um, frames, i):
        return apply_undistort(um, frames[i].to(torch.float32) * 3.0)
    ts = [1.0 + i / 20 for i in range(n)]
    st = fe.bootstrap(fe.init(), image(um0, fr0, 0), ts[0],
                      image(um1, fr1, 0))
    outs = []
    for i in range(1, n):
        st, o = fe.step_donated(st, image(um0, fr0, i), ts[i],
                                image(um1, fr1, i))
        outs.append(o)
    assert min(int(o.stereo_num) for o in outs) > 0
    ref = check.Reference(params, "cpu", fr0[None], frames_pair=fr1[None])
    rst, routs = ref.run(0, None, list(zip(range(n), ts)), 0.0)
    prog = {**check.snapshot(st, "state", None),
            **check.stack_named([check.snapshot(o, "out", None)
                                 for o in outs], 1)}
    assert check.gaps(prog, {**rst, **routs}) == \
        dict.fromkeys(check.NUMBERS, 0.0)


def test_reference_refuses_a_stereo_check_without_the_pair():
    fr0, fr1 = pair_frames(1)
    with pytest.raises(ValueError, match="frames_pair"):
        check.Reference(stereo_params(), "cpu", fr0[None])
    with pytest.raises(ValueError, match="system"):
        check.Reference(stereo_params(), "cpu", fr0[None],
                        frames_pair=fr1[None], system=True)


def test_pair_poses_follow_the_program():
    from rebvo_tpu_torch.config import REBVOParameters as P
    from rebvo_tpu_torch.io import render
    params = stereo_params()
    pos, rot = scene.period_poses(scene.PathSpec(0.15, 0.5, 0.03, 0.5),
                                  20.0)
    want = render.pair_poses(P(**params), pos, rot)
    got = scene.pair_poses(*REBVOParameters(**params).stereo_extrinsics(),
                           pos, rot)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # cam1's centre lies the baseline away from cam0's (EuRoC: ~0.110 m)
    assert np.linalg.norm(got[0] - pos, axis=1) == pytest.approx(
        np.linalg.norm(REBVOParameters(**params).stereo_extrinsics()[1]))


def test_k1_roofline_counts_images():
    """A lane-frame of a stereo pair is two of K1's images: the same
    trace reads twice the share it reads for one image a frame."""
    s = trace.summarize(synthetic_trace())       # K1 busy 200 ns

    def reading(images):
        return SimpleNamespace(trace=s, traced_frames=2, height=480,
                               width=752, images_per_frame=images)
    mono = _read.k1_roofline_pct(reading(1))
    assert mono == pytest.approx(100 * peaks.k1_bound_s(2, 480, 752)
                                 / 200e-9)
    assert _read.k1_roofline_pct(reading(2)) == pytest.approx(2 * mono)
