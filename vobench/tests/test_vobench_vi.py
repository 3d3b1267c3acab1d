"""The visual-inertial cell, driven on the CPU at a small size past the
look for a card, comes out correct as it stands and not correct with
the timed path broken underneath it, each fault switched on once set-up
is done: each frame given the previous frame's IMU window, and a step
that returns the filter's state unchanged."""

import pytest
import torch

from rebvo_tpu_torch.frontend import step as program_step
from rebvo_tpu_torch.frontend.imu import ImuWindow
from vobench import run
from vobench.tests.small import SMALL

torch.set_num_threads(2)

CELL = "euroc_vi.replay"
# chunks of 4; set-up ends at frame_count 13, past the filter's start
# (frame_count 9 with InitBiasFrameNum 4); the two units after the
# window are checked
TRAFFIC = {"chunk": 4, "warm_units": 3, "max_frames": 200,
           "check": {"units": 2, "spacing": 1}}


def late_windows(orig, active):
    """step_scan whose frames each get the previous frame's window."""
    last = [None]

    def step_scan(self, state, frames, ts, wins=None):
        if wins is not None:
            given = wins
            if active[0] and last[0] is not None:
                wins = ImuWindow(*[torch.cat([a[None], b[:-1]])
                                   for a, b in zip(last[0], wins)])
            last[0] = ImuWindow(*[x[-1] for x in given])
        return orig(self, state, frames, ts, wins)
    return step_scan


def stuck_filter(orig, active):
    """A visual-inertial step that returns the filter's state as it was."""
    def step(self, state, *a, **k):
        imu = program_step.tree_map(torch.clone, state.imu)
        new, out = orig(self, state, *a, **k)
        return (new._replace(imu=imu) if active[0] else new), out
    return step


def drive(monkeypatch, fault):
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
    VF = program_step.VOFrontend
    if fault == "late_windows":
        monkeypatch.setattr(VF, "step_scan", late_windows(VF.step_scan,
                                                          active))
    elif fault == "stuck_filter":
        monkeypatch.setattr(VF, "step_imu_donated",
                            stuck_filter(VF.step_imu_donated, active))
    return run.run_cell(CELL, 4_000_000_007, 1.0, False, "cpu",
                        params_update=SMALL, traffic_update=TRAFFIC)


def test_sound_run_is_correct(monkeypatch):
    r = drive(monkeypatch, None)
    assert r["run"]["units_checked"] == 2
    assert r["failed"] == 0
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["late_windows", "stuck_filter"])
def test_fault_is_not_correct(fault, monkeypatch):
    r = drive(monkeypatch, fault)
    assert r["run"]["units_checked"] == 2
    assert not r["correct"], r["checks"]
