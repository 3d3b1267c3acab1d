"""The cell euroc_stereo.replay on the CPU at a small size: the chunked
stereo runner (`runners/scan_stereo.py`: cam0's and cam1's frames of a
unit handed to step_scan together) driven past the look for a card
reads every gap 0 against the plain reference stepped on the pair, and
reads not correct with the pair broken underneath it once set-up is
done: dropped, a frame late, or swapped with cam0."""

import pytest
import torch

from rebvo_tpu_torch import obs
from rebvo_tpu_torch.frontend import step as program_step
from vobench import check, run
from vobench.tests.test_vobench_stereo import SEED, STEREO

torch.set_num_threads(2)

CELL = "euroc_stereo.replay"
# chunks of 4 frames; the two units after the window are checked
TRAFFIC = {"chunk": 4, "check": {"units": 2, "spacing": 1}}


def broken_pairs(orig, fault, active):
    """step_scan with cam1's frames dropped, each a frame late (the last
    of the previous call's first), or swapped with cam0's."""
    last = [None]

    def step_scan(self, state, frames, ts, wins=None, frames_pair=None):
        given = frames_pair
        if active[0]:
            if fault == "dropped":
                frames_pair = None
            elif fault == "late" and last[0] is not None:
                frames_pair = torch.cat([last[0][-1:], frames_pair[:-1]])
            elif fault == "swapped":
                frames, frames_pair = frames_pair, frames
        last[0] = given
        return orig(self, state, frames, ts, wins, frames_pair)
    return step_scan


def arm(monkeypatch, fault):
    """Patch the program so that `fault` acts once set-up is done."""
    active = [False]
    real_load = run.load_module

    def load(path):
        mod = real_load(path)
        if "runners" in path.parts and path.stem == "scan_stereo":
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
        monkeypatch.setattr(VF, "step_scan",
                            broken_pairs(VF.step_scan, fault, active))


def test_sound_run_reads_every_gap_zero(monkeypatch):
    arm(monkeypatch, None)
    c0 = obs.counters()
    r = run.drive(CELL, SEED, 1.0, False, "cpu", params_update=STEREO,
                  traffic_update=TRAFFIC)
    c1 = obs.counters()
    assert r.reading.images_per_frame == 2
    assert len(r.units) == 2 and r.failed == 0
    # every frame went to step_scan with its pair: 4 a unit
    units = 2 + r.reading.units + 2       # warm-up, window, checked
    assert c1["stereo.pairs"] - c0.get("stereo.pairs", 0) == 4 * units
    assert c1.get("stereo.unpaired", 0) == c0.get("stereo.unpaired", 0)
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
