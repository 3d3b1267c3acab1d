"""Each cell, driven on the CPU at a small size past the look for a
card, comes out correct as it stands and not correct with the timed
path broken underneath it (each fault switched on once set-up is
done): a step that returns its state unchanged, an answer altered where
it is produced, in the batch half of the lanes left out, and in the
embedded system a keyframe store or a pose-graph log that is not
written."""

import pytest
import torch

from rebvo_tpu_torch.backend import keyframe as program_keyframe
from rebvo_tpu_torch.backend import posegraph as program_posegraph
from rebvo_tpu_torch.frontend import step as program_step
from rebvo_tpu_torch.parallel import mesh as program_mesh
from vobench import run
from vobench.tests.small import SMALL

torch.set_num_threads(2)

CELLS = ["euroc_mono.replay", "euroc_mono.live", "euroc_mono.batch16"]
# check the two units right after the window
CHECK = {"check": {"units": 2, "spacing": 1}}


def clone(tree):
    return program_step.tree_map(torch.clone, tree)


def stuck(orig, active):
    """The step computes its outputs but returns its input state."""
    def step(self, state, *a, **k):
        new, out = orig(self, clone(state), *a, **k)
        return (state if active[0] else new), out
    return step


def altered(orig, active):
    """The step's position output moved by 1 mm where it is produced."""
    def step(self, state, *a, **k):
        new, out = orig(self, state, *a, **k)
        if active[0]:
            out = out._replace(nav=out.nav._replace(Pos=out.nav.Pos + 1e-3))
        return new, out
    return step


def half_lanes(real, active):
    """shard_sequences whose step leaves the second half of the lanes
    where they were."""
    def shard(fn, m):
        go = real(fn, m)

        def call(*args):
            out = go(*args)
            if not (active[0] and isinstance(out, tuple)):
                return out
            states, outs = out

            def keep(new, old):
                h = new.shape[0] // 2
                return torch.cat([new[:h], old[h:]])
            return ([program_step.tree_map(keep, s, o)
                     for s, o in zip(states, args[0])], outs)
        return call
    return shard


def skipped(orig, active):
    """A host write of the embedded system that does nothing."""
    def write(*a, **k):
        return None if active[0] else orig(*a, **k)
    return write


def drive(cell, monkeypatch, fault):
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
    if fault in ("stuck", "altered"):
        wrap = stuck if fault == "stuck" else altered
        monkeypatch.setattr(VF, "step_donated", wrap(VF.step_donated, active))
    elif fault == "half_lanes":
        monkeypatch.setattr(program_mesh, "shard_sequences",
                            half_lanes(program_mesh.shard_sequences, active))
    elif fault == "no_push":
        monkeypatch.setattr(program_keyframe, "push_keyframe",
                            skipped(program_keyframe.push_keyframe, active))
    elif fault == "no_log":
        PGL = program_posegraph.PoseGraphLog
        monkeypatch.setattr(PGL, "add_frame_meas",
                            skipped(PGL.add_frame_meas, active))
    return run.run_cell(cell, 4_000_000_007, 1.0, False, "cpu",
                        params_update=SMALL, traffic_update=CHECK)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, monkeypatch):
    r = drive(cell, monkeypatch, None)
    assert r["run"]["units_checked"] == 2
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["stuck", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    r = drive(cell, monkeypatch, fault)
    assert r["run"]["units_checked"] == 2
    assert not r["correct"], r["checks"]


def test_half_the_lanes_is_not_correct(monkeypatch):
    r = drive("euroc_mono.batch16", monkeypatch, "half_lanes")
    assert r["run"]["units_checked"] == 2
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["no_push", "no_log"])
def test_system_write_skipped_is_not_correct(fault, monkeypatch):
    r = drive("euroc_mono.live", monkeypatch, fault)
    assert r["run"]["units_checked"] == 2
    assert not r["correct"], r["checks"]
