"""The mono and visual-inertial cells' inputs are the bytes they have
always been: SHA-256 of `make_inputs`' frames and IMU rows at the small
size (tests/small.py), recorded before the harness learnt to render
cam1, and no cam1 frames for a configuration that is not stereo."""

import hashlib

import numpy as np
import pytest
import torch

from vobench import run
from vobench.tests.small import SMALL

torch.set_num_threads(2)

SEED = 4_000_000_007
# cell, traffic update, SHA-256 of the frames, of the IMU rows (or None)
RECORDED = [
    ("euroc_mono.replay", {},
     "16a7385ab99fa75226bd5c09323d88be69d3ed16a58824c69d9e491abae114f3",
     None),
    ("euroc_mono.batch16", {"lanes": 2},
     "6a71be1b85eb79b810395b1103225be52b4d52e7ad6082a5ef685048a632f765",
     None),
    ("euroc_vi.replay", {},
     "16a7385ab99fa75226bd5c09323d88be69d3ed16a58824c69d9e491abae114f3",
     "6779fa272339ec0bff1e3da7e5f1ca3208256da2e2ff98704f850dc22835bfdd"),
]


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("cell,update,frames_sha,imu_sha", RECORDED,
                         ids=[r[0] for r in RECORDED])
def test_inputs_are_unchanged(cell, update, frames_sha, imu_sha):
    c = run.load_cell(cell)
    inp = run.make_inputs({**c.config["params"], **SMALL},
                          {**c.traffic, **update}, SEED, "cpu")
    assert inp.frames.dtype == torch.uint8
    assert sha(inp.frames.numpy()) == frames_sha
    assert (None if inp.imu is None else sha(inp.imu)) == imu_sha
    assert inp.pair is None
