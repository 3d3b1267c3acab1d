"""On the card, at each cell's own size: the program holds its limits
and the control (the reference in the program's place, its state and
frames rounded to bfloat16) fails at least one of them. The benchmark's
own runs never run the control; `python -m vobench.control` reads it on
many seeds."""

import pytest

from vobench import check, run

CELLS = ["euroc_mono.replay", "euroc_mono.live", "euroc_mono.batch16"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_holds(cell, card):
    r = run.drive(cell, 2_500_000_001, 4.0, False, card)
    limits = r.cell.limits
    prog, note = run.correctness(r)
    assert not note and r.units
    assert check.judge(prog, limits), prog
    ctrl, _ = run.correctness(r, "bf16")
    assert not check.judge(ctrl, limits), ctrl
