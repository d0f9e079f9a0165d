"""The check fails the control and every fault a cell can have: the runs
below skip the harness's look for a card and drive the rest of a run on a
small scene, with the step replaced or broken underneath."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.calibrate import ReferenceAsProgram, altered_gradient, half_batch
from benchmark.programs.refine_step import Program
from benchmark.tests.small import CELLS, small_config


class Unchanged(Program):
    """A step that leaves the state as it was."""

    def step(self, cams, iteration):
        return self.params.points.new_zeros(())


def run(cell, make_program):
    return harness.run_cell(cell, 2**31 + 11, 0.2, False, device="cpu", config=small_config(CELLS[cell]),
                            make_program=make_program, log=lambda *a: None)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_in_tf32_is_not_correct(cell):
    out = run(cell, ReferenceAsProgram)
    assert out["correct"] is False
    assert out["checks"]["grad_gap"]["value"] > out["checks"]["grad_gap"]["limit"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_state_left_unchanged_is_not_correct(cell):
    out = run(cell, Unchanged)
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_altered_gradient_is_not_correct(cell):
    with altered_gradient():
        out = run(cell, Program)
    assert out["correct"] is False


def test_half_batch_is_not_correct():
    out = run("refine.body160.b4", half_batch)
    assert out["correct"] is False


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_program_is_correct(cell):
    assert run(cell, Program)["correct"] is True
