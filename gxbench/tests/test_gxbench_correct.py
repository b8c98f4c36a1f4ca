"""How ``correct`` is decided, at a size a CPU test can hold: the cells'
program (the port's plain CPU versions of its kernels) agrees with the
reference within the cells' limits; a run with its timed path broken
underneath comes out not correct, for each fault a training cell can
have; and the control, the reference in the configuration's next lower
precision put in the program's place, fails a limit."""

from __future__ import annotations

import time

import pytest

from gxbench import calibrate, faults, harness
from gxbench.tests.tiny import ENCODER, RESNET, tiny_cell

SEED = 2 ** 40 + 11


@pytest.mark.parametrize("name", [RESNET, ENCODER])
def test_the_program_agrees_with_the_reference(name):
    result, lines = harness.execute(tiny_cell(name), SEED, 0.5, False, "cpu",
                                    time.perf_counter())
    assert result["correct"], lines
    assert list(result)[-1] == "checks"
    limits = tiny_cell(name).workload["limits"]
    assert set(result["checks"]) == set(limits)
    assert lines[-1].split()[0] == list(result["checks"])[-1]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", [RESNET, ENCODER])
def test_a_broken_step_is_not_correct(name, fault):
    result, lines = harness.execute(tiny_cell(name), SEED, 0.2, False, "cpu",
                                    time.perf_counter(), fault=fault)
    assert not result["correct"], lines


@pytest.mark.parametrize("name", [RESNET, ENCODER])
def test_the_control_fails_a_limit(name):
    cell = tiny_cell(name)
    got = calibrate.seed_readings(cell, SEED, ["control"], "cpu")["control"]
    limits = cell.workload["limits"]
    assert any(not got[n] <= limits[n] for n in limits), got
