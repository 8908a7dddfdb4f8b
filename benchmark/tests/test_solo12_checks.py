"""The checks of `solo12.plan` at rehearsal size: a sound run is correct,
and each planted fault (`test_faults.py`'s) and each control
(`test_control.py`'s) comes out not correct against the cell's limits.
The cell's task pins every answer, so its program reads far below the
other plan cells and its limits are its own: this holds them to the same
proof."""

import pytest

import inputs
import loik_tpu_torch as lt
from test_control import _fails, _readings
from test_faults import _altered, _half, _run, _stale

CELL = "solo12.plan"


def test_a_sound_run_is_correct(capsys):
    out = _run(CELL, capsys, batch=128)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_a_broken_timed_path_is_not_correct(fault, capsys, monkeypatch):
    name = inputs.load_cell(CELL).traffic["entry"]
    monkeypatch.setattr(lt.DiffIkSolver, name, fault(getattr(lt.DiffIkSolver, name)))
    out = _run(CELL, capsys)
    assert out["correct"] is False, out["checks"]


def test_the_program_passes_at_a_test_size(capsys):
    limits = inputs.load_cell(CELL).limits
    for n in _readings(CELL, "program", capsys, seeds=(17, 18), batch=128):
        assert not _fails(n, limits), n


def test_the_float32_path_fails(capsys):
    limits = inputs.load_cell(CELL).limits
    for n in _readings(CELL, "float32", capsys, seeds=(17, 18), batch=128):
        assert _fails(n, limits), n


def test_flags_at_a_looser_tolerance_fail(capsys):
    limits = inputs.load_cell(CELL).limits
    for n in _readings(CELL, "float32", capsys, seeds=(17, 18), batch=128,
                       extra=("--tol-scale", "100")):
        assert n["residual"] > limits["residual"] or n["nu_err_p99"] > limits["nu_err_p99"], n


def test_the_bfloat16_reference_fails(capsys):
    limits = inputs.load_cell(CELL).limits
    for n in _readings(CELL, "bfloat16", capsys):
        assert _fails(n, limits), n
