"""The controls at a size a test run holds: each has to come out not
correct against the cell's limits (on the card they run at the cells' own
sizes through `readings.py`)."""

import json

import pytest

import inputs
import readings


def _readings(workload, side, capsys, seeds=(17, 18, 19), batch=16, extra=()):
    rc = readings.main(["--workload", workload, "--side", side, "--seconds", "0.3",
                        "--cpu", "--batch", str(batch), *extra, "--seeds", *map(str, seeds)])
    assert rc == 0
    return [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]


def _fails(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("workload", ["panda_arm.plan", "talos.plan"])
def test_the_float32_path_fails_a_plan_cell(workload, capsys):
    limits = inputs.load_cell(workload).limits
    for n in _readings(workload, "float32", capsys, seeds=(17, 18), batch=128):
        assert _fails(n, limits), n


@pytest.mark.parametrize("workload", ["panda_arm.plan", "talos.plan"])
def test_flags_at_a_looser_tolerance_fail_a_plan_cell(workload, capsys):
    """The float32 path at a hundred times the stated tolerance: answers
    flagged converged that tol 1e-6 and the float64 step do not certify."""
    limits = inputs.load_cell(workload).limits
    for n in _readings(workload, "float32", capsys, seeds=(17, 18), batch=128,
                       extra=("--tol-scale", "100")):
        assert n["residual"] > limits["residual"] or n["nu_err_p99"] > limits["nu_err_p99"], n


def test_a_traffic_key_is_drawn_per_seed(capsys):
    ns = _readings("panda_arm.track", "program", capsys, seeds=(5, 6), batch=8,
                   extra=("--seed-key", "fleet_seed"))
    assert [n["fleet_seed"] for n in ns] == [5, 6]


@pytest.mark.parametrize("workload", ["panda_arm.plan", "panda_arm.track", "talos.plan",
                                      "talos.track"])
def test_the_bfloat16_reference_fails_every_cell(workload, capsys):
    limits = inputs.load_cell(workload).limits
    for n in _readings(workload, "bfloat16", capsys):
        assert _fails(n, limits), n


@pytest.mark.parametrize("workload", ["panda_arm.plan", "talos.track"])
def test_the_program_passes_at_a_test_size(workload, capsys):
    limits = inputs.load_cell(workload).limits
    for n in _readings(workload, "program", capsys, batch=256):
        assert not _fails(n, limits), n
