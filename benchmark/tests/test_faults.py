"""A whole run (the rehearsal: every step but the look for a card) with the
timed path broken underneath: `correct` has to come out false."""

import dataclasses
import json

import pytest

import inputs
import loik_tpu_torch as lt
import run

CELLS = ("panda_arm.plan", "panda_arm.track", "talos.plan", "talos.track")


def _run(workload, capsys, batch=8, seconds=0.5):
    """One rehearsal; a fault shows at any batch, a sound run's share of
    missed problems needs a batch of some hundred problems to settle."""
    rc = run.main(["--workload", workload, "--seed", "3141592653589", "--seconds",
                   str(seconds), "--rehearse", "--batch", str(batch)])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(line.split(": ", 1)[1])


def _stale(orig):
    """Every call answers with the previous call's result: a step that
    leaves its state unchanged."""
    last = []

    def call(self, *a, **k):
        res = orig(self, *a, **k)
        last.append(res)
        return last[-2] if len(last) > 1 else res
    return call


def _half(orig):
    """Half of the batch left out: no answer for its second half."""
    def call(self, *a, **k):
        res = orig(self, *a, **k)
        B = res.nu.shape[0]
        nu, conv = res.nu.clone(), res.converged.clone()
        nu[B // 2:] = 0.0
        conv[B // 2:] = False
        return dataclasses.replace(res, nu=nu, converged=conv)
    return call


def _altered(orig):
    """One answer altered where it is produced."""
    def call(self, *a, **k):
        res = orig(self, *a, **k)
        nu = res.nu.clone()
        i = int(res.converged.nonzero()[0, 0])
        nu[i, 0] += 0.05
        return dataclasses.replace(res, nu=nu)
    return call


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload, capsys):
    out = _run(workload, capsys, batch=128)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, capsys, monkeypatch):
    name = inputs.load_cell(workload).traffic["entry"]
    monkeypatch.setattr(lt.DiffIkSolver, name, fault(getattr(lt.DiffIkSolver, name)))
    out = _run(workload, capsys)
    assert out["correct"] is False, out["checks"]
