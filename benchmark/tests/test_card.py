"""On the card: one short run of each cell, end to end (python -m pytest
benchmark/tests -m cuda)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["panda_arm.plan", "panda_arm.track", "talos.plan",
                                      "talos.track"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, workload, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", "2718281828459", "--seconds", "2", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["metrics"]
