"""Every example of the port (`examples/torch/0N_*.py`) runs to its end on
the CPU (``--device cpu``; ``--quick``, shorter horizons, for the three
examples in `QUICK`).  The seven run as concurrent subprocesses, started
once for the module, each with its own time limit."""

import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "torch", "0*.py")))
TIMEOUT_S = 150
# the examples that take --quick (shorter horizons)
QUICK = {"02_tracking_loop.py", "06_differentiable_ik.py", "07_position_ik.py"}


def _args(path):
    quick = ["--quick"] if os.path.basename(path) in QUICK else []
    return [sys.executable, path, "--device", "cpu"] + quick


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {os.path.basename(p): subprocess.Popen(
        _args(p), cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for p in EXAMPLES}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def test_the_seven_examples_exist():
    assert [os.path.basename(p)[:3] for p in EXAMPLES] == [f"0{i}_" for i in range(1, 8)]


@pytest.mark.parametrize("name", [os.path.basename(p) for p in EXAMPLES])
def test_example_runs_on_cpu(runs, name):
    proc = runs[name]
    try:
        out = proc.communicate(timeout=TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        out = proc.communicate()[0]
        pytest.fail(f"{name} did not finish in {TIMEOUT_S} s:\n{out[-2000:]}")
    assert proc.returncode == 0, f"{name} exited {proc.returncode}:\n{out[-2000:]}"
    assert out.strip(), f"{name} printed nothing"
