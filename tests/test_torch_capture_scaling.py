"""tools/capture_scaling.py, the counterpart of tools/compile_scaling.py,
on the CPU: ``--device cpu`` counts the operators a call and a body call
dispatch, which grow with the joint count, and prints one line per size
and one JSON line; without a card and without ``--device cpu`` it raises.
And `graphs.Capture` splits a first call into its parts, filled under the
stand-in capture of tests/test_torch_graphs.py on the tool's own chain.
"""

import json
import os
import runpy

import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu_torch.utils import graphs

from tests.test_torch_graphs import fake_graphs  # noqa: F401  (a fixture)

TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                    "capture_scaling.py")


@pytest.fixture(scope="module")
def tool():
    return runpy.run_path(TOOL, run_name="capture_scaling")


def test_counts_grow_with_the_joint_count(tool, capsys):
    tool["main"](["--device", "cpu", "--sizes", "3", "5", "--b", "4", "--step"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# graph capture, B=4") and "counts only" in lines[0]
    assert [ln.split()[0] for ln in lines[1:3]] == ["njoints=", "njoints="]
    out = json.loads(lines[-1])
    assert out["device"] == "cpu" and out["card"] is None and len(lines) == 4
    rows = {(r["njoints"], r["path"]): r for r in out["rows"]}
    assert set(rows) == {(n, p) for n in (3, 5) for p in ("solve", "solve_fused", "step")}
    for path in ("solve", "step"):
        small, tall = rows[3, path], rows[5, path]
        assert 0 < small["ops_per_body"] < tall["ops_per_body"]
        assert 0 < small["views_per_body"] < tall["views_per_body"]
        assert small["ops_per_body"] < small["ops"]
    assert rows[3, "solve_fused"]["ops"] < rows[5, "solve_fused"]["ops"]
    assert all("first_call_s" not in r for r in out["rows"])      # no card, no times


def test_without_a_card_it_raises(tool):
    with pytest.raises(SystemExit, match="no CUDA card"):
        tool["main"](["--sizes", "3"])


def test_capture_records_warm_record_and_instantiate(tool, fake_graphs):
    """On the tool's chain, the plain solve's first graphed call records
    its warm-up, its recorded body (a WHILE node's stand-in) and its
    instantiation (the stand-in has none: 0); their sum is ``seconds``."""
    tree, problem, q, params = tool["task"](4, 4, torch.device("cpu"))
    n = len(graphs.CAPTURES)
    lt.solve(tree, params, q, problem)
    assert len(graphs.CAPTURES) == n + 1
    c = graphs.CAPTURES[-1]
    assert c.tag == "solve" and c.warm_seconds > 0 and c.record_seconds > 0
    assert c.instantiate_seconds == 0.0
    assert c.warm_seconds + c.record_seconds + c.instantiate_seconds == c.seconds
