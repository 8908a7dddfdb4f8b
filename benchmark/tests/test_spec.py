import json
import os
import shutil
import subprocess
import sys

import pytest

import inputs
import run

SPEC = inputs.benchmark_spec()
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(SPEC) == TOP
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_lines():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    for n in names:
        assert inputs.NAME.match(n), n
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert inputs.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([c["source"] for c in SPEC["configs"]] + [c["why"] for c in SPEC["configs"]]
                 + [w["why"] for w in SPEC["workloads"]] + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_every_cell_finds_its_files_and_reports_enough():
    for w in SPEC["workloads"]:
        cell = inputs.load_cell(w["name"])
        assert cell.batch > 0 and cell.links
        e2e = run.cell_metrics(SPEC, "end_to_end", w["name"])
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        layer = run.cell_metrics(SPEC, "per_layer", w["name"])
        assert layer
        for m in e2e + layer:
            assert callable(run.metric_reader(m["name"]))
        for m in layer:       # each moves an end-to-end metric the cell reports
            assert m["moves"] in [e["name"] for e in e2e]
    for c in SPEC["configs"]:
        assert os.path.isfile(os.path.join(inputs.ROOT, c["file"]))
        assert inputs.read_json(os.path.join(inputs.ROOT, c["file"]))["reduced"] == c["reduced"]


def test_a_new_configuration_is_found_without_an_edit(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    shutil.copytree(inputs.HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = inputs.read_json(os.path.join(inputs.HERE, "configs", "panda_arm.json"))
    cfg["batch"] = 128
    (bench / "configs" / "panda_arm_b128.json").write_text(json.dumps(cfg))
    (bench / "limits" / "panda_arm_b128.plan.json").write_text('{"nu_err": 1, "missed": 1}')
    spec = dict(SPEC, workloads=SPEC["workloads"] + [
        dict(name="panda_arm_b128.plan", config="panda_arm_b128", traffic="plan", chips=1,
             why="test")])
    monkeypatch.setattr(inputs, "HERE", str(bench))
    cell = inputs.load_cell("panda_arm_b128.plan", spec)
    assert cell.batch == 128 and cell.traffic["entry"] == "solve_refined"
    with pytest.raises(FileNotFoundError):
        inputs.find("traffic", "no_such_mix")
    with pytest.raises(ValueError):
        inputs.find("configs", "../BENCHMARK")


def test_a_metric_reader_is_found_by_its_full_name_first(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "foo.py").write_text("def read(ctx):\n    return 1\n")
    (tmp_path / "metrics" / "foo.train.py").write_text("def read(ctx):\n    return 2\n")
    monkeypatch.setattr(run, "HERE", str(tmp_path))
    assert run.metric_reader("foo.plan")(None) == 1
    assert run.metric_reader("foo.train")(None) == 2
    with pytest.raises(FileNotFoundError):
        run.metric_reader("bar.plan")


# a request loop for an entry point the benchmark has no file for yet
PLAIN_SOLVE = """
import drive
import inputs

KEYS = {"pool"}


class Requests(drive.Requests):
    def __init__(self, prog, seed):
        self.prog = prog
        self.pool_ref = inputs.configurations(prog.cell, seed, int(prog.cell.traffic["pool"]),
                                              prog.device)
        self.pool = prog.to_program(self.pool_ref)
        solver = prog.solver()
        self.send = solver.solve

    def call(self, i):
        return self.send(self.pool[i % len(self.pool)])

    def answer(self, i, nu, converged):
        k = i % len(self.pool)
        return drive.Answer(self.prog.to_reference(nu), converged, self.pool_ref[k], self.prog.b)

    def units(self, converged):
        return converged.sum()

    def keep_key(self, i):
        return i % len(self.pool)

    def cycle(self):
        return len(self.pool)
"""


def test_a_new_traffic_mix_runs_without_an_edit(tmp_path):
    """A copy of the benchmark gains two mixes by new files alone: one of
    data on an entry point that has its request loop, and one on an entry
    point that brings its own (`entries/solve.py`).  Both run whole."""
    shutil.copytree(inputs.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tmp_path / "benchmark"
    (bench / "traffic" / "plan_small.json").write_text(
        json.dumps(dict(name="plan_small", entry="solve_refined", pool=3, solver={})))
    (bench / "traffic" / "plain.json").write_text(
        json.dumps(dict(name="plain", entry="solve", pool=2, solver={})))
    (bench / "entries" / "solve.py").write_text(PLAIN_SOLVE)
    limits = inputs.read_json(os.path.join(inputs.HERE, "limits", "panda_arm.plan.json"))
    new = []
    for mix in ("plan_small", "plain"):
        new.append(dict(name=f"panda_arm.{mix}", config="panda_arm", traffic=mix, chips=1,
                        why="test"))
        # the plain solve certifies nothing in float64: any answer is judged
        lim = limits if mix == "plan_small" else dict(residual=1.0, nu_err_p99=1.0, missed=1.0)
        (bench / "limits" / f"panda_arm.{mix}.json").write_text(json.dumps(lim))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(dict(SPEC, workloads=SPEC["workloads"]
                                                             + new)))
    for w in new:
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", w["name"],
                              "--seed", "4294967311", "--seconds", "0.3", "--rehearse",
                              "--batch", "8"], cwd=tmp_path, capture_output=True, text=True,
                             env=dict(os.environ, PYTHONPATH=inputs.ROOT), timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1].split(": ", 1)[1])
        assert line["correct"] is True and line["attempted"] > 0, line


@pytest.mark.parametrize("where,key", [("config", "H_ref"), ("task", "v_ref"),
                                       ("traffic", "kind")])
def test_a_key_that_nothing_reads_is_refused(tmp_path, monkeypatch, where, key):
    bench = tmp_path / "benchmark"
    shutil.copytree(inputs.HERE, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = inputs.read_json(os.path.join(inputs.HERE, "configs", "panda_arm.json"))
    mix = inputs.read_json(os.path.join(inputs.HERE, "traffic", "plan.json"))
    {"config": cfg, "task": cfg["task"], "traffic": mix}[where][key] = "identity"
    (bench / "configs" / "panda_arm.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "plan.json").write_text(json.dumps(mix))
    monkeypatch.setattr(inputs, "HERE", str(bench))
    with pytest.raises(ValueError, match=key):
        inputs.load_cell("panda_arm.plan")
