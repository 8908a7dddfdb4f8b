"""Solo-12 stance, the benchmark's `solo12` configuration
(benchmark/configs/solo12.json, cell `solo12.plan`), on the CPU.

- The reference's copy of the robot, benchmark/robots/solo12.urdf read by
  `benchmark/reference/kinematics.py`, has `robots.solo12`'s joints, joint
  placements and local Jacobians, and its limits are bench.py's stance
  range.
- The configuration's task is bench.py's stance task (its `build_config`
  run with stand-ins, no loik_tpu solve).
- The port's `DiffIkSolver.solve_refined(method="delta")`, driven as the
  benchmark drives it, meets the task and finds the float64 reference's
  optimum.
- The graph layer's node counters (`utils.graphs.copy_stats`' ``nodes``
  and ``phase_nodes``, taken at capture) and the benchmark's readers of
  them.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu_torch.model.kinematics import joint_jacobian
from loik_tpu_torch.utils import graphs
from loik_tpu_torch.utils import observability as obs

from tests.test_torch_graphs import fake_graphs, flagship, standin_loop  # noqa: F401
from tests.test_torch_tracing import FLAGSHIP_SMALL, CountingCapture, call

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
SEEDS = [3, 4294967311]
FEET = ["FL_KFE", "FR_KFE", "HL_KFE", "HR_KFE"]


@pytest.fixture(scope="module")
def bench():
    """The benchmark's modules (benchmark/ on the path while this file's
    tests run: a cell's request loop imports its modules by name)."""
    sys.path.insert(0, BENCH)
    try:
        import drive
        import inputs
        import run
        from reference import check, kinematics
        yield types.SimpleNamespace(drive=drive, inputs=inputs, run=run, check=check,
                                    kinematics=kinematics)
    finally:
        sys.path.remove(BENCH)


def cell_at(bench, B):
    cell = bench.inputs.load_cell("solo12.plan")
    cell.config["batch"] = B
    return cell


@pytest.mark.parametrize("seed", SEEDS)
def test_the_urdf_is_the_programs_robot(bench, seed):
    """Joint placements (world frame) and local Jacobians of every joint,
    in float64 at seeded stance configurations: the two models compose the
    same numbers in another order, so they agree to rounding (1e-12)."""
    cell = cell_at(bench, 8)
    robot = cell.robot
    tree = lt.robots.solo12("float64", device="cpu")
    assert robot.names == list(tree.joint_names)
    assert [j.nv for j in robot.joints] == list(tree.nvs)
    q = bench.inputs.configurations(cell, seed, 1, "cpu", dtype=torch.float64)[0]
    R, p = bench.kinematics.frames(robot, q)
    _, _, oR, op = tree.fwd_kinematics(q)
    assert float((R - oR).abs().max()) < 1e-12
    assert float((p - op).abs().max()) < 1e-12
    J = bench.kinematics.jacobians(robot, q)
    for i in range(tree.njoints):
        assert float((J[i] - joint_jacobian(tree, q, i)).abs().max()) < 1e-12, robot.names[i]


def test_the_urdf_limits_are_the_stance_range(bench):
    """bench.py:76-86: q0 = (0, 0.8, -1.6) on the front legs and (0, -0.8,
    1.6) on the hind legs, each joint moved by up to 0.3 rad."""
    q0 = [0, 0.8, -1.6] * 2 + [0, -0.8, 1.6] * 2
    joints = cell_at(bench, 8).robot.joints[1:]
    for j, c in zip(joints, q0):
        assert (j.lower, j.upper) == pytest.approx((c - 0.3, c + 0.3), abs=1e-12), j.name


def test_the_task_is_bench_stance_task(bench):
    """bench.py's `build_config("solo12", ...)` with the port's tree and a
    `make_problem` that keeps what it is given."""
    import bench as jax_bench

    kept = {}

    def make_problem(tree, links, A, b, lb, ub, dtype):
        kept.update(links=links, A=A, b=b, lb=lb, ub=ub)

    tree = lt.robots.solo12("float64", device="cpu")
    jax_bench.build_config("solo12", types.SimpleNamespace(dtype="float64", batch=4), np,
                           types.SimpleNamespace(solo12=lambda dtype: tree), make_problem,
                           np.float64)
    cell = cell_at(bench, 8)
    # the harness reads the file's numbers as float32, the program's precision
    A, b, lo, hi = bench.inputs.task_tensors(cell, torch.float32, "cpu")
    assert [tree.joint_names[i] for i in kept["links"]] == cell.links == ["root_joint"] + FEET
    assert torch.equal(A, torch.as_tensor(kept["A"], dtype=torch.float32))
    assert torch.equal(b, torch.as_tensor(kept["b"], dtype=torch.float32))
    assert (lo, hi) == (-12.0, 12.0)
    assert np.array_equal(kept["lb"], np.full(tree.nv, lo))
    assert np.array_equal(kept["ub"], np.full(tree.nv, hi))
    # each foot: the linear velocity of a point 0.16 m below the knee, zero rows 3-5
    assert not A[1:, 3:].any()


@pytest.mark.parametrize("seed", SEEDS)
def test_the_refined_solve_finds_the_reference_optimum(bench, seed):
    """The benchmark's plan call at B 16 on the CPU (float32 iterations,
    the float64 KKT step), judged by the float64 reference as `correct` is.
    The 18 task rows pin all 18 dofs (the box, +-12, is far from the
    optimum's |nu*| <= 1.1), so a converged answer is the optimum up to the
    task's conditioning.  Residual under 1e-5: ten times the configuration's
    tolerance, 1e-6, which a float32 answer's rounding (|nu| about 1, 2^-24
    relative, times |A J| <= 2.3) does not approach.  Relative error under
    1e-4: a residual at the tolerance moves a pinned answer by at most 1e-6
    over the task rows' smallest singular value, 0.039 in 4096 stance
    configurations, so 2.6e-5; the limit leaves four times that."""
    cell = cell_at(bench, 16)
    prog = bench.drive.Program(cell, "cpu")
    req = bench.drive.requests(prog, seed)
    res = req.call(0)
    ans = req.answer(0, res.nu, res.converged)
    x, solved = bench.check.optimum(cell.robot, cell.links, ans.q, prog.A, ans.b, prog.lo,
                                    prog.hi)
    j = bench.check.judge(cell.robot, cell.links, ans.q, prog.A, ans.b, prog.lo, prog.hi,
                          ans.nu, ans.converged, x, solved)
    conv = j.converged
    assert bool(conv.any()) and bool(solved[conv].all())
    assert float(j.residual[conv].max()) < 1e-5
    assert float(j.err[conv].max()) < 1e-4
    assert not bool(torch.isnan(res.nu).any())
    assert not bool(res.primal_infeasible.any())


# --------------------------------------------------------------------------- #
# the node counters and their readers
# --------------------------------------------------------------------------- #

def test_copy_stats_count_a_captures_nodes_by_phase(monkeypatch, fake_graphs, standin_loop):
    """Through the stand-in capture whose nodes are the aten operators it
    ran: the refined solve's tag holds its capture's nodes, split by phase
    as `Capture.phases` splits them, and replays add nothing."""
    counting = CountingCapture()
    monkeypatch.setattr(graphs, "_capture", counting)
    monkeypatch.setattr(graphs, "_capture_nodes", counting.nodes)
    monkeypatch.setattr(graphs, "CAPTURES", [])     # this process's other tests' captures
    tree, q, problem = flagship(B=4)
    # the replays count since the process started
    replays = graphs.copy_stats().get("solve_delta_duals", {}).get("replays", 0)
    call("solve_refined", tree, q, problem)
    cap = graphs.CAPTURES[-1]
    first = graphs.copy_stats()["solve_delta_duals"]
    assert first["nodes"] == cap.nodes > 0 and first["replays"] == replays
    split = {}
    for name, a, b in cap.phases:
        split[name] = split.get(name, 0) + b - a
    assert first["phase_nodes"] == split and sum(split.values()) == cap.nodes
    assert first["phase_nodes"]["solver.kkt64"] > 0
    captures = len(graphs.CAPTURES)
    call("solve_refined", tree, q, problem)                     # a replay
    again = graphs.copy_stats()["solve_delta_duals"]
    assert again["replays"] == replays + 1 and len(graphs.CAPTURES) == captures
    assert (again["nodes"], again["phase_nodes"]) == (first["nodes"], first["phase_nodes"])


def test_a_tag_whose_graphs_differ_in_nodes_has_no_count(bench, monkeypatch, fake_graphs,
                                                          standin_loop):
    """Two topologies under one tag: a graph each, whose nodes differ, so a
    replay's nodes are not known from the tag; the counters leave them out
    and the readers give None.  Another shape of one topology keeps them."""
    counting = CountingCapture()
    monkeypatch.setattr(graphs, "_capture", counting)
    monkeypatch.setattr(graphs, "_capture_nodes", counting.nodes)
    monkeypatch.setattr(graphs, "CAPTURES", [])
    tree, q, problem = flagship(B=4)
    call("solve_refined", tree, q, problem)
    call("solve_refined", tree, flagship(B=8)[1], problem)     # another shape
    assert len(graphs.CAPTURES) == 2
    stats = graphs.copy_stats()["solve_delta_duals"]
    assert stats["nodes"] == graphs.CAPTURES[0].nodes == graphs.CAPTURES[1].nodes
    ur5 = lt.robots.ur5("float32", device="cpu")
    q6 = torch.as_tensor(np.random.default_rng(1).uniform(-np.pi, np.pi, (4, 6)),
                         dtype=torch.float32)
    problem6 = lt.make_problem(ur5, (5,), b=np.array([[0, 0, 0.2, 0, 0, 0]]),
                               lb=-4 * np.ones(6), ub=4 * np.ones(6))
    lt.DiffIkSolver(ur5, lt.SolverParams(**FLAGSHIP_SMALL), (5,), problem=problem6,
                    fused=True).solve_refined(q6, method="delta")
    assert len(graphs.CAPTURES) == 3 and graphs.CAPTURES[2].nodes != graphs.CAPTURES[0].nodes
    stats = graphs.copy_stats()["solve_delta_duals"]
    assert "nodes" not in stats and "phase_nodes" not in stats and stats["replays"] >= 0
    ctx = stretch(2, ["solve_delta_duals", "solve_delta_duals"])
    for name in ("graph_nodes.plan", "kkt64_nodes.plan"):
        assert bench.run.metric_reader(name)(ctx) is None


def test_a_while_body_counts_in_the_phase_of_its_node(monkeypatch, fake_graphs):
    """A WHILE node whose body graph has 5 nodes, recorded in phase
    ``solver.loop``: the phases still add up to the capture's nodes."""
    counting = CountingCapture()
    monkeypatch.setattr(graphs, "_capture", counting)
    monkeypatch.setattr(graphs, "_capture_nodes", counting.nodes)
    monkeypatch.setattr(graphs, "_while_node", lambda device, pred, step, trips: (5, None))
    monkeypatch.setattr(graphs, "CAPTURES", [])
    tree, _, _ = flagship(B=4)

    def body(tree_, x):
        with obs.phase("solver.prepare"):
            x = x * 2.0
        with obs.phase("solver.loop"):
            x, _ = graphs.while_loop(lambda c: c[1] < 3, lambda c: (c[0] + 1.0, c[1] + 1),
                                     (x, torch.zeros(1)))
        return x + 1.0

    graphs.run("while_nodes_test", tree, (), body, (torch.ones(3),))
    cap = graphs.CAPTURES[-1]
    assert [lp.phase for lp in cap.loops] == ["solver.loop"]
    stats = graphs.copy_stats()["while_nodes_test"]
    assert stats["nodes"] == cap.nodes and sum(stats["phase_nodes"].values()) == cap.nodes
    top = {name: b - a for name, a, b in cap.phases if name == "solver.loop"}
    assert stats["phase_nodes"]["solver.loop"] == top["solver.loop"] + 5


def stretch(calls, tags):
    """A traced stretch of ``calls`` calls whose replay spans are ``tags``."""
    host = [dict(cat="user_annotation", name=f"graphs.replay:{t}", ts=10 * i, dur=5, tid=1)
            for i, t in enumerate(tags)]
    return types.SimpleNamespace(calls=calls, trace=types.SimpleNamespace(host=host))


STATS = {"solve_delta_duals": dict(calls=3, replays=3, nodes=700,
                                   phase_nodes={"solver.kkt64": 300, "solver.loop": 2,
                                                None: 398}),
         "other": dict(calls=1, replays=1, nodes=10, phase_nodes={"solver.fk": 10})}


@pytest.mark.parametrize("name,value", [("graph_nodes.plan", (2 * 700 + 10) / 2),
                                        ("kkt64_nodes.plan", 2 * 300 / 2)])
def test_the_node_readers(bench, monkeypatch, name, value):
    """Nodes a call over the stretch's replays, each tag at its count; a
    program without the counters (an older checkout) gives None."""
    read = bench.run.metric_reader(name)
    ctx = stretch(2, ["solve_delta_duals", "other", "solve_delta_duals"])
    monkeypatch.setattr(graphs, "copy_stats", lambda: STATS)
    assert read(ctx) == pytest.approx(value)
    assert read(stretch(2, [])) is None                         # no replay
    old = {t: {k: v for k, v in s.items() if k not in ("nodes", "phase_nodes")}
           for t, s in STATS.items()}
    monkeypatch.setattr(graphs, "copy_stats", lambda: old)
    assert read(ctx) is None
    monkeypatch.delattr(graphs, "copy_stats")
    assert read(ctx) is None
