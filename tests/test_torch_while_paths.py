"""The entry points whose graphs hold the masked while loop as a WHILE node
(`utils.graphs.while_loop`), on the CPU through the stand-in capture of
tests/test_torch_graphs.py (`fake_graphs`: warm-up, a recorded call,
replays on the same static buffers; the WHILE node's stand-in runs the
captured body while its condition tensor holds).

- The recorded call of every newly captured body reads nothing on the host
  and copies no host data to the device (`HostReads`), on five trees:
  panda_arm, a planar mobile base, solo12, talos and the mixed chain.

Their replays against the eager calls: tests/test_torch_while_replay.py.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu_torch.utils import graphs

from test_torch_graphs import ROBOTS, assert_bits, b_sweep, task
from test_torch_graphs import fake_graphs  # noqa: F401  (a fixture)
from test_torch_while import setup

PLAIN = dict(max_iter=30, tol_abs=1e-4, tol_rel=1e-4, mu=0.1, mu_equality_scale_factor=1e5)
TRACK = dict(max_iter=30, tol_abs=1e-4, tol_rel=1e-4, warm_start=True)


@functools.lru_cache(maxsize=None)
def mixed_padded(B=6, seed=0, device="cpu"):
    """The mixed super-batch (B/2 UR5 + B/2 panda_arm) on ``device`` and its
    groups' q: one chain for every call (a graph's key holds its tree)."""
    if device != "cpu":
        mp, qs = mixed_padded(B, seed)
        chain = mp.chain.to(device=device)
        return (dataclasses.replace(mp, chain=chain, problem=_on(device, mp.problem)),
                _on(device, qs))
    rng = np.random.default_rng(seed)
    heave = np.array([[0, 0, 0.2, 0, 0, 0]])
    groups = []
    for name in ("ur5", "panda_arm"):
        t = lt.robots.get(name, "float32", device="cpu")
        qg = torch.as_tensor(rng.uniform(-np.pi, np.pi, (B // 2, t.nq)), dtype=torch.float32)
        groups.append((t, qg, lt.make_problem(t, (t.njoints - 1,), b=heave,
                                              lb=-4 * np.ones(t.nv), ub=4 * np.ones(t.nv))))
    mp = lt.parallel.prepare_mixed_padded([(t, B // 2, p) for t, _, p in groups])
    return mp, [g[1] for g in groups]


def _on(device, x):
    return graphs._map(lambda t: t.to(device), x)


@functools.lru_cache(maxsize=None)
def inputs(robot, B, device="cpu"):
    """(tree, q, problem, constraint links, end-effector link) on ``device``
    (one tree for every call)."""
    if device != "cpu":
        tree, q, problem, links, ee = inputs(robot, B)
        return tree.to(device=device), _on(device, q), _on(device, problem), links, ee
    if robot == "mobile_ur5":
        tree, q, problem = setup(robot, B=B)
        link = tree.joint_names.index("wrist_3_joint")
        return tree, q, problem, (link,), link
    return task(robot, B)


def run_new(name, robot="panda_arm", B=6, T=3, gen=None, device="cpu"):
    """One call of a newly captured entry point on ``robot``'s task
    (multistart: two batches drawn from ``gen``, a new seeded generator by
    default)."""
    if name in MIXED_PATHS:
        mp, qs = mixed_padded(B, device=device)
        params = lt.SolverParams(**PLAIN, check_interval=2)
        if name == "solve_packed":
            return mp.solve_packed(params, qs)
        stacked = [torch.stack([q, q.flip(0), 0.5 * q]) for q in qs]
        if name == "pack_q_stacked":
            return mp.pack_q_stacked(stacked)
        return mp.solve_scan(params, stacked)
    tree, q, problem, links, ee = inputs(robot, B, device)
    params = lt.SolverParams(**PLAIN)
    if name == "solve":
        return lt.solve(tree, params.replace(check_interval=2), q, problem)
    if name == "solve_init/resolve":
        solver = lt.DiffIkSolver(tree, params, links, problem=problem)
        solver.solve_init(q)
        return solver._liMi, solver.resolve()
    if name == "solve_two_stage":
        return lt.solve_two_stage(tree, params.replace(tol_abs=1e-6, tol_rel=1e-6), q, problem,
                                  stage1_max_iter=20, stage2_max_iter=8)
    if name == "solve_delta_refined":
        return lt.solve_delta_refined(tree, params, q, problem, stage2_max_iter=10)
    if name == "solve_delta_duals":
        return lt.solve_delta_duals(tree, params, q, problem, fused=False)
    if name == "solve_multistart":
        gen = gen or torch.Generator(device=device).manual_seed(5)
        return [lt.parallel.solve_multistart(tree, params, problem, gen, B, k=2)
                for _ in range(2)]
    track = lt.DiffIkSolver(tree, lt.SolverParams(**TRACK), links, problem=problem,
                            fused=False)
    if name == "solve_tracking":
        return [track.solve_tracking(q, links[0], b=b) for b in b_sweep(T).to(device)]
    if name == "track_scan":
        return track.track_scan(q, b_sweep(T).to(device), links[0])
    if name == "reach":
        dq = torch.as_tensor(0.35 * np.random.default_rng(1).normal(size=(B, tree.nv)),
                             dtype=torch.float32, device=device)
        _, _, oR, op = tree.fwd_kinematics(tree.integrate(q, dq))
        solver = lt.DiffIkSolver(tree, lt.SolverParams(max_iter=20, tol_abs=1e-4,
                                                       tol_rel=1e-4), (ee,), fused=False)
        return solver.reach(q, oR[:, ee].contiguous(), op[:, ee].contiguous(), steps=T,
                            dt=0.1, gain=2.0, max_task_velocity=0.5)
    raise KeyError(name)


PATHS = ["solve", "solve_init/resolve", "solve_two_stage", "solve_delta_refined",
         "solve_delta_duals", "solve_multistart", "solve_tracking", "track_scan", "reach"]
MIXED_PATHS = ["solve_packed", "solve_scan", "pack_q_stacked"]


@pytest.mark.parametrize("robot", ROBOTS)
@pytest.mark.parametrize("name", PATHS)
def test_captured_loops_read_nothing_on_the_host(name, robot, fake_graphs):  # noqa: F811
    """Every recorded call reads no device value on the host and copies no
    host data to the device; the solves hold WHILE nodes and launch no
    kernel."""
    n = len(graphs.CAPTURES)
    run_new(name, robot)
    assert fake_graphs.reads, "no capture happened"
    assert all(reads == [] for reads in fake_graphs.reads), fake_graphs.reads
    caps = graphs.CAPTURES[n:]
    assert any(c.loops for c in caps) and all(c.launches == 0 for c in caps)


@pytest.mark.parametrize("name", MIXED_PATHS)
def test_captured_mixed_paths_read_nothing_on_the_host(name, fake_graphs):  # noqa: F811
    run_new(name)
    assert fake_graphs.reads and all(reads == [] for reads in fake_graphs.reads)
    assert graphs.CAPTURES[-1].loops or name == "pack_q_stacked"
