"""Closed-loop position IK: the port's `solve_clik` and `DiffIkSolver.reach`
against loik_tpu's `solve_clik` on the CPU, in float64.

The same numpy-seeded start (panda_arm's neutral configuration), targets
(FK of neutral moved by 0.35 N(0, 1) tangent steps)
and problem go through both packages.  Measured over 20 ticks at B=5: q
within 2.3e-11, nu within 4.7e-13, the error history within 2.7e-13, flags
and iteration counts equal; the tests hold q, nu and the history to 1e-9,
pos_err/rot_err to 1e-10 and every flag and count to equality.  loik_tpu
compiles one program per static setting (about 12 s on a CPU) and the port's
eager ticks cost about 0.5 s each, so the runs are short (6 ticks) and the
iteration cap is 30; the self-heal run shares the first run's compiled
program (bounds are data, the cap is not).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu import make_problem as jmake_problem
from loik_tpu.model import robots as jrobots
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver.clik import solve_clik as jclik
from loik_tpu_torch import convert
from loik_tpu_torch.solver.state import init_state

clik = sys.modules["loik_tpu_torch.solver.clik"]

B, STEPS = 5, 6
PARAMS = dict(max_iter=30, tol_abs=1e-6, tol_rel=1e-6)
RUN = dict(dt=0.1, steps=STEPS, gain=4.0)


def _setup(seed=0):
    """(jax tree, port tree, q0, target R, target p, link): the targets are
    computed once (by the port) and fed to both packages as numpy arrays."""
    jt = jrobots.panda_arm()
    tt = convert.tree_from_arrays(jt, device="cpu")
    q0 = np.broadcast_to(np.asarray(jt.neutral()), (B, jt.nq)).copy()
    dq = 0.35 * np.random.default_rng(seed).normal(size=(B, jt.nv))
    _, _, oR, op = tt.fwd_kinematics(tt.integrate(torch.as_tensor(q0), torch.as_tensor(dq)))
    ee = jt.njoints - 1
    return jt, tt, q0, oR[:, ee].numpy(), op[:, ee].numpy(), ee


def _run_both(jt, tt, q0, tR, tp, ee, jproblem=None, **kw):
    run = dict(RUN, **kw)
    res_j = jclik(jt, JParams(**PARAMS), jnp.asarray(q0), tR, tp, link=ee,
                  problem=jproblem, **run)
    tproblem = None if jproblem is None else convert.problem_from_arrays(jproblem, device="cpu")
    res_t = lt.solve_clik(tt, lt.SolverParams(**PARAMS), torch.as_tensor(q0),
                          torch.as_tensor(tR), torch.as_tensor(tp), ee,
                          problem=tproblem, fused=False, **run)
    return res_t, res_j


def assert_same(res_t, res_j):
    for name in ("q", "nu", "err_history"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(), np.asarray(getattr(res_j, name)),
                                   rtol=0, atol=1e-9, err_msg=name)
    for name in ("pos_err", "rot_err"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(), np.asarray(getattr(res_j, name)),
                                   rtol=0, atol=1e-10, err_msg=name)
    for name in ("reached", "converged", "iterations"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                      np.asarray(getattr(res_j, name)), err_msg=name)
    assert res_t.err_history.shape == (STEPS, B)


@pytest.fixture(scope="module")
def free_run():
    """(setup, port result, loik_tpu result) of the run with the model's
    velocity limits as bounds."""
    setup = _setup()
    return setup, *_run_both(*setup)


def test_clik_matches_reference(free_run):
    _, res_t, res_j = free_run
    assert_same(res_t, res_j)
    hist = res_t.err_history.numpy()
    assert (hist[-1] < 0.2 * hist[0]).all()          # the error contracts


def test_clik_warm_continuation_matches_one_run(free_run):
    """Two runs of STEPS/2 ticks, the second from the first's q and state,
    equal loik_tpu's one run of STEPS ticks."""
    (jt, tt, q0, tR, tp, ee), _, res_j = free_run
    run = dict(RUN, steps=STEPS // 2, fused=False)
    params = lt.SolverParams(**PARAMS)
    a = lt.solve_clik(tt, params, torch.as_tensor(q0), torch.as_tensor(tR),
                      torch.as_tensor(tp), ee, **run)
    b = lt.solve_clik(tt, params, a.q, torch.as_tensor(tR), torch.as_tensor(tp), ee,
                      warm_state=a.state, **run)
    np.testing.assert_allclose(b.q.numpy(), np.asarray(res_j.q), rtol=0, atol=1e-9)
    np.testing.assert_allclose(torch.cat([a.err_history, b.err_history]).numpy(),
                               np.asarray(res_j.err_history), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(b.iterations.numpy(), np.asarray(res_j.iterations))


def test_reach_equals_solve_clik(free_run):
    (_, tt, q0, tR, tp, ee), res_t, _ = free_run
    solver = lt.DiffIkSolver(tt, lt.SolverParams(**PARAMS), (ee,), fused=False)
    res = solver.reach(torch.as_tensor(q0), torch.as_tensor(tR), torch.as_tensor(tp), **RUN)
    for name in ("q", "nu", "err_history", "pos_err", "rot_err", "reached", "iterations"):
        assert torch.equal(getattr(res, name), getattr(res_t, name)), name
    assert solver.state is None                        # reach keeps its own warm state
    with pytest.raises(ValueError, match="no constraint at link 3"):
        solver.reach(torch.as_tensor(q0), torch.as_tensor(tR), torch.as_tensor(tp), link=3)


def test_clik_self_heals_after_infeasible_phase(monkeypatch):
    """Tight bounds (+-0.5) and uncapped commands: the approach ticks' QPs
    are infeasible, those problems restart cold on the next tick, and the
    loop matches loik_tpu's, which heals the same way."""
    jt, tt, q0, tR, tp, ee = _setup(seed=7)
    masks = []
    heal = clik._heal

    def recording(conv, st, cold):
        masks.append(conv.clone())
        return heal(conv, st, cold)

    monkeypatch.setattr(clik, "_heal", recording)
    ub = 0.5 * np.ones(jt.nv)
    res_t, res_j = _run_both(jt, tt, q0, tR, tp, ee, jmake_problem(jt, (ee,), lb=-ub, ub=ub))
    assert_same(res_t, res_j)
    conv = torch.stack(masks)                          # (T, B)
    print("converged per tick:", conv.int().tolist())
    assert not conv[0].any()                           # infeasible first
    # a problem that failed a tick and converged on a later one
    assert (~conv[:-1] & conv[1:]).any()


def test_clik_respects_velocity_bounds(monkeypatch):
    """The commanded twist is gain * err capped at 0.3 in inf-norm, and the
    problems whose last tick converged move inside the +-0.5 box.  (Held
    to the port's own ticks: one more loik_tpu setting would cost this file
    another 15 s of compilation.)"""
    _, tt, q0, tR, tp, ee = _setup(seed=7)
    commands = []
    solve_impl = clik._solve_impl

    def recording(tree, params, q, prob, st):
        commands.append(prob.b[:, 0].clone())
        return solve_impl(tree, params, q, prob, st)

    monkeypatch.setattr(clik, "_solve_impl", recording)
    ub = 0.5 * torch.ones(tt.nv, dtype=torch.float64)
    run = dict(RUN, max_task_velocity=0.3, fused=False)
    res = lt.solve_clik(tt, lt.SolverParams(**PARAMS), torch.as_tensor(q0), torch.as_tensor(tR),
                        torch.as_tensor(tp), ee, problem=lt.make_problem(tt, (ee,), lb=-ub, ub=ub),
                        **run)
    v = torch.stack(commands)                                    # (T, B, 6)
    err = res.err_history                                        # (T, B) |gain err|/gain
    assert len(commands) == STEPS
    np.testing.assert_allclose(v.abs().amax(-1).numpy(),
                               torch.clamp(RUN["gain"] * err, max=0.3).numpy(), rtol=1e-12)
    conv = res.converged
    assert conv.any()
    assert float(res.nu[conv].abs().max()) <= 0.5 + 1e-6


@pytest.mark.parametrize("B_", [1, 5, 9])
def test_self_heal_takes_the_cold_state_on_the_last_axis(B_):
    """Every per-problem field has the batch last: a (B,) mask picks
    problem by problem, whatever B is against N = nv = 7 and 6."""
    tree = lt.robots.panda_arm(device="cpu")
    gen = torch.Generator().manual_seed(B_)
    cold = init_state(tree, B_, 1, torch.float64, "cpu")
    st = clik.dataclasses.replace(cold, **{
        name: torch.rand(getattr(cold, name).shape, generator=gen, dtype=torch.float64)
        if getattr(cold, name).is_floating_point() else ~getattr(cold, name)
        if getattr(cold, name).dtype == torch.bool else getattr(cold, name) + 3
        for name in ("vis", "nu", "w", "yis", "liMi_R", "mu", "converged", "iterations", "it")})
    conv = torch.arange(B_) % 2 == 0
    healed = clik._heal(conv, st, cold)
    for name in ("vis", "nu", "w", "yis", "liMi_R", "mu", "converged", "iterations"):
        got, warm, c = getattr(healed, name), getattr(st, name), getattr(cold, name)
        assert torch.equal(got[..., conv], warm[..., conv]), name
        assert torch.equal(got[..., ~conv], c[..., ~conv]), name
    assert torch.equal(healed.it, st.it)                 # the scalar is kept


def test_clik_rejects_mismatched_problem_and_logging():
    tree = lt.robots.panda_arm(device="cpu")
    q0 = tree.neutral()
    with pytest.raises(ValueError, match="exactly one constraint at link 6"):
        lt.solve_clik(tree, lt.SolverParams(**PARAMS), q0, torch.eye(3), torch.zeros(3), 6,
                      problem=lt.make_problem(tree, (0,)))
    with pytest.raises(ValueError, match="reach\\(\\) needs"):
        lt.DiffIkSolver(tree, lt.SolverParams(), (3, 6)).reach(q0, torch.eye(3),
                                                               torch.zeros(3), link=6)
    with pytest.raises(ValueError, match="keeps no per-tick logs.*debug_mirror"):
        lt.solve_clik(tree, lt.SolverParams(logging=True), q0, torch.eye(3), torch.zeros(3), 6)
    with pytest.raises(ValueError, match="steps must be"):
        lt.solve_clik(tree, lt.SolverParams(), q0, torch.eye(3), torch.zeros(3), 6, steps=0)
