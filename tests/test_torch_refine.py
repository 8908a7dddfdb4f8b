"""The flagship tight-tolerance path: the port's `solve_delta_duals`
against loik_tpu's `solve_delta_duals(fused=False)` at the flagship
settings (B=64), the float64 task residual of every problem it certifies,
and `DiffIkSolver` against the functional forms.  The legged robots go
through the same checks in tests/test_torch_legged.py.

Budgets, as in tests/test_torch_fused.py: the North-star outcome budget
where both packages do the same arithmetic (loik_tpu op by op, the port fed
loik_tpu's FK); against loik_tpu's compiled program, whose FMA-contracted
float32 stage 1 lands on other iteration counts at the f32 floor (measured:
equal on 62-73% of problems, the same as loik_tpu against itself with q
moved by one ulp, 56-78%), the counts are held to one check interval.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
import loik_tpu_torch.solver.solve  # noqa: F401  (the module; the package exports a function)
from loik_tpu.model import robots as jrobots
from loik_tpu.model.kinematics import frame_velocity
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver.refine import solve_delta_duals as jdelta
from loik_tpu_torch.solver.refine import solve_delta_duals

from tests.test_torch_model import FLAGSHIP, LEGGED, LEGGED_K, pair, q_batch, shared_fk

tsm = sys.modules["loik_tpu_torch.solver.solve"]


def certified(res, q, robot, jp):
    """Max float64 task error |A v - b| over every constraint and box
    violation over the problems flagged converged, the link velocities
    recomputed from (q, nu) by loik_tpu's Jacobian."""
    conv = res.converged.numpy()
    assert conv.mean() > 0.5
    nu = res.nu.numpy().astype(np.float64)[conv]
    tree64 = jrobots.get(robot, "float64")
    task = 0.0
    for k, link in enumerate(jp.constraint_links):
        v = np.asarray(jax.vmap(lambda q_, n: frame_velocity(tree64, q_, n, link))(
            jnp.asarray(q[conv], jnp.float64), jnp.asarray(nu)))
        A, b = np.asarray(jp.A[k], np.float64), np.asarray(jp.b[k], np.float64)
        task = max(task, np.abs(v @ A.T - b).max())
    lb, ub = np.asarray(jp.lb, np.float64), np.asarray(jp.ub, np.float64)
    box = np.maximum(np.maximum(lb - nu, nu - ub), 0).max()
    return task, box


def _outcomes(res_t, res_j):
    ct, cj = res_t.converged.numpy(), np.asarray(res_j.converged)
    flag_diff = int((ct != cj).sum())
    both = ct & cj
    nu_err = float(np.abs(res_t.nu.numpy()[both] - np.asarray(res_j.nu)[both]).max())
    d_it = res_t.iterations.numpy().astype(int) - np.asarray(res_j.iterations).astype(int)
    return flag_diff, nu_err, d_it


def settings(robot):
    """Solver settings of the robot's bench configuration."""
    if robot == "panda_arm":
        return FLAGSHIP
    return dict(LEGGED, check_interval=LEGGED_K[robot])


def same_arithmetic(robot, B, monkeypatch):
    """loik_tpu op by op and the port fed loik_tpu's FK: the North-star
    outcome budget, and the float64 certificate of what converged."""
    jt, tt, jp, tp = pair(robot, "float32")
    q = q_batch(jt, B, seed=0, dtype="float32")
    liMi = shared_fk(jt, q)
    monkeypatch.setattr(tsm, "fwd_pass_init", lambda tree, q_: liMi)
    with jax.disable_jit():
        res_j = jdelta(jt, JParams(**settings(robot)), jnp.asarray(q), jp, fused=False)
    res_t = solve_delta_duals(tt, lt.SolverParams(**settings(robot)), torch.as_tensor(q), tp,
                              fused=False)
    flag_diff, nu_err, d_it = _outcomes(res_t, res_j)
    assert flag_diff <= max(1, B // 100)
    assert nu_err <= 2e-5
    assert (d_it == 0).mean() >= 0.99
    assert not res_t.dual_infeasible.any()
    task, box = certified(res_t, q, robot, jp)
    assert task <= 1e-5 and box <= 1e-5


def test_delta_duals_same_arithmetic_as_reference(monkeypatch):
    same_arithmetic("panda_arm", 64, monkeypatch)


def compiled_reference(robot, B, nu_atol=2e-5, it_slack=None):
    """Against loik_tpu's compiled program: flags, nu where both converged
    within nu_atol, iteration counts within it_slack (default: one check
    interval), the float64 certificate.  Returns the share of problems whose
    iteration counts differ."""
    jt, tt, jp, tp = pair(robot, "float32")
    q = q_batch(jt, B, seed=1, dtype="float32")
    res_j = jdelta(jt, JParams(**settings(robot)), jnp.asarray(q), jp, fused=False)
    res_t = solve_delta_duals(tt, lt.SolverParams(**settings(robot)), torch.as_tensor(q), tp,
                              fused=False)
    flag_diff, nu_err, d_it = _outcomes(res_t, res_j)
    assert flag_diff <= max(1, B // 100)
    assert nu_err <= nu_atol, nu_err
    assert np.abs(d_it).max() <= (it_slack or settings(robot)["check_interval"])
    assert not res_t.dual_infeasible.any()
    task, box = certified(res_t, q, robot, jp)
    assert task <= 1e-5 and box <= 1e-5
    np.testing.assert_array_equal(res_t.primal_infeasible.numpy(),
                                  np.asarray(res_j.primal_infeasible))
    return float((d_it != 0).mean())


def test_delta_duals_matches_compiled_reference():
    compiled_reference("panda_arm", 64)


def test_delta_state_is_full_space():
    """The returned state is x_hat + dx with duals y_hat + dy: its primal
    fields match the outputs, and a warm re-solve of the same problem stops
    far sooner than a cold one."""
    _, tt, _, tp = pair("panda_arm", "float32", b3=0.1)
    q = torch.as_tensor(q_batch(tt, 8, seed=2, dtype="float32"))
    params = lt.SolverParams(max_iter=100, tol_abs=1e-6, tol_rel=1e-6, warm_start=True)
    res = solve_delta_duals(tt, params, q, tp)
    np.testing.assert_allclose(tsm._flat_nu(tt, res.state.nu).numpy(), res.nu.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(res.state.vis.movedim(-1, 0).numpy(), res.vis.numpy(),
                               rtol=1e-6, atol=1e-7)
    warm = solve_delta_duals(tt, params, q, tp, warm_state=res.state)
    cold = solve_delta_duals(tt, params.replace(warm_start=False), q, tp)
    conv = res.converged
    assert warm.iterations[conv].double().mean() < 0.6 * cold.iterations[conv].double().mean()
    np.testing.assert_allclose(warm.nu[conv].numpy(), res.nu[conv].numpy(), atol=2e-5)


def test_delta_duals_takes_float64_inputs():
    """The loops run in float32 whatever the caller's q dtype (the KKT step
    reads the caller's float64 problem either way)."""
    _, tt, _, tp = pair("panda_arm", "float64")
    q = torch.as_tensor(q_batch(tt, 8, seed=3))
    res = solve_delta_duals(tt, lt.SolverParams(**FLAGSHIP), q, tp)
    res32 = solve_delta_duals(tt, lt.SolverParams(**FLAGSHIP), q.float(), tp)
    assert res.nu.dtype == torch.float32 and res.converged.any()
    assert torch.equal(res.nu, res32.nu) and torch.equal(res.iterations, res32.iterations)


def test_diffik_solver_equals_functional_forms():
    _, tt, _, tp = pair("panda_arm", "float32")
    q = torch.as_tensor(q_batch(tt, 16, seed=4, dtype="float32"))
    params = lt.SolverParams(**FLAGSHIP)
    solver = lt.DiffIkSolver(tt, params, (6,), problem=tp, fused="require")
    r1 = solver.solve(q)
    r0 = lt.solve(tt, params, q, tp)
    assert torch.equal(r1.nu, r0.nu) and torch.equal(r1.iterations, r0.iterations)
    r2 = solver.solve_refined(q, method="delta")
    r3 = solve_delta_duals(tt, params, q, tp, fused="require")
    for name in ("nu", "z", "vis", "converged", "iterations", "primal_residual"):
        assert torch.equal(getattr(r2, name), getattr(r3, name)), name
    assert solver.state is r2.state
    assert torch.equal(solver.get_iter(), r2.iterations)
    assert torch.equal(solver.get_convergence_status(), r2.converged)
    assert torch.equal(solver.get_primal_residual(), r2.primal_residual)
    assert torch.equal(solver.get_dual_residual(), r2.dual_residual)
    assert torch.equal(solver.get_primal_infeasibility_status(), r2.primal_infeasible)
    assert not solver.get_dual_infeasibility_status().any()
    solver.reset()
    assert solver.state is None and solver.last_result is None


def test_diffik_solver_updates_and_warm_start():
    _, tt, _, tp = pair("panda_arm", "float32", b3=0.1)
    q = torch.as_tensor(q_batch(tt, 8, seed=5, dtype="float32"))
    params = lt.SolverParams(max_iter=100, tol_abs=1e-6, tol_rel=1e-6, warm_start=True)
    solver = lt.DiffIkSolver(tt, params, (6,), problem=tp)
    cold = solver.solve_refined(q)
    solver.update_eq_constraint(6, b=np.array([0, 0, 0.12, 0, 0, 0]))
    assert float(solver.problem.b[0, 2]) == pytest.approx(0.12)
    warm = solver.solve_refined(q)
    want = solve_delta_duals(tt, params, q, solver.problem, warm_state=cold.state)
    assert torch.equal(warm.nu, want.nu)
    solver.update_eq_constraints(np.eye(6)[None], np.array([[0, 0, 0.1, 0, 0, 0]]))
    solver.update_references(H_ref=2 * np.eye(6)[None].repeat(7, 0),
                             v_ref=np.zeros((7, 6)))
    solver.update_ineq_constraints(-np.ones(7), np.ones(7))
    assert float(solver.problem.ub.max()) == 1.0 and float(solver.problem.H_ref[0, 0, 0]) == 2.0
    with pytest.raises(ValueError, match="cannot change"):
        solver.update_eq_constraints(np.eye(6)[None].repeat(2, 0), np.zeros((2, 6)))
    with pytest.raises(ValueError, match="no constraint at link 3"):
        solver.update_eq_constraint(3, b=np.zeros(6))
    with pytest.raises(ValueError, match="shape mismatch"):
        solver.update_ineq_constraints(-np.ones(7), np.ones(6))
    with pytest.raises(ValueError, match="method must be 'delta' or 'two-stage'"):
        solver.solve_refined(q, method="three-stage")
    with pytest.raises(ValueError, match="fused must be"):
        lt.DiffIkSolver(tt, params, (6,), fused="always")
