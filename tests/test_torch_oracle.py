"""The port's numpy oracle (`loik_tpu_torch.oracle`) against loik_tpu's
(`loik_tpu.oracle`) on tests/test_oracle.py's fixtures, the infeasible ones
included: the same float64 numpy program, with forward kinematics and the
SE(3) action matrices from the port's torch code instead of jax, so every
per-iteration log agrees within 1e-10 and iteration counts and flags are
equal.  Then the checks that do not need loik_tpu: the converged solution
against a direct KKT solve of the dense QP, and the port's eager `solve`
against the port's oracle (tests/test_fast_solver.py's budget, 1e-10).
"""

import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu.model import robots as jrobots
from loik_tpu.oracle import OracleSolver as JOracle
from loik_tpu.params import SolverParams as JParams
from loik_tpu.problem import make_problem as jmake_problem
from loik_tpu_torch.convert import problem_from_arrays, tree_from_arrays
from loik_tpu_torch.oracle import OracleInfo, OracleResult, OracleSolver

from tests.test_oracle import PANDA_Q, fixture_problem, fixture_q, kkt_solution

LOGS = ("iters", "primal_residuals", "dual_residuals", "mus", "tail_solve_iters",
        "primal_residuals_task", "primal_residuals_slack", "dual_residuals_v",
        "dual_residuals_nu", "mu_eqs", "mu_ineqs", "in_tail", "delta_x_infs",
        "delta_z_infs")


def _infeasible_ur5():
    """tests/test_oracle.py::test_oracle_infeasible_problem: the parent link
    held still while its child must move at 50 m/s."""
    jt = jrobots.ur5()
    c = jt.njoints - 1
    b = np.zeros((2, 6))
    b[1, 2] = 50.0
    return jt, jmake_problem(jt, (c - 1, c), A=np.stack([np.eye(6), np.eye(6)]), b=b,
                             lb=-10 * np.ones(jt.nv), ub=10 * np.ones(jt.nv))


def _case(name):
    """(jax tree, jax problem, params kwargs, q) of each fixture."""
    if name in ("panda", "ur5"):
        jt = jrobots.get(name)
        return jt, fixture_problem(jt), dict(max_iter=500, tol_abs=1e-8, tol_rel=1e-8), \
            fixture_q(jt)
    if name == "panda_defaults":
        jt = jrobots.panda()
        return jt, fixture_problem(jt), dict(max_iter=200), PANDA_Q
    if name == "ur5_box_active":
        jt = jrobots.ur5()
        return jt, fixture_problem(jt, b3=0.5, bound=0.05), \
            dict(max_iter=2000, tol_abs=1e-6, tol_rel=1e-6), np.asarray(jt.neutral())
    if name.startswith("panda_random"):
        jt = jrobots.panda()
        q = np.random.default_rng(int(name[-1])).uniform(-np.pi, np.pi, jt.nq)
        return jt, fixture_problem(jt, b3=0.2), dict(max_iter=500, tol_abs=1e-6,
                                                     tol_rel=1e-6), q
    if name == "solo12_floating":
        jt = jrobots.solo12()
        return jt, fixture_problem(jt, b3=0.3), dict(max_iter=500, tol_abs=1e-6,
                                                     tol_rel=1e-6), np.asarray(jt.neutral())
    if name == "ur5_infeasible":
        jt, jp = _infeasible_ur5()
        return jt, jp, dict(max_iter=300), np.asarray(jt.neutral())
    if name == "panda_neutral_infeasible":
        jt = jrobots.panda()
        return jt, fixture_problem(jt), dict(max_iter=300, tol_abs=1e-8, tol_rel=1e-8), \
            np.asarray(jt.neutral())
    if name == "ur5_mu_adaptation":
        jt = jrobots.ur5()
        return jt, fixture_problem(jt, b3=0.4), dict(
            max_iter=300, tol_abs=1e-8, tol_rel=1e-8, mu=1e-5,
            mu_equality_scale_factor=10.0), np.asarray(jt.neutral())
    raise KeyError(name)


CASES = ["panda", "ur5", "panda_defaults", "ur5_box_active", "panda_random0",
         "panda_random1", "panda_random2", "solo12_floating", "ur5_infeasible",
         "panda_neutral_infeasible", "ur5_mu_adaptation"]


def _port(jt, jp, kw):
    return (tree_from_arrays(jt, device="cpu"), problem_from_arrays(jp, device="cpu"),
            lt.SolverParams(**kw))


@pytest.mark.parametrize("case", CASES)
def test_oracle_matches_reference(case):
    jt, jp, kw, q = _case(case)
    want = JOracle(jt, JParams(**kw)).solve(q, jp)
    tt, tp, params = _port(jt, jp, kw)
    got = OracleSolver(tt, params).solve(torch.tensor(q), tp)
    assert isinstance(got, OracleResult) and isinstance(got.info, OracleInfo)
    for name in ("converged", "primal_infeasible", "dual_infeasible", "iterations",
                 "tail_solve_iterations"):
        assert getattr(got, name) == getattr(want, name), name
    for name in LOGS:
        a, b = np.asarray(getattr(got.info, name)), np.asarray(getattr(want.info, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10, err_msg=name)
    for name in ("nu", "z", "w", "vis", "fis", "yis"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0,
                                   atol=1e-10, err_msg=name)
    for name in ("primal_residual", "dual_residual", "mu"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0,
                                   atol=1e-10, err_msg=name)


def test_oracle_outcomes():
    """The fixtures' expected outcomes hold on the port's oracle."""
    for case in ("ur5_infeasible", "panda_neutral_infeasible"):
        jt, jp, kw, q = _case(case)
        tt, tp, params = _port(jt, jp, kw)
        s = OracleSolver(tt, params)
        res = s.solve(q, tp)
        assert not res.converged and res.primal_infeasible, case
        assert np.max(np.abs(s.delta_x_qp)) < params.tol_tail_solve
    jt, jp, kw, q = _case("ur5_box_active")
    tt, tp, params = _port(jt, jp, kw)
    res = OracleSolver(tt, params).solve(q, tp)
    assert np.all(np.abs(res.z) <= 0.05 + 1e-12)


@pytest.mark.parametrize("case", ["panda", "ur5", "solo12_floating"])
def test_oracle_matches_kkt(case):
    """Independent check: the converged ADMM solution equals a direct KKT
    solve of the same dense QP (box inactive)."""
    jt, jp, kw, q = _case(case)
    tt, tp, params = _port(jt, jp, kw)
    s = OracleSolver(tt, params)
    res = s.solve(q, tp)
    assert res.converged
    np.testing.assert_allclose(res.vis[tp.constraint_links[0]], tp.b[0].numpy(),
                               atol=1e-4 if case == "solo12_floating" else 1e-6)
    x = kkt_solution(s, tp)
    N = tt.njoints
    np.testing.assert_allclose(res.nu, x[6 * N:], atol=1e-4)
    np.testing.assert_allclose(res.vis, x[:6 * N].reshape(N, 6), atol=1e-4)


def test_oracle_deterministic_and_split():
    jt, jp, _, q = _case("ur5")
    tt, tp, params = _port(jt, jp, dict(max_iter=100))
    s = OracleSolver(tt, params)
    r1, r2 = s.solve(q, tp), s.solve(q, tp)
    np.testing.assert_array_equal(r1.nu, r2.nu)
    s2 = OracleSolver(tt, params)
    s2.solve_init(q, tp)
    s2.solve_main_loop()
    np.testing.assert_array_equal(r1.nu, s2.nu)


def test_oracle_takes_a_tree_in_float32():
    """A tree in another dtype is copied to float64 once: the oracle stays
    the float64 specification."""
    jt, jp, kw, q = _case("ur5")
    tt, tp, params = _port(jt, jp, kw)
    got = OracleSolver(tt.astype(torch.float32), params)
    assert got.tree.dtype == torch.float64 and got.tree.device == torch.device("cpu")


@pytest.mark.parametrize("case", ["ur5", "panda", "panda_random0", "ur5_mu_adaptation"])
def test_eager_solve_matches_oracle(case):
    """The port's batched eager solve reproduces its oracle's trajectory
    (tests/test_fast_solver.py::assert_matches_oracle, 1e-10; the mu
    adaptation case 1e-8, as there)."""
    jt, jp, kw, q = _case(case)
    if case in ("ur5", "panda"):
        jp = fixture_problem(jt, b3=0.3)
        kw = dict(max_iter=300, tol_abs=1e-6, tol_rel=1e-6)
    atol = 1e-8 if case == "ur5_mu_adaptation" else 1e-10
    tt, tp, params = _port(jt, jp, kw)
    res = lt.solve(tt, params, torch.tensor(q), tp)
    orc = OracleSolver(tt, params).solve(q, tp)
    assert bool(res.converged[0]) == orc.converged
    assert int(res.iterations[0]) == orc.iterations
    for name in ("nu", "vis", "z"):
        np.testing.assert_allclose(getattr(res, name)[0].numpy(), getattr(orc, name),
                                   rtol=0, atol=atol, err_msg=name)
    np.testing.assert_allclose(float(res.primal_residual[0]), orc.primal_residual, atol=atol)
    np.testing.assert_allclose(float(res.dual_residual[0]), orc.dual_residual, atol=atol)
    if case == "ur5_mu_adaptation":
        assert len(set(orc.info.mus)) > 1


def test_eager_logs_match_oracle():
    """params.logging's per-iteration per-block residuals equal the
    oracle's logs (tests/test_fast_solver.py::
    test_logging_per_block_residuals_match_oracle)."""
    jt = jrobots.panda()
    tt, tp, params = _port(jt, fixture_problem(jt, b3=0.2),
                           dict(max_iter=60, tol_abs=1e-6, tol_rel=1e-6, logging=True))
    res = lt.solve(tt, params, torch.as_tensor(PANDA_Q), tp)
    orc = OracleSolver(tt, params).solve(PANDA_Q, tp)
    T, info = orc.iterations, orc.info
    pairs = [(res.log_rp, info.primal_residuals), (res.log_rd, info.dual_residuals),
             (res.log_mu, info.mus), (res.log_rp_task, info.primal_residuals_task),
             (res.log_rp_slack, info.primal_residuals_slack),
             (res.log_rd_v, info.dual_residuals_v), (res.log_rd_nu, info.dual_residuals_nu),
             (res.log_mu_eq, info.mu_eqs), (res.log_mu_ineq, info.mu_ineqs),
             (res.log_dx, info.delta_x_infs), (res.log_dz, info.delta_z_infs)]
    for fast, want in pairs:
        got = fast[:T, 0].numpy()
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-10)
    assert bool(torch.isnan(res.log_rp[T:, 0]).all())
