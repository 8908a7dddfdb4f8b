"""The port's eager solver end to end in float64: `solve` against
loik_tpu's `solve` on the same trees, problems and q (nu at 1e-10,
iterations and every flag equal), warm starts, and the panda entries of the
frozen golden trajectories (tests/golden/traces.json).  The legged robots
are in tests/test_torch_legged.py.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver import solve as jsolve

from tests.test_torch_model import pair, q_batch

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "traces.json")
with open(GOLDEN) as f:
    DOC = json.load(f)

FLAGS = ("converged", "primal_infeasible", "dual_infeasible", "iterations",
         "tail_iterations")


def assert_same(res_t, res_j, atol=1e-10):
    for name in FLAGS:
        np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                      np.asarray(getattr(res_j, name)), err_msg=name)
    for name in ("nu", "z", "vis"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(),
                                   np.asarray(getattr(res_j, name)), rtol=0,
                                   atol=atol, err_msg=name)
    for name in ("primal_residual", "dual_residual"):
        # residuals cancel mu_eq-amplified terms: f64 noise ~1e-11 absolute
        np.testing.assert_allclose(getattr(res_t, name).numpy(),
                                   np.asarray(getattr(res_j, name)), rtol=1e-8,
                                   atol=1e-10, err_msg=name)


@pytest.mark.parametrize("check_interval", [1, 8])
@pytest.mark.parametrize("robot", ["panda_arm", "panda"])
def test_solve_f64_matches_reference(robot, check_interval):
    jt, tt, jp, tp = pair(robot)
    q = q_batch(jt, 24, seed=check_interval)
    params = dict(max_iter=200, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
                  mu_equality_scale_factor=1e5, check_interval=check_interval)
    res_j = jsolve(jt, JParams(**params), jnp.asarray(q), jp)
    res_t = lt.solve(tt, lt.SolverParams(**params), torch.as_tensor(q), tp)
    assert res_t.converged.any()
    assert_same(res_t, res_j)


@pytest.mark.parametrize("tail_solve", [True, False])
def test_solve_f64_infeasible_batch(tail_solve):
    """A batched problem with unreachable targets: certificates, the tail
    solve (or the freeze at detection) and per-problem leaves."""
    jt, tt, _, _ = pair("panda_arm")
    B = 12
    b = np.zeros((B, 1, 6))
    b[:, 0, 2] = 0.2
    b[::3, 0, 2] = 40.0           # unreachable within the +-0.5 box
    from loik_tpu.problem import make_problem as jmake_problem

    jp = jmake_problem(jt, (6,), b=b, lb=-0.5 * np.ones(7), ub=0.5 * np.ones(7))
    tp = lt.convert.problem_from_arrays(jp, device="cpu")
    q = q_batch(jt, B, seed=9)
    params = dict(max_iter=150, tol_abs=1e-6, tol_rel=1e-6, tail_solve=tail_solve)
    res_j = jsolve(jt, JParams(**params), jnp.asarray(q), jp)
    res_t = lt.solve(tt, lt.SolverParams(**params), torch.as_tensor(q), tp)
    assert res_t.primal_infeasible.any()
    assert_same(res_t, res_j)


def test_solve_f64_warm_start():
    jt, tt, jp, tp = pair("panda_arm", b3=0.1)
    q = q_batch(jt, 16, seed=3)
    cold = dict(max_iter=100, tol_abs=1e-6, tol_rel=1e-6)
    params = dict(cold, warm_start=True, keep_mu_on_warm_start=True,
                  freeze_infeasible_on_warm_start=True)
    cold_j = jsolve(jt, JParams(**cold), jnp.asarray(q), jp)
    cold_t = lt.solve(tt, lt.SolverParams(**cold), torch.as_tensor(q), tp)
    jp2 = jp.update_constraint(0, b=jnp.asarray([0.0, 0.0, 0.12, 0.0, 0.0, 0.0]))
    tp2 = tp.update_constraint(0, b=np.array([0.0, 0.0, 0.12, 0.0, 0.0, 0.0]))
    warm_j = jsolve(jt, JParams(**params), jnp.asarray(q), jp2, warm_state=cold_j.state)
    warm_t = lt.solve(tt, lt.SolverParams(**params), torch.as_tensor(q), tp2,
                      warm_state=cold_t.state)
    assert_same(warm_t, warm_j)
    conv = cold_t.converged
    assert warm_t.iterations[conv].double().mean() < cold_t.iterations[conv].double().mean()


def test_solve_single_q_and_validation():
    _, tt, _, tp = pair("panda_arm")
    res = lt.solve(tt, lt.SolverParams(max_iter=50), tt.neutral(), tp)
    assert res.nu.shape == (1, 7) and res.vis.shape == (1, 7, 6)
    with pytest.raises(ValueError, match="nq=7"):
        lt.solve(tt, lt.SolverParams(), torch.zeros(3, 5, dtype=torch.float64), tp)
    with pytest.raises(ValueError, match="lb > ub"):
        lt.solve(tt, lt.SolverParams(), tt.neutral(), tp.replace(lb=tp.ub + 1))
    with pytest.raises(ValueError, match="out of range"):
        lt.make_problem(tt, (7,))
    logged = lt.solve(tt, lt.SolverParams(max_iter=50, logging=True), tt.neutral(), tp)
    assert logged.log_rp.shape == (50, 1) and res.log_rp is None


def _golden_problem(trace, tree):
    b = torch.as_tensor(np.asarray(trace["b"])[None])
    return lt.make_problem(tree, (trace["constraint_link"],), b=b,
                           lb=-trace["bounds"] * torch.ones(tree.nv, dtype=torch.float64),
                           ub=trace["bounds"] * torch.ones(tree.nv, dtype=torch.float64))


@pytest.mark.parametrize(
    "trace,params",
    [(t, DOC["params"]) for t in DOC["traces"] if t["robot"] == "panda"]
    + [(t, t["params"]) for t in DOC["traces_v2"] if t.get("robot") == "panda"],
    ids=lambda x: x.get("family", x.get("robot", "")) if "q" in x else "",
)
def test_golden_trace_panda(trace, params):
    """The frozen reference trajectory's endpoint and flags, at the bounds
    tests/test_golden_trace.py holds loik_tpu's fast solver to."""
    tree = lt.robots.panda(device="cpu")
    res = lt.solve(tree, lt.SolverParams(**params),
                   torch.as_tensor(np.asarray(trace["q"])), _golden_problem(trace, tree))
    assert int(res.iterations[0]) == trace["iterations"]
    if "family" in trace:
        assert int(res.tail_iterations[0]) == trace["tail_iterations"]
        assert bool(res.converged[0]) == trace["converged"]
        assert bool(res.primal_infeasible[0]) == trace["primal_infeasible"]
        assert bool(res.dual_infeasible[0]) == trace["dual_infeasible"]
        atol = 1e-11
    else:
        atol = 1e-12
    np.testing.assert_allclose(res.nu[0].numpy(), trace["nu_final"], rtol=1e-9, atol=atol)
    np.testing.assert_allclose(res.z[0].numpy(), trace["z_final"], rtol=1e-9, atol=atol)
