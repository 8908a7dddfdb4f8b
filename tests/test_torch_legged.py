"""The slice as a whole on the legged robots, against loik_tpu on the CPU:
solo12 (free-flyer base + 12 revolute joints, five constraints on one tree,
check_interval 4) and talos (33 joints, 38 dofs, check_interval 1) on the
tasks and settings of bench.py's configurations of those names.

Float64: `solve` state within 1e-9, flags and iteration counts equal.
Float32: the budgets of tests/test_torch_fused.py's docstring.  `solve_fused`
and `solve_delta_duals` with loik_tpu run op by op and the port fed
loik_tpu's FK hold the North-star budget (nu within 2e-5 where both
converged, flags differing on at most max(1, B/100) problems, equal
iteration counts on at least 99%); against loik_tpu's compiled program the
iteration counts are held to one check interval, and the share of problems
whose counts differ is printed (`-s`) for the records.
"""

import sys

import jax
import jax.numpy as jnp
import pytest
import torch

import loik_tpu.solver.solve  # noqa: F401  (the module; the package exports a function)
import loik_tpu_torch as lt
import loik_tpu_torch.solver.solve  # noqa: F401
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver import solve as jsolve
from loik_tpu_torch.kernels import fused

from tests.test_torch_fused import _budget
from tests.test_torch_model import LEGGED, LEGGED_K, pair, q_batch, shared_fk
from tests.test_torch_refine import compiled_reference, same_arithmetic
from tests.test_torch_solve import assert_same

jsm = sys.modules["loik_tpu.solver.solve"]
tsm = sys.modules["loik_tpu_torch.solver.solve"]


@pytest.mark.parametrize("robot,B,max_iter", [("solo12", 8, 200), ("talos", 8, 8)])
def test_solve_f64_legged_matches_reference(robot, B, max_iter):
    """solo12 (6-dof base, five constraints, check_interval 4) to convergence
    and talos (33 joints, 38 dofs) for one short solve, on their own tasks:
    state within 1e-9, flags and iteration counts equal."""
    jt, tt, jp, tp = pair(robot)
    q = q_batch(jt, B, seed=11)
    params = dict(LEGGED, max_iter=max_iter, check_interval=LEGGED_K[robot])
    res_j = jsolve(jt, JParams(**params), jnp.asarray(q), jp)
    res_t = lt.solve(tt, lt.SolverParams(**params), torch.as_tensor(q), tp)
    assert not res_t.dual_infeasible.any()
    assert robot == "talos" or res_t.converged.all()
    assert_same(res_t, res_j, atol=1e-9)
    assert res_t.nu.shape == (B, jt.nv)


def test_solve_fused_same_arithmetic_as_reference_solo12(monkeypatch):
    """The float32 loop through the fused entry point (on the CPU: the eager
    loop), k x k D blocks included, adds like loik_tpu op by op."""
    jt, tt, jp, tp = pair("solo12", "float32")
    B = 8
    q = q_batch(jt, B, seed=1, dtype="float32")
    params = dict(max_iter=60, tol_abs=1e-4, tol_rel=1e-4, check_interval=4)
    liMi = shared_fk(jt, q)
    monkeypatch.setattr(tsm, "fwd_pass_init", lambda tree, q_: liMi)
    with jax.disable_jit(), jax.default_matmul_precision("highest"):
        res_j = jsm._solve_impl(jt, JParams(**params), jnp.asarray(q), jp, None)
    n0 = fused.LAUNCHES
    res_t = fused.solve_fused(tt, lt.SolverParams(**params), torch.as_tensor(q), tp)
    assert fused.LAUNCHES == n0
    _budget(res_t, res_j, B, nu_atol=2e-5, it_frac=0.99)


def test_delta_duals_same_arithmetic_as_reference_solo12(monkeypatch):
    same_arithmetic("solo12", 8, monkeypatch)


@pytest.mark.parametrize("robot,B,nu_atol,it_slack", [
    ("solo12", 64, 2e-5, 4), ("talos", 64, 5e-5, 3)])
def test_delta_duals_matches_compiled_reference_legged(robot, B, nu_atol, it_slack):
    """solo12 holds the flagship's budget (counts within one check interval
    of 4).  talos checks every iteration, so its counts show the float32
    chaos unquantised: measured, they differ by at most 2 iterations, and nu
    by 2.3e-5 (38 dofs under two constraints leave a wide null space, where
    the compiled program's FMA-contracted float32 stages settle a few ulps of
    nu = O(1) away); held to 3 iterations and 5e-5."""
    share = compiled_reference(robot, B, nu_atol, it_slack)
    print(f"{robot} B={B}: iteration counts differ from loik_tpu's compiled "
          f"program on {share:.4f} of the problems")
