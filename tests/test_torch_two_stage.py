"""The two-stage tight-tolerance solve (float32 bulk + warm float64 tail):
the port's `solve_two_stage` against loik_tpu's on `panda_arm` (B=32), the
float64 stage 2 with `_solve_impl(tol_scales=...)` against loik_tpu's from
one shared stage-1 state, and `DiffIkSolver.solve_refined`'s ``fused``
policy for the two-stage path.  `mobile_ur5` (a universal joint:
q-dependent subspaces) and `solve_refined` taking the two-stage path for
it are in tests/test_torch_two_stage_mobile.py, the delta-refined solve in
tests/test_torch_delta_refined*.py: one loik_tpu compilation of a
two-loop program takes 20-26 s on a CPU, so each file holds at most two.

Budgets.  Against loik_tpu's compiled program, stage 1 is float32 at tol
2e-5, the float32 floor, where iteration counts are chaotic at the ulp
level (tests/test_torch_fused.py).  Measured at check_interval 1 over seeds
1-3 (B=32 panda_arm, B=24 mobile_ur5): converged and primal-infeasible
flags equal, converged nu within 5.1e-5, total iteration counts equal on
54-88% of problems and within 3 of each other.  Held: flags within
max(1, B/100), nu within 5e-5 (50 tol), counts equal on at least half and
within 5 where the flags agree.  Every problem the port flags converged is
certified in float64 (task residual and box violation at most 1e-5,
recomputed from (q, nu) by loik_tpu's Jacobian).  The float64 stage from a
shared state is the same arithmetic in both packages: held to the float64
budget of tests/test_torch_solve.py (nu, z, vis within 1e-10, residuals
1e-8 relative, flags and counts equal).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu.solver.solve  # noqa: F401  (the module; the package exports a function)
import loik_tpu_torch as lt
import loik_tpu_torch.solver.solve  # noqa: F401
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver.refine import solve_two_stage as jtwo_stage
from loik_tpu.solver.state import SolverState as JState
from loik_tpu_torch import convert
from loik_tpu_torch.solver import refine

from tests.test_torch_model import FLAGSHIP, pair, q_batch
from tests.test_torch_refine import certified
from tests.test_torch_solve import assert_same

jsm = sys.modules["loik_tpu.solver.solve"]
tsm = sys.modules["loik_tpu_torch.solver.solve"]

PARAMS = dict(FLAGSHIP, check_interval=1)


def outcome_budget(res_t, res_j, B):
    """The compiled-reference budget of the module docstring."""
    for name in ("converged", "primal_infeasible"):
        diff = int((getattr(res_t, name).numpy() != np.asarray(getattr(res_j, name))).sum())
        assert diff <= max(1, B // 100), (name, diff)
    ct, cj = res_t.converged.numpy(), np.asarray(res_j.converged)
    both = ct & cj
    assert both.sum() >= B // 2
    nu_err = np.abs(res_t.nu.numpy()[both] - np.asarray(res_j.nu)[both]).max()
    assert nu_err <= 5e-5, nu_err
    d_it = res_t.iterations.numpy().astype(int) - np.asarray(res_j.iterations).astype(int)
    assert (d_it == 0).mean() >= 0.5, d_it
    assert np.abs(d_it[ct == cj]).max() <= 5, d_it
    assert not res_t.dual_infeasible.any()


def test_two_stage_matches_reference():
    jt, tt, jp, tp = pair("panda_arm", "float64")
    B = 32
    q = q_batch(jt, B, seed=1)
    res_j = jtwo_stage(jt, JParams(**PARAMS), jnp.asarray(q), jp)
    res_t = lt.solve_two_stage(tt, lt.SolverParams(**PARAMS), torch.as_tensor(q), tp)
    assert res_t.nu.dtype == torch.float64 and res_t.state.vis.dtype == torch.float64
    outcome_budget(res_t, res_j, B)
    task, box = certified(res_t, q, "panda_arm", jp)
    assert task <= 1e-5 and box <= 1e-5


def test_float64_stage_with_tol_scales_from_shared_state():
    """`_solve_impl(..., tol_scales=)` in float64 from the port's float32
    stage-1 state, in both packages: stage 2 of the two-stage solve with
    the floors of the delta-refined one."""
    jt, tt, jp, tp = pair("panda_arm", "float64")
    B = 16
    q = q_batch(jt, B, seed=4)
    p1 = lt.SolverParams(**PARAMS).replace(tol_abs=2e-5, tol_rel=2e-5, max_iter=48)
    st1 = tsm._solve_impl(tt.astype(torch.float32), p1, torch.as_tensor(q).float(),
                          refine._cast_problem(tp, torch.float32), None).state
    st64 = refine._cast_state(st1, torch.float64)
    scales = np.random.default_rng(0).uniform(0.0, 0.3, (2, B))
    p2 = dict(PARAMS, warm_start=True, max_iter=50, mu=1e-3, mu_equality_scale_factor=1e6,
              freeze_infeasible_on_warm_start=True)
    jwarm = JState(**{k: jnp.asarray(v) for k, v in convert.state_to_numpy(st64).items()})
    res_j = jax.jit(jsm._solve_impl, static_argnums=(1,))(
        jt, JParams(**p2), jnp.asarray(q), jp, jwarm, None, tuple(jnp.asarray(s) for s in scales))
    res_t = tsm._solve_impl(tt, lt.SolverParams(**p2), torch.as_tensor(q), tp, st64,
                            tol_scales=tuple(torch.as_tensor(s) for s in scales))
    assert_same(res_t, res_j)
    assert res_t.converged.float().mean() >= 0.5


@pytest.mark.parametrize("fused", [None, False, True, "require"])
def test_solve_refined_maps_the_fused_policy(fused, monkeypatch):
    """None stays None, False stays False, True and "require" become
    fused_stage1=True: on a q-dependent tree that raises naming the
    blocker, on panda_arm it runs (the eager loop on the CPU)."""
    seen = []
    two_stage = refine.solve_two_stage

    def recording(*a, **kw):
        seen.append(kw["fused_stage1"])
        return two_stage(*a, **kw)

    monkeypatch.setattr(sys.modules["loik_tpu_torch.api"], "solve_two_stage", recording)
    params = lt.SolverParams(max_iter=20)
    for robot in ("panda_arm", "mobile_ur5"):
        _, tt, _, tp = pair(robot, "float64")
        solver = lt.DiffIkSolver(tt, params, tp.constraint_links, problem=tp, fused=fused)
        q = tt.neutral()
        if fused in (True, "require") and robot == "mobile_ur5":
            with pytest.raises(ValueError, match="configuration-dependent motion subspaces"):
                solver.solve_refined(q)
        else:
            assert solver.solve_refined(q, method="two-stage").nu.shape == (1, tt.nv)
    want = None if fused is None else bool(fused)
    assert seen == [want] * len(seen) and len(seen) >= 2
    with pytest.raises(ValueError, match="method must be"):
        solver.solve_refined(q, method="three-stage")


def test_fused_stage1_true_on_q_dependent_tree_raises():
    _, tt, _, tp = pair("mobile_ur5", "float64")
    with pytest.raises(ValueError, match="fused_stage1=True but the fused kernel cannot run"):
        lt.solve_two_stage(tt, lt.SolverParams(), tt.neutral(), tp, fused_stage1=True)


def test_fused_stage1_none_is_silent_and_true_equals_eager_on_cpu(recwarn):
    """On CPU tensors the fused stage 1 is the eager loop: fused_stage1=True
    gives the eager bits, and None warns about nothing on any tree."""
    _, tt, _, tp = pair("panda_arm", "float64")
    q = torch.as_tensor(q_batch(tt, 8, seed=6))
    params = lt.SolverParams(**PARAMS)
    a = lt.solve_two_stage(tt, params, q, tp, fused_stage1=True)
    b = lt.solve_two_stage(tt, params, q, tp, fused_stage1=False)
    assert torch.equal(a.nu, b.nu) and torch.equal(a.iterations, b.iterations)
    _, tm, _, tpm = pair("mobile_ur5", "float64")
    lt.solve_two_stage(tm, lt.SolverParams(max_iter=20), tm.neutral(), tpm)
    assert not [w for w in recwarn if "fused" in str(w.message)]


@pytest.mark.parametrize("robot", ["panda", "ur5", "solo12", "talos_like", "talos"])
def test_two_stage_runs_on_every_robot(robot):
    """method="two-stage" on every robot of the registry (panda_arm and
    mobile_ur5 above): float64 results of the right shape, finite, and the
    iteration counts the sum of both stages' caps at most."""
    _, tt, _, tp = pair(robot, "float64")
    q = tt.random_configuration((2,), generator=torch.Generator().manual_seed(7))
    params = lt.SolverParams(max_iter=12, tol_abs=1e-6, tol_rel=1e-6)
    res = lt.DiffIkSolver(tt, params, tp.constraint_links, problem=tp).solve_refined(
        q, method="two-stage", stage1_max_iter=8, stage2_max_iter=4)
    assert res.nu.shape == (2, tt.nv) and res.nu.dtype == torch.float64
    assert torch.isfinite(res.nu).all()
    assert (res.iterations <= 12).all() and (res.iterations >= 1).all()
