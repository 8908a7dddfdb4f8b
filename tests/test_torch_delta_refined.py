"""The pure-float32 delta-refined solve: the port's `solve_delta_refined`
against loik_tpu's on `panda_arm` (B=32).  Both stages are float32 in the
eager loop, as loik_tpu's call its plain solve; stage 2 is the delta
problem certified against the original problem's tolerance scales
(`_solve_impl(tol_scales=...)`).

Budget: the compiled-reference budget of tests/test_torch_two_stage.py
(flags within max(1, B/100), converged nu within 5e-5, counts equal on at
least half and within 5 where the flags agree; measured over seeds 1-3:
1 flag flip of 32 on one seed, nu within 2.9e-5, counts equal on 50-72%), and the float64 certificate of every converged problem.

The results are in the original space (nu = nu_hat + dnu, vis = v_hat +
dv) and the state is the delta stage's, as in loik_tpu.
"""

import sys

import jax.numpy as jnp
import torch

import loik_tpu_torch as lt
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver.refine import solve_delta_refined as jdelta_refined

from tests.test_torch_model import pair, q_batch
from tests.test_torch_refine import certified
from tests.test_torch_two_stage import PARAMS, outcome_budget

tsm = sys.modules["loik_tpu_torch.solver.solve"]


def test_delta_refined_matches_reference():
    jt, tt, jp, tp = pair("panda_arm", "float64")
    B = 32
    q = q_batch(jt, B, seed=1)
    res_j = jdelta_refined(jt, JParams(**PARAMS), jnp.asarray(q), jp)
    res_t = lt.solve_delta_refined(tt, lt.SolverParams(**PARAMS), torch.as_tensor(q), tp)
    assert res_t.nu.dtype == torch.float32
    outcome_budget(res_t, res_j, B)
    task, box = certified(res_t, q, "panda_arm", jp)
    assert task <= 1e-5 and box <= 1e-5


def test_delta_refined_recombines_in_the_original_space():
    """nu, z and vis are stage 1's plus the delta stage's correction, whose
    state the result carries (as loik_tpu's does), and the iteration counts
    are the sum of both stages'."""
    _, tt, _, tp = pair("panda_arm", "float64")
    q = torch.as_tensor(q_batch(tt, 8, seed=2))
    params = lt.SolverParams(**PARAMS)
    res = lt.solve_delta_refined(tt, params, q, tp, stage2_max_iter=7)
    one = lt.solve(tt.astype(torch.float32), params.replace(tol_abs=2e-5, tol_rel=2e-5),
                   q.float(), lt.solver.refine._cast_problem(tp, torch.float32))
    dnu = tsm._flat_nu(tt, res.state.nu)
    assert torch.equal(res.nu, one.nu + dnu)
    assert torch.equal(res.z, tsm._flat_nu(tt, res.state.z) + one.nu)
    assert torch.equal(res.vis, res.state.vis.movedim(-1, 0) + one.vis)
    assert torch.equal(res.iterations, one.iterations + res.state.iterations)
    assert (res.state.iterations <= 7).all()
    # problems stage 1 certified infeasible are frozen in stage 2
    assert (res.state.iterations[one.primal_infeasible] == 0).all()
    assert float(dnu.abs().max()) < 1e-3
