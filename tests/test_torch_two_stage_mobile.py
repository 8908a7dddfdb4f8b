"""The two-stage solve on a tree with configuration-dependent motion
subspaces: `mobile_ur5` (a planar base and a universal head joint, so S
depends on q) against loik_tpu's `solve_two_stage`, and
`DiffIkSolver.solve_refined()` taking the two-stage path for it, as
loik_tpu's does (api.py:134-137), where the parent commit raised.  Stage 1
runs the eager loop on such a tree, stage 2 the float64 one.

Budget: the compiled-reference budget of tests/test_torch_two_stage.py
(measured over seeds 1-3 at B=24: flags equal, nu within 8.6e-6,
counts equal on 54-88% and within 2), and the float64 certificate of every
converged problem.
"""

import jax.numpy as jnp
import torch

import loik_tpu_torch as lt
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver.refine import solve_two_stage as jtwo_stage

from tests.test_torch_model import pair, q_batch
from tests.test_torch_refine import certified
from tests.test_torch_two_stage import PARAMS, outcome_budget


def test_two_stage_q_dependent_matches_reference():
    jt, tt, jp, tp = pair("mobile_ur5", "float64")
    assert tt.has_q_dependent_S
    B = 24
    q = q_batch(jt, B, seed=1)
    res_j = jtwo_stage(jt, JParams(**PARAMS), jnp.asarray(q), jp)
    res_t = lt.solve_two_stage(tt, lt.SolverParams(**PARAMS), torch.as_tensor(q), tp)
    outcome_budget(res_t, res_j, B)
    task, box = certified(res_t, q, "mobile_ur5", jp)
    assert task <= 1e-5 and box <= 1e-5


def test_solve_refined_takes_two_stage_on_q_dependent_tree():
    """The fault this slice repairs: DiffIkSolver.solve_refined() on a tree
    with a universal joint raised; it now runs the two-stage solve, as
    loik_tpu does, certified in float64."""
    jt, tt, jp, tp = pair("mobile_ur5", "float64")
    q = torch.as_tensor(q_batch(jt, 8, seed=5))
    params = lt.SolverParams(**PARAMS)
    solver = lt.DiffIkSolver(tt, params, tp.constraint_links, problem=tp)
    res = solver.solve_refined(q)
    want = lt.solve_two_stage(tt, params, q, tp)
    for name in ("nu", "z", "vis", "converged", "iterations", "primal_residual"):
        assert torch.equal(getattr(res, name), getattr(want, name)), name
    assert solver.state is res.state and res.nu.dtype == torch.float64
    task, box = certified(res, q.numpy(), "mobile_ur5", jp)
    assert task <= 1e-5 and box <= 1e-5
