"""The pure-float32 delta-refined solve: the port's `solve_delta_refined`
against loik_tpu's on `mobile_ur5` (B=24), a tree with configuration-dependent
motion subspaces.  Both stages are float32 in the
eager loop, as loik_tpu's call its plain solve; stage 2 is the delta
problem certified against the original problem's tolerance scales
(`_solve_impl(tol_scales=...)`).

Budget: the compiled-reference budget of tests/test_torch_two_stage.py
(flags within max(1, B/100), converged nu within 5e-5, counts equal on at
least half and within 5 where the flags agree; measured over seeds 1-3:
flags equal, nu within 2.5e-6, counts equal on 54-92%), and the float64 certificate of every converged problem.
"""

import jax.numpy as jnp
import torch

import loik_tpu_torch as lt
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver.refine import solve_delta_refined as jdelta_refined

from tests.test_torch_model import pair, q_batch
from tests.test_torch_refine import certified
from tests.test_torch_two_stage import PARAMS, outcome_budget


def test_delta_refined_q_dependent_matches_reference():
    jt, tt, jp, tp = pair("mobile_ur5", "float64")
    B = 24
    q = q_batch(jt, B, seed=1)
    res_j = jdelta_refined(jt, JParams(**PARAMS), jnp.asarray(q), jp)
    res_t = lt.solve_delta_refined(tt, lt.SolverParams(**PARAMS), torch.as_tensor(q), tp)
    assert res_t.nu.dtype == torch.float32
    outcome_budget(res_t, res_j, B)
    task, box = certified(res_t, q, "mobile_ur5", jp)
    assert task <= 1e-5 and box <= 1e-5
