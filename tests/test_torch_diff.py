"""The port's differentiable solve against loik_tpu's, in float64 on the
CPU: `solve_unrolled` forward against the port's `solve` and against
`loik_tpu.solver.diff.solve_unrolled`, and its gradients with respect to the
task target and the configuration against `jax.grad` of the same loss.
Central differences, the binding box, the second derivative, check_interval
> 1, q-dependent subspaces and warm starts are in
tests/test_torch_diff_more.py.

The task is tests/test_diff.py's: ur5, one effective task row (A = e_z e_z',
b_z = 0.1), box +-10, two configurations from a seeded numpy generator,
tol 1e-10, 60 body calls.  loik_tpu compiles once (one value_and_grad over
b_z and q, about 35 s here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu.params import SolverParams as JParams
from loik_tpu.problem import make_problem as jmake_problem
from loik_tpu.solver.diff import solve_unrolled as jsolve_unrolled
from loik_tpu.model import robots as jrobots
from loik_tpu_torch import convert

from tests.test_torch_model import q_batch

PARAMS = dict(max_iter=100, tol_abs=1e-10, tol_rel=1e-10)
N_ITERS = 60
BZ = 0.1


def setup():
    """(jax tree, port tree, jax problem, port problem, q) of the task."""
    jt = jrobots.ur5()
    A = np.zeros((1, 6, 6))
    A[0, 2, 2] = 1.0
    b = np.zeros((1, 6))
    b[0, 2] = BZ
    jp = jmake_problem(jt, (jt.njoints - 1,), A=A, b=b, lb=-10 * np.ones(jt.nv),
                       ub=10 * np.ones(jt.nv))
    return (jt, convert.tree_from_arrays(jt, device="cpu"), jp,
            convert.problem_from_arrays(jp, device="cpu"), q_batch(jt, 2, seed=3))


def with_bz(problem, bz):
    """The port problem with b[0, 2] = bz, differentiable in bz."""
    mask = torch.zeros_like(problem.b)
    mask[0, 2] = 1.0
    return problem.replace(b=problem.b * (1 - mask) + bz * mask)


def port_loss(tree, problem, q, bz, params=PARAMS, num_iters=N_ITERS):
    res = lt.solve_unrolled(tree, lt.SolverParams(**params), q, with_bz(problem, bz),
                            num_iters=num_iters)
    return (res.nu ** 2).sum(), res


@pytest.fixture(scope="module")
def runs():
    """The task, loik_tpu's (loss, nu, d/d b_z, d/d q) from one compiled
    value_and_grad, and the port's loss, result and gradients."""
    jt, tt, jp, tp, q = setup()

    def jloss(bz, qv):
        prob = jp.replace(b=jp.b.at[0, 2].set(bz))
        res = jsolve_unrolled(jt, JParams(**PARAMS), qv, prob, num_iters=N_ITERS)
        return jnp.sum(res.nu ** 2), res.nu

    (jval, jnu), (jgb, jgq) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(BZ), jnp.asarray(q))
    bz = torch.tensor(BZ, dtype=torch.float64, requires_grad=True)
    qt = torch.tensor(q, requires_grad=True)
    loss, res = port_loss(tt, tp, qt, bz)
    gb, gq = torch.autograd.grad(loss, (bz, qt))
    return dict(tree=tt, problem=tp, q=q, jax=(float(jval), np.asarray(jnu), float(jgb),
                                               np.asarray(jgq)),
                port=(float(loss.detach()), res, float(gb), gq.numpy()))


def test_forward_matches_solve_and_reference(runs):
    """Same body, fixed number of calls: the port's while-loop solve once
    both converged (rtol 1e-8), loik_tpu's unrolled solve to 1e-10."""
    _, res, _, _ = runs["port"]
    assert bool(res.converged.all())
    res_w = lt.solve(runs["tree"], lt.SolverParams(**PARAMS), torch.as_tensor(runs["q"]),
                     runs["problem"])
    np.testing.assert_allclose(res.nu.detach().numpy(), res_w.nu.numpy(), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(res.nu.detach().numpy(), runs["jax"][1], rtol=0, atol=1e-10)
    np.testing.assert_allclose(runs["port"][0], runs["jax"][0], rtol=1e-10)


def test_gradients_match_jax_grad(runs):
    """d loss / d b_z and d loss / d q against jax.grad of the same loss."""
    _, _, gb, gq = runs["port"]
    _, _, jgb, jgq = runs["jax"]
    np.testing.assert_allclose(gb, jgb, rtol=1e-8)
    np.testing.assert_allclose(gq, jgq, rtol=1e-8, atol=1e-12)


def test_refuses_logging_and_verbose(runs):
    for flag in ("logging", "verbose"):
        with pytest.raises(ValueError, match="neither logging nor verbose"):
            lt.solve_unrolled(runs["tree"], lt.SolverParams(**{flag: True}),
                              torch.as_tensor(runs["q"]), runs["problem"])
