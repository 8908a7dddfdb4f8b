"""The port's differentiable solve, the checks of tests/test_diff.py and
more, in float64 on the CPU: gradients against central differences (b_z:
eps 1e-5, rtol 1e-4; q: eps 1e-6, rtol 5e-4, atol 1e-8), the binding box,
the second derivative, check_interval > 1 against loik_tpu, a tree with
configuration-dependent subspaces, and a warm start.

The task is tests/test_torch_diff.py's (ur5, A = e_z e_z', b_z = 0.1, box
+-10, two seeded configurations, tol 1e-10).  One loik_tpu compile (the
check_interval 4 forward); the rest is the port alone, whose cost grows
with the number of body calls (about 15 ms a call forward and 50 ms
forward + backward here).  Both problems converge in 8 iterations
at tol 1e-10 and then freeze, so 24 calls give the same fixed point as
tests/test_diff.py's 60 at less than half the cost.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver.diff import solve_unrolled as jsolve_unrolled

from tests.test_torch_diff import BZ, PARAMS, port_loss, setup, with_bz

N_ITERS = 24


@pytest.fixture(scope="module")
def task():
    return setup()


def fd_loss(tree, problem, bz, q):
    with torch.no_grad():
        return float(port_loss(tree, problem, torch.as_tensor(q),
                               torch.tensor(bz, dtype=torch.float64), num_iters=N_ITERS)[0])


def test_gradients_match_central_differences(task):
    """d loss / d b_z and two coordinates of d loss / d q."""
    _, tree, _, problem, q = task
    bz = torch.tensor(BZ, dtype=torch.float64, requires_grad=True)
    qt = torch.tensor(q, requires_grad=True)
    gb, gq = torch.autograd.grad(port_loss(tree, problem, qt, bz, num_iters=N_ITERS)[0],
                                 (bz, qt))
    eps = 1e-5
    fd = (fd_loss(tree, problem, BZ + eps, q) - fd_loss(tree, problem, BZ - eps, q)) / (2 * eps)
    np.testing.assert_allclose(float(gb), fd, rtol=1e-4)
    eps = 1e-6
    for bi, ji in ((0, 1), (1, 4)):
        dq = np.zeros_like(q)
        dq[bi, ji] = eps
        fd = (fd_loss(tree, problem, BZ, q + dq) - fd_loss(tree, problem, BZ, q - dq)) / (2 * eps)
        np.testing.assert_allclose(float(gq[bi, ji]), fd, rtol=5e-4, atol=1e-8)


def test_gradient_with_active_box_constraint(task):
    """With dof 1's bounds at +-1e-4 the dof is pinned: its projected
    velocity z has no sensitivity to the target (< 1e-6) while the free dofs
    keep a real one (> 1e-2) — tests/test_diff.py's check.  The Jacobian
    column dz/d b_z comes from one backward: the first configuration
    repeated once per dof, each copy with its own b_z, and the loss the sum
    of copy k's z_k."""
    _, tree, _, problem, q = task
    nv = tree.nv
    lb = torch.full((nv,), -10.0, dtype=torch.float64)
    ub = torch.full((nv,), 10.0, dtype=torch.float64)
    lb[1], ub[1] = -1e-4, 1e-4
    bz = torch.full((nv,), BZ, dtype=torch.float64, requires_grad=True)
    mask = torch.zeros(6, dtype=torch.float64)
    mask[2] = 1.0
    b = problem.b * (1 - mask) + bz[:, None, None] * mask          # (nv, 1, 6)
    prob = problem.replace(b=b, lb=lb, ub=ub)
    qs = torch.as_tensor(np.repeat(q[:1], nv, axis=0))
    res = lt.solve_unrolled(tree, lt.SolverParams(**PARAMS), qs, prob, num_iters=N_ITERS)
    jac, = torch.autograd.grad(res.z.diagonal().sum(), bz)
    assert abs(float(jac[1])) < 1e-6
    assert float(jac.abs().max()) > 1e-2


def test_second_derivative(task):
    """d2 loss / d b_z2 through create_graph against a central difference of
    the first derivative."""
    _, tree, _, problem, q = task
    qt = torch.as_tensor(q)

    def grad(bz0, create_graph=False):
        bz = torch.tensor(bz0, dtype=torch.float64, requires_grad=True)
        g, = torch.autograd.grad(port_loss(tree, problem, qt, bz, num_iters=N_ITERS)[0], bz,
                                 create_graph=create_graph)
        return g, bz

    g, bz = grad(BZ, create_graph=True)
    h, = torch.autograd.grad(g, bz)
    eps = 1e-5
    fd = (float(grad(BZ + eps)[0]) - float(grad(BZ - eps)[0])) / (2 * eps)
    assert np.isfinite(float(h))
    np.testing.assert_allclose(float(h), fd, rtol=1e-4)


def test_check_interval_budget_matches_reference(task):
    """check_interval 4: the budget max_iter = num_iters + 2 counts
    iterations, not body calls, so problems freeze after about num_iters
    iterations (loik_tpu/solver/diff.py:77) — the port does the same."""
    jt, tree, jp, problem, q = task
    params = dict(PARAMS, check_interval=4)
    jres = jax.jit(lambda qv: jsolve_unrolled(jt, JParams(**params), qv, jp, num_iters=20))(
        jnp.asarray(q))
    res = lt.solve_unrolled(tree, lt.SolverParams(**params), torch.as_tensor(q), problem,
                            num_iters=20)
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(jres.iterations))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(jres.converged))
    assert int(res.iterations.max()) <= 20 + 2
    np.testing.assert_allclose(res.nu.numpy(), np.asarray(jres.nu), rtol=0, atol=1e-10)


def test_q_dependent_subspaces_match_central_differences():
    """mobile_ur5 (a universal head joint, whose S depends on q): an angular
    task at the head, gradients with respect to b and to the head's second
    angle (the first joint's axis, seen from the head, turns with it)
    against central differences."""
    tree = lt.robots.mobile_ur5(device="cpu")
    head = tree.joint_names.index("head_universal_joint")
    A = torch.zeros((1, 6, 6), dtype=torch.float64)
    A[0, 3, 3] = A[0, 4, 4] = 1.0
    base_b = torch.tensor([[0.0, 0.0, 0.0, 0.1, 0.05, 0.0]], dtype=torch.float64)
    problem = lt.make_problem(tree, (head,), A=A, b=base_b,
                              lb=-10 * torch.ones(tree.nv, dtype=torch.float64),
                              ub=10 * torch.ones(tree.nv, dtype=torch.float64))
    q = np.random.default_rng(5).uniform(-np.pi, np.pi, (2, tree.nq))
    iq = tree.idx_q[head] + 1
    bz = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    qt = torch.tensor(q, requires_grad=True)

    def loss(bx, qv):
        mask = torch.zeros(6, dtype=torch.float64)
        mask[3] = 1.0
        prob = problem.replace(b=base_b * (1 - mask) + bx * mask)
        res = lt.solve_unrolled(tree, lt.SolverParams(**PARAMS), qv, prob, num_iters=N_ITERS)
        return (res.nu ** 2).sum()

    gb, gq = torch.autograd.grad(loss(bz, qt), (bz, qt))
    with torch.no_grad():
        eps = 1e-5
        fd = (float(loss(torch.tensor(0.1 + eps, dtype=torch.float64), torch.as_tensor(q)))
              - float(loss(torch.tensor(0.1 - eps, dtype=torch.float64), torch.as_tensor(q)))
              ) / (2 * eps)
        np.testing.assert_allclose(float(gb), fd, rtol=1e-4)
        eps = 1e-6
        dq = np.zeros_like(q)
        dq[0, iq] = eps
        fdq = (float(loss(torch.tensor(0.1, dtype=torch.float64), torch.as_tensor(q + dq)))
               - float(loss(torch.tensor(0.1, dtype=torch.float64), torch.as_tensor(q - dq)))
               ) / (2 * eps)
    assert abs(fdq) > 1e-6            # the head's angle really moves the solve
    np.testing.assert_allclose(float(gq[0, iq]), fdq, rtol=5e-4, atol=1e-8)


def test_warm_state(task):
    """A warm start: the unrolled solve from a converged state equals the
    warm while-loop solve with the same budget, needs fewer iterations than
    the cold solve, and its gradient matches a central difference."""
    _, tree, _, problem, q = task
    qt = torch.as_tensor(q)
    cold = lt.solve(tree, lt.SolverParams(**PARAMS), qt, problem)
    warm_params = dict(PARAMS, warm_start=True)
    moved = with_bz(problem, torch.tensor(0.11, dtype=torch.float64))
    res = lt.solve_unrolled(tree, lt.SolverParams(**warm_params), qt, moved,
                            num_iters=N_ITERS, warm_state=cold.state)
    ref = lt.solve(tree, lt.SolverParams(**dict(warm_params, max_iter=N_ITERS + 1)), qt, moved,
                   warm_state=cold.state)
    np.testing.assert_array_equal(res.iterations.numpy(), ref.iterations.numpy())
    np.testing.assert_allclose(res.nu.numpy(), ref.nu.numpy(), rtol=0, atol=1e-12)
    assert bool((res.iterations < cold.iterations).all())

    def loss(bz):
        out = lt.solve_unrolled(tree, lt.SolverParams(**warm_params), qt, with_bz(problem, bz),
                                num_iters=N_ITERS, warm_state=cold.state)
        return (out.nu ** 2).sum()

    bz = torch.tensor(0.11, dtype=torch.float64, requires_grad=True)
    g, = torch.autograd.grad(loss(bz), bz)
    with torch.no_grad():
        eps = 1e-5
        fd = (float(loss(torch.tensor(0.11 + eps, dtype=torch.float64)))
              - float(loss(torch.tensor(0.11 - eps, dtype=torch.float64)))) / (2 * eps)
    np.testing.assert_allclose(float(g), fd, rtol=1e-4)
