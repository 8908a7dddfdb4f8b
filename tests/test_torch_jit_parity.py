"""The Newton step of examples/torch/06_differentiable_ik.py through
`loik_tpu_torch.utils.jit` against the JAX example's
``jax.jit(lambda bz: (loss(bz), jax.grad(loss)(bz), jax.grad(jax.grad(loss))(bz)))``
in float64 on the CPU: the same task (ur5, one task row A = e_z e_z', box
+-10, default parameters, the demonstration solved at b_z = 0.17), the
same numpy-seeded configurations (B = 4) and 30 body calls, at two
points.  The port's step runs eagerly (CPU tensors) and through the
stand-in capture of tests/test_torch_graphs.py (the graph path: static
buffers, a replay, fresh outputs).  loik_tpu compiles once: its step also
takes a Python float weight of the loss (``weight * loss``), which
`jax.jit` traces, and so does the port's `utils.jit`: two weights are one
compile and one capture, at the same tolerances.

Tolerances: the value rtol 1e-10; the gradient rtol 1e-8, as
tests/test_torch_diff.py's; the Hessian rtol 1e-10.  The gaps measured
here: 3.5e-16 and 1.0e-15 (value), 7.7e-16 and 4.1e-16 (gradient), 0 and 0
(Hessian) at the two points.  The file takes about 55 s alone, 40 of them
loik_tpu's compile.
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

from tests.test_torch_graphs import fake_graphs  # noqa: F401  (a fixture)
from tests.test_torch_model import q_batch

N_ITERS = 30
B_TRUE = 0.17
POINTS = (0.5, 0.2)
WEIGHTS = (0.5, 3.0)


def task():
    """(jax tree, port tree, jax problem, port problem, q) of example 06."""
    jt = jrobots.ur5()
    A = np.zeros((1, 6, 6))
    A[0, 2, 2] = 1.0
    jp = jmake_problem(jt, (jt.njoints - 1,), A=A, b=np.zeros((1, 6)),
                       lb=-10 * np.ones(jt.nv), ub=10 * np.ones(jt.nv))
    return (jt, convert.tree_from_arrays(jt, device="cpu"), jp,
            convert.problem_from_arrays(jp, device="cpu"), q_batch(jt, 4, seed=5))


@pytest.fixture(scope="module")
def runs():
    """The task and loik_tpu's (value, gradient, Hessian) at each point,
    from one compiled step."""
    jt, tt, jp, tp, q = task()

    def jsolve(bz):
        return jsolve_unrolled(jt, JParams(), q, jp.replace(b=jp.b.at[0, 2].set(bz)),
                               num_iters=N_ITERS)

    nu_demo = jsolve(B_TRUE).nu

    def loss(bz):
        return jnp.mean((jsolve(bz).nu - nu_demo) ** 2)

    def step(bz, weight):
        def weighted(b):
            return weight * loss(b)
        return weighted(bz), jax.grad(weighted)(bz), jax.grad(jax.grad(weighted))(bz)

    step_fn = jax.jit(step)
    want = [tuple(float(x) for x in step_fn(jnp.asarray(bz), 1.0)) for bz in POINTS]
    weighted = [tuple(float(x) for x in step_fn(jnp.asarray(POINTS[0]), w)) for w in WEIGHTS]
    return dict(tree=tt, problem=tp, q=torch.as_tensor(q), want=want, weighted=weighted,
                compiles=step_fn._cache_size())


def port_step(tree, problem, q):
    """examples/torch/06_differentiable_ik.py's step_fn, as a `utils.jit`
    function."""
    mask = (torch.arange(6) == 2).to(torch.float64)
    params = lt.SolverParams()

    def solve(bz):
        return lt.solve_unrolled(tree, params, q,
                                 problem.replace(b=problem.b * (1 - mask) + bz * mask),
                                 num_iters=N_ITERS)

    nu_demo = solve(torch.tensor(B_TRUE, dtype=torch.float64)).nu.detach()

    @lt.utils.jit
    def step_fn(bz, weight=1.0):
        bz.requires_grad_()
        val = weight * ((solve(bz).nu - nu_demo) ** 2).mean()
        g, = torch.autograd.grad(val, bz, create_graph=True)
        h, = torch.autograd.grad(g, bz)
        return val, g, h

    return step_fn


@pytest.mark.parametrize("path", ["eager", "graphed"])
def test_newton_step_matches_jax_jit(runs, path, request):
    from loik_tpu_torch.utils import graphs

    if path == "graphed":
        request.getfixturevalue("fake_graphs")
    n = len(graphs.CAPTURES)
    step = port_step(runs["tree"], runs["problem"], runs["q"])
    for bz, (jval, jg, jh) in zip(POINTS, runs["want"]):
        val, g, h = (float(t) for t in step(torch.tensor(bz, dtype=torch.float64)))
        np.testing.assert_allclose(val, jval, rtol=1e-10)
        np.testing.assert_allclose(g, jg, rtol=1e-8)
        np.testing.assert_allclose(h, jh, rtol=1e-10)
    assert len(graphs.CAPTURES) == n + (path == "graphed")


def test_weighted_step_traces_the_weight_as_jax_jit_does(runs, fake_graphs):
    """The step with a Python float weight: `jax.jit` compiled it once for
    every weight, and the port's `utils.jit` captures it once; each weight's
    value, gradient and Hessian agree with loik_tpu's."""
    from loik_tpu_torch.utils import graphs

    assert runs["compiles"] == 1
    n = len(graphs.CAPTURES)
    step = port_step(runs["tree"], runs["problem"], runs["q"])
    bz = torch.tensor(POINTS[0], dtype=torch.float64)
    for w, (jval, jg, jh) in zip(WEIGHTS, runs["weighted"]):
        val, g, h = (float(t) for t in step(bz, w))
        np.testing.assert_allclose(val, jval, rtol=1e-10)
        np.testing.assert_allclose(g, jg, rtol=1e-8)
        np.testing.assert_allclose(h, jh, rtol=1e-10)
    assert len(graphs.CAPTURES) == n + 1
