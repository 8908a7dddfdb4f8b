"""`loik_tpu_torch.utils.jit`, the counterpart of `jax.jit` at the loss
level, on the CPU: its keys, fresh results, the calls that run eagerly, a
failed capture, and derivatives taken inside it (the differentiable
solve's training step, first and second order) equal to eager ones bit
for bit.  The graph path runs through the stand-in capture of
tests/test_torch_graphs.py (`fake_graphs`: the warm-up, one recorded call,
replays that call the function again on the static buffers), whose
recorded call also checks that the step reads nothing on the host.  And
`solve_unrolled` keeps its bits with its checkpoints saving no generator
state.

The card's own test is in tests/test_torch_kernel.py
(`test_jit_training_step_on_card_equals_eager`).
"""

import functools
import sys

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import loik_tpu_torch as lt
from loik_tpu_torch.utils import graphs, jit

from tests.test_torch_graphs import fake_graphs  # noqa: F401  (a fixture)

diff = sys.modules["loik_tpu_torch.solver.diff"]

N_ITERS = 8


def task(B=3, dtype=torch.float64, seed=0):
    """(tree, params, q, problem, mask): ur5 with one task row (A = e_z e_z',
    b_z the parameter), box +-10, q from a seeded numpy generator."""
    tree = lt.robots.ur5(str(dtype).removeprefix("torch."), device="cpu")
    A = np.zeros((1, 6, 6))
    A[0, 2, 2] = 1.0
    problem = lt.make_problem(tree, (tree.njoints - 1,), A=A, b=np.zeros((1, 6)),
                              lb=-10 * np.ones(tree.nv), ub=10 * np.ones(tree.nv))
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.uniform(-np.pi, np.pi, (B, tree.nq)), dtype=dtype)
    mask = (torch.arange(6) == 2).to(dtype)
    return tree, lt.SolverParams(tol_abs=1e-10, tol_rel=1e-10), q, problem, mask


def loss(tree, params, q, problem, mask, bz):
    prob = problem.replace(b=problem.b * (1 - mask) + bz * mask)
    return (lt.solve_unrolled(tree, params, q, prob, num_iters=N_ITERS).nu ** 2).sum()


def first_order(tree, params, problem, mask):
    """The first-order step: (loss, d/d b_z, d/d q)."""
    def step(bz, q):
        bz.requires_grad_()
        q.requires_grad_()
        value = loss(tree, params, q, problem, mask, bz)
        gb, gq = torch.autograd.grad(value, (bz, q))
        return value, gb, gq
    return step


def newton(tree, params, q, problem, mask):
    """The Newton step of examples/torch/06_differentiable_ik.py: (loss,
    gradient, Hessian) in b_z."""
    def step(bz):
        bz.requires_grad_()
        value = loss(tree, params, q, problem, mask, bz)
        g, = torch.autograd.grad(value, bz, create_graph=True)
        h, = torch.autograd.grad(g, bz)
        return value, g, h
    return step


def assert_bits(got, want):
    a, b = [], []
    assert graphs._flatten(got, a) == graphs._flatten(want, b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def toy(x, y, scale):
    return (x * y * scale).sum(), x + y


# --------------------------------------------------------------------------- #


def test_captures_once_per_key(fake_graphs):
    """One capture per key: the same shapes and statics replay; another
    dtype, shape or static captures anew.  The key holds the function by
    identity (a second `jit` of it shares its graphs), and the capture is
    logged under its name.  Every result equals the eager call's."""
    f = jit(toy)
    x, y = torch.randn(3, 4, dtype=torch.float64), torch.randn(3, 4, dtype=torch.float64)
    n = len(graphs.CAPTURES)
    calls = [((x, y, 2.0), 1), ((x + 1, y, 2.0), 1), ((x.float(), y.float(), 2.0), 2),
             ((x[:2], y[:2], 2.0), 3), ((x, y, 3.0), 4), ((x - 1, y, 3.0), 4)]
    for args, captures in calls:
        got = f(*args)
        assert len(graphs.CAPTURES) == n + captures
        assert_bits(got, toy(*args))
    assert graphs.CAPTURES[-1].tag == "toy"
    jit(toy)(x, y, 2.0)
    assert len(graphs.CAPTURES) == n + 4


def test_replays_return_fresh_unaliased_results(fake_graphs):
    """A second call with other inputs leaves the first call's results as
    they were; no result is a static buffer or a caller's tensor; a tensor
    returned twice is one fresh tensor; results carry no autograd record."""
    def f(x, y):
        s = x * y
        return s, s, x

    g = jit(f)
    x, y = torch.randn(5), torch.randn(5)
    g(x, y)                                  # captures
    first = g(x, y)                          # replays
    kept = [t.clone() for t in first]
    second = g(x + 1, y * 2)
    for a, b in zip(first, kept):
        assert torch.equal(a, b)
    assert not torch.equal(first[0], second[0])
    assert first[0] is first[1] and first[2] is not x
    assert first[2].data_ptr() != x.data_ptr()
    assert all(not t.requires_grad and t.grad_fn is None for t in first)


@pytest.mark.parametrize("block", ["cpu", "disable_graphs", "debug_nans"])
def test_eager_calls(block, request):
    """On CPU tensors, under `disable_graphs()` and under `debug_nans()` the
    function runs eagerly on detached aliases: nothing is captured, the
    caller's tensors are not marked, the results are detached."""
    if block != "cpu":
        request.getfixturevalue("fake_graphs")
    tree, params, q, problem, mask = task(B=2)
    step = jit(newton(tree, params, q, problem, mask))
    bz = torch.tensor(0.1, dtype=torch.float64)
    n = len(graphs.CAPTURES)
    if block == "disable_graphs":
        with graphs.disable_graphs():
            got = step(bz)
    elif block == "debug_nans":
        with lt.utils.debug_nans():
            got = step(bz)
    else:
        got = step(bz)
    assert len(graphs.CAPTURES) == n
    assert not bz.requires_grad
    assert all(t.grad_fn is None and not t.requires_grad for t in got)
    assert_bits(got, newton(tree, params, q, problem, mask)(bz.clone()))


def test_inputs_that_require_grad_run_eagerly(fake_graphs):
    """An argument that already requires a gradient runs the function as it
    is, eagerly: its results stay differentiable back to that argument
    (a graph would cut the record).  Under no_grad the call captures."""
    f = jit(toy)
    x, y = torch.randn(3, requires_grad=True), torch.randn(3)
    n = len(graphs.CAPTURES)
    s, _ = f(x, y, 2.0)
    assert len(graphs.CAPTURES) == n
    gx, = torch.autograd.grad(s, x)
    assert torch.equal(gx, 2.0 * y)
    with torch.no_grad():
        f(x, y, 2.0)
    assert len(graphs.CAPTURES) == n + 1


def test_failed_capture_raises_under_the_function_name(fake_graphs):
    """A function that fails in its capture raises under its name; nothing
    is cached and it never runs eagerly instead; the next good key
    captures."""
    calls = []

    def bad_step(x):
        calls.append(1)
        if len(calls) == 2:        # the warm-up passes, the capture fails
            raise ValueError("not capturable")
        return x * 2

    f = jit(bad_step)
    x = torch.ones(3)
    n = graphs.cached_graphs()
    with pytest.raises(RuntimeError, match="bad_step: capturing the CUDA graph failed"):
        f(x)
    assert graphs.cached_graphs() == n and not graphs._INSIDE.active
    assert torch.equal(f(x), x * 2) and graphs.cached_graphs() == n + 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("order", ["first", "newton"])
def test_derivatives_inside_jit_equal_eager_bit_for_bit(order, dtype, fake_graphs):
    """The training step through `solve_unrolled` (first order: the loss, d/d
    b_z and d/d q; Newton: the loss, its gradient and Hessian with
    ``create_graph=True``) graphed equals the same step eagerly, on the
    first call, on a replay and on a replay with other inputs; the recorded
    call reads nothing on the host (a checkpoint's recompute in the
    backward runs the same body as the forward; the backward's own
    operators are counted on the card, chip_smoke.py phase 20)."""
    tree, params, q, problem, mask = task(dtype=dtype)
    if order == "first":
        fn = first_order(tree, params, problem, mask)
        inputs = [(torch.tensor(0.1, dtype=dtype), q), (torch.tensor(0.3, dtype=dtype), q.flip(0))]
    else:
        fn = newton(tree, params, q, problem, mask)
        inputs = [(torch.tensor(0.1, dtype=dtype),), (torch.tensor(0.3, dtype=dtype),)]
    step = jit(fn)
    n = len(graphs.CAPTURES)
    got = [step(*inputs[0]), step(*inputs[0]), step(*inputs[1])]
    assert len(graphs.CAPTURES) == n + 1
    assert fake_graphs.reads[-1] == []
    with graphs.disable_graphs():
        want = [step(*inputs[0]), step(*inputs[1])]
    for g, w in zip(got, [want[0], want[0], want[1]]):
        assert_bits(g, w)
    assert all(bool(torch.isfinite(t).all()) for t in got[2])
    assert not torch.equal(got[0][1], got[2][1])


def test_solve_unrolled_saves_no_generator_state(monkeypatch):
    """`solve_unrolled`'s checkpoints save and restore no generator state (a
    capture allows neither): forward and backward run with torch's RNG
    state calls refused, and give the bits of checkpoints that preserve the
    state (the body draws no random numbers)."""
    tree, params, q, problem, mask = task()
    step = newton(tree, params, q, problem, mask)
    bz = torch.tensor(0.1, dtype=torch.float64)
    preserving = functools.partial(checkpoint, preserve_rng_state=True)
    with monkeypatch.context() as m:
        m.setattr(diff, "checkpoint",
                  lambda fn, *a, **kw: preserving(fn, *a, **dict(kw, preserve_rng_state=True)))
        want = step(bz.clone())

    def refused(*a, **kw):
        raise AssertionError("generator state read or set")

    monkeypatch.setattr(torch, "get_rng_state", refused)
    monkeypatch.setattr(torch, "set_rng_state", refused)
    got = step(bz.clone())
    assert_bits(got, want)
