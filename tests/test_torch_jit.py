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
    dtype or shape captures anew, another float does not (it is traced,
    as `jax.jit` traces it).  The key holds the function by identity (a
    second `jit` of it shares its graphs), and the capture is logged under
    its name.  Every result equals the eager call's."""
    f = jit(toy)
    x, y = torch.randn(3, 4, dtype=torch.float64), torch.randn(3, 4, dtype=torch.float64)
    n = len(graphs.CAPTURES)
    calls = [((x, y, 2.0), 1), ((x + 1, y, 2.0), 1), ((x.float(), y.float(), 2.0), 2),
             ((x[:2], y[:2], 2.0), 3), ((x, y, 3.0), 3), ((x - 1, y, 3.0), 3)]
    for args, captures in calls:
        got = f(*args)
        assert len(graphs.CAPTURES) == n + captures
        assert_bits(got, toy(*args))
    assert graphs.CAPTURES[-1].tag == "toy"
    jit(toy)(x, y, 2.0)
    assert len(graphs.CAPTURES) == n + 3


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


# --------------------------------------------------------------------------- #
# traced numbers, as `jax.jit` traces them
# --------------------------------------------------------------------------- #


def scaled(x, s):
    """Divides by the scalar too: on the card torch divides by a Python
    float as a multiply by its reciprocal, by a 0-d tensor exactly."""
    return x / s + s * x, (x * s).sum()


def test_hundred_floats_make_one_capture(fake_graphs):
    """100 distinct Python floats: one capture; each result equals the
    eager call (`disable_graphs()`, which hands the function the same 0-d
    float64 tensor) and the function called with that tensor bit for bit,
    and the function called with the raw float within 2 ulp of float64
    (here on the CPU they agree exactly; on the card a division by the raw
    float is a multiply by its reciprocal)."""
    f = jit(scaled)
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(4, 5)))
    n = len(graphs.CAPTURES)
    for s in np.random.default_rng(4).uniform(0.1, 10.0, 100).tolist():
        got = f(x, s)
        with graphs.disable_graphs():
            assert_bits(got, f(x, s))
        assert_bits(got, scaled(x, torch.tensor(s, dtype=torch.float64)))
        for a, b in zip(got, scaled(x, s)):
            torch.testing.assert_close(a, b, rtol=2 * 2.0 ** -52, atol=0.0)
    assert len(graphs.CAPTURES) == n + 1
    assert fake_graphs.reads[-1] == []


def as_seen(x, v):
    """``v`` as the function sees it (a 0-d tensor when traced), and x * v."""
    return v.clone(), x * v


@pytest.mark.parametrize("values,dtype", [
    ((2, 3), torch.int64), ((True, False), torch.bool), ((0.5, 1e-300), torch.float64),
    ((np.float32(0.5), np.float32(3.0)), torch.float32),
    ((np.int16(-2), np.int16(7)), torch.int16), ((1 + 2j, -1j), torch.complex128)])
def test_numbers_are_traced_by_type(values, dtype, fake_graphs):
    """Python ints, bools, floats and complex numbers and numpy scalars are
    traced: two values are one capture and reach the function as 0-d
    tensors of their dtype (a numpy scalar keeps its own); another Python
    type at the same place is another key.  Results equal the eager call's."""
    f = jit(as_seen)
    x = torch.arange(1.0, 4.0, dtype=torch.float64)
    n = len(graphs.CAPTURES)
    for v in values:
        got = f(x, v)
        assert got[0].dtype == dtype and got[0].shape == ()
        assert got[0].item() == v
        with graphs.disable_graphs():
            assert_bits(got, f(x, v))
    assert len(graphs.CAPTURES) == n + 1
    other = 1.5 if dtype != torch.float64 else 1
    f(x, other)
    assert len(graphs.CAPTURES) == n + 2


def test_numbers_inside_tuples_and_lists_are_traced(fake_graphs):
    """A number in a tuple or list among the arguments is traced too."""
    f = jit(lambda x, ab: x * ab[0] + ab[1][0])
    x = torch.ones(3, dtype=torch.float64)
    n = len(graphs.CAPTURES)
    for a, b in ((2.0, 1.0), (3.0, -1.0), (0.25, 7.0)):
        assert torch.equal(f(x, (a, [b])), x * a + b)
    assert len(graphs.CAPTURES) == n + 1


def scale_by(x, scale):
    seen.append(type(scale))
    return x * scale


seen: list = []


@pytest.mark.parametrize("how", ["argnums", "negative argnums", "argnames",
                                 "argnames given by position", "argnums given by name"])
def test_static_arguments_are_baked_in(how, fake_graphs):
    """``static_argnums`` / ``static_argnames`` bake a value in, as
    `jax.jit`'s do: two values are two captures, and the function gets the
    Python number itself.  Either marks the other through the signature."""
    opts = {"argnums": dict(static_argnums=1), "negative argnums": dict(static_argnums=(-1,)),
            "argnames": dict(static_argnames="scale"),
            "argnames given by position": dict(static_argnames=("scale",)),
            "argnums given by name": dict(static_argnums=(1,))}[how]
    f = jit(scale_by, **opts)
    x = torch.ones(3)
    n = len(graphs.CAPTURES)
    seen.clear()
    for s in (2.0, 3.0, 2.0):
        if how in ("argnames", "argnums given by name"):
            got = f(x, scale=s)
        else:
            got = f(x, s)
        assert torch.equal(got, x * s)
    assert len(graphs.CAPTURES) == n + 2
    assert set(seen) == {float}


def test_keyword_arguments_are_traced(fake_graphs):
    """Keyword arguments are traced like positional ones and keyed by
    name, in whatever order they are given."""
    def f(x, *, scale, shift=0.0):
        return x * scale + shift

    g = jit(f)
    x = torch.arange(3.0, dtype=torch.float64)
    n = len(graphs.CAPTURES)
    got = [g(x, scale=2.0, shift=1.0), g(x, shift=-1.0, scale=0.5), g(x, scale=4.0, shift=0.0)]
    assert len(graphs.CAPTURES) == n + 1
    for r, (a, b) in zip(got, ((2.0, 1.0), (0.5, -1.0), (4.0, 0.0))):
        with graphs.disable_graphs():
            assert_bits(r, g(x, scale=a, shift=b))
        assert torch.equal(r, x * a + b)
    g(x, scale=2.0)
    assert len(graphs.CAPTURES) == n + 2


def branch(x, flag):
    return x + 1 if flag else x - 1


def repeat(x, n):
    for _ in range(n):
        x = x * 2
    return x


@pytest.mark.parametrize("fn,value,name", [(branch, True, "'flag'"), (repeat, 3, "'n'")])
def test_control_flow_on_a_traced_scalar_raises(fn, value, name, fake_graphs):
    """``if flag:`` on a traced bool and ``range(n)`` on a traced int raise
    in the capture, naming the argument and ``static_argnums`` /
    ``static_argnames`` (jax's ConcretizationTypeError); nothing is cached
    and the value is never baked in.  Marked static, the same calls
    capture once per value."""
    f = jit(fn)
    x = torch.ones(2)
    cached = graphs.cached_graphs()
    with pytest.raises(RuntimeError, match=f"{name} .*static_argnums / static_argnames") as e:
        f(x, value)
    assert isinstance(e.value.__cause__, graphs.ConcretizationTypeError)
    assert graphs.cached_graphs() == cached
    g = jit(fn, static_argnums=1)
    assert torch.equal(g(x, value), fn(x, value))
    assert graphs.cached_graphs() == cached + 1


def test_a_dataclass_field_that_is_no_tensor_stays_static(fake_graphs):
    """A dataclass's non-tensor field stays static, as the aux data of a
    pytree does in jax: two values are two captures."""
    f = jit(lambda prob: (prob.b * len(prob.constraint_links)).sum())
    tree, params, q, problem, mask = task(B=2)
    n = len(graphs.CAPTURES)
    other = problem.replace(constraint_links=(0, tree.njoints - 1))
    for p in (problem, problem, other):
        assert torch.equal(f(p), (p.b * len(p.constraint_links)).sum())
    assert len(graphs.CAPTURES) == n + 2


@pytest.mark.parametrize("x,v,dtype", [
    (torch.ones(3), 2.5, torch.float32),                        # as jax's weak type
    (torch.ones(3, dtype=torch.int32), 2, torch.int32),         # as jax's weak type
    (torch.ones(3, dtype=torch.float16), 2.5, torch.float16),   # as jax's weak type
    (torch.tensor(1.0), 2.5, torch.float64),                    # jax: float32
    (torch.ones(3, dtype=torch.int32), 2.5, torch.float64),     # jax: float32 without x64
])
def test_promotion_of_traced_numbers(x, v, dtype, fake_graphs):
    """The dtypes the docstring states: a traced number is a 0-d tensor, so
    it promotes as torch's 0-d tensors do."""
    got = jit(lambda a, b: a * b)(x, v)
    assert got.dtype == dtype
    with graphs.disable_graphs():
        assert jit(lambda a, b: a * b)(x, v).dtype == dtype


@pytest.mark.parametrize("graphed", [False, True])
def test_a_failed_scalar_copy_raises_under_the_function_name(graphed, request):
    """A number no tensor holds (an int beyond int64) raises under the
    function's name, graphed or eager, and nothing is captured."""
    if graphed:
        request.getfixturevalue("fake_graphs")
    f = jit(toy)
    x = torch.ones(3)
    n = len(graphs.CAPTURES)
    with pytest.raises(RuntimeError, match="toy: copying its scalar arguments to cpu failed"):
        f(x, x, 2 ** 70)
    assert len(graphs.CAPTURES) == n


def test_a_function_of_numbers_only_runs_eagerly(fake_graphs):
    """With no tensor argument the numbers are 0-d CPU tensors and the
    function runs eagerly: nothing is captured."""
    n = len(graphs.CAPTURES)
    got = jit(lambda a, b: a * b)(3, 0.5)
    assert got.dtype == torch.float64 and float(got) == 1.5
    assert len(graphs.CAPTURES) == n


def test_capture_records_its_parts(fake_graphs):
    """`Capture` splits a first call into warm-up, record and instantiate
    (the stand-in instantiates nothing: 0); their sum is ``seconds``."""
    jit(toy)(torch.ones(3), torch.ones(3), 2.0)
    c = graphs.CAPTURES[-1]
    assert c.warm_seconds > 0 and c.record_seconds > 0 and c.instantiate_seconds == 0.0
    assert c.warm_seconds + c.record_seconds + c.instantiate_seconds == c.seconds
