"""The port's batch split over a 1-D device mesh (`parallel.sharding`) on
a mesh of eight repetitions of the CPU device, against loik_tpu's
`solve_sharded` on its 8 virtual CPU devices (tests/conftest.py).

Budgets: float64, so the two packages agree up to XLA's rounding (the
budget of tests/test_torch_solve.py): nu within 1e-10, converged flags and
iteration counts equal.  Within the port a sharded solve runs the same
per-problem arithmetic as the unsharded one, so there the results are
equal bit for bit.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu.model import robots as jrobots
from loik_tpu.parallel import convergence_metrics as jmetrics
from loik_tpu.parallel import make_mesh as jmake_mesh
from loik_tpu.parallel import solve_sharded as jsolve_sharded
from loik_tpu.params import SolverParams as JParams
from loik_tpu.problem import make_problem as jmake_problem
from loik_tpu_torch.convert import problem_from_arrays, tree_from_arrays
from loik_tpu_torch.parallel import (Mesh, convergence_metrics, make_mesh,
                                     shard_problem_batch, solve_multistart, solve_sharded)
from loik_tpu_torch.parallel.sharding import run_sharded

from tests.test_oracle import fixture_problem

PARAMS = dict(max_iter=200, tol_abs=1e-6, tol_rel=1e-6)
CPU8 = ["cpu"] * 8
# two distinct device keys whose blocks interleave: two host threads, and
# the rows put back in mesh order after the gather
CPU_PAIR = ["cpu", "cpu:0"] * 4


def _np(x):
    return x.detach().cpu().numpy()


@pytest.fixture(scope="module")
def panda_runs():
    """The panda fixture at B=64 (f64): loik_tpu sharded over 8 virtual
    devices, the port sharded over 8 CPU repetitions and unsharded."""
    jt = jrobots.panda()
    jp = fixture_problem(jt, b3=0.2)
    q = np.array(jt.random_configuration(jax.random.PRNGKey(1), (64,)))
    ref = jsolve_sharded(jt, JParams(**PARAMS), jnp.asarray(q), jp, jmake_mesh())
    tt, tp = tree_from_arrays(jt, device="cpu"), problem_from_arrays(jp, device="cpu")
    qt = torch.as_tensor(q)
    sharded = solve_sharded(tt, lt.SolverParams(**PARAMS), qt, tp, make_mesh(CPU8))
    whole = lt.solve(tt, lt.SolverParams(**PARAMS), qt, tp)
    return dict(ref=ref, sharded=sharded, whole=whole, tree=tt, problem=tp, q=qt)


def test_mesh():
    mesh = make_mesh(CPU8)
    assert isinstance(mesh, Mesh) and mesh.size == 8
    assert mesh.axis_names == ("batch",)
    assert mesh.devices == (torch.device("cpu"),) * 8
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_sharded_matches_reference(panda_runs):
    ref, got = panda_runs["ref"], panda_runs["sharded"]
    assert len(ref.nu.sharding.device_set) == 8
    np.testing.assert_allclose(_np(got.nu), np.asarray(ref.nu), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(_np(got.converged), np.asarray(ref.converged))
    np.testing.assert_array_equal(_np(got.iterations), np.asarray(ref.iterations))
    assert got.converged.sum() > 32 and got.nu.shape == (64, panda_runs["tree"].nv)


def test_sharded_equals_unsharded_bitwise(panda_runs):
    got, whole = panda_runs["sharded"], panda_runs["whole"]
    for name in ("nu", "z", "vis", "converged", "primal_infeasible", "iterations",
                 "tail_iterations", "primal_residual", "dual_residual"):
        assert torch.equal(getattr(got, name), getattr(whole, name)), name
    for name in ("vis", "nu", "w", "yis", "mu", "iterations"):
        assert torch.equal(getattr(got.state, name), getattr(whole.state, name)), name


def test_convergence_metrics(panda_runs):
    got = convergence_metrics(panda_runs["sharded"])
    want = jmetrics(panda_runs["ref"])
    assert set(got) == set(want)
    for k in ("num_converged", "num_primal_infeasible", "max_iterations"):
        assert int(got[k]) == int(want[k]), k
    for k in ("mean_iterations", "mean_iterations_converged"):
        assert got[k].dtype == torch.float64
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    res = panda_runs["sharded"]
    conv, it = _np(res.converged), _np(res.iterations).astype(np.float64)
    assert float(got["mean_iterations"]) == it.sum() / it.size
    assert float(got["mean_iterations_converged"]) == it[conv].sum() / max(conv.sum(), 1)


def test_sharded_warm_state_split(panda_runs):
    """A warm state goes to the shards split along its batch axis: the
    sharded warm re-solve equals the unsharded one bit for bit."""
    tt, tp, q = panda_runs["tree"], panda_runs["problem"], panda_runs["q"]
    params = lt.SolverParams(**PARAMS, warm_start=True)
    b = tp.b.clone()
    b[0, 2] = 0.15
    tp2 = tp.replace(b=b)
    got = solve_sharded(tt, params, q, tp2, make_mesh(CPU8),
                        warm_state=panda_runs["whole"].state)
    want = lt.solve(tt, params, q, tp2, panda_runs["whole"].state)
    assert torch.equal(got.nu, want.nu) and torch.equal(got.iterations, want.iterations)
    assert torch.equal(got.state.w, want.state.w)


@pytest.mark.parametrize("devices, batches", [(CPU8, [64]), (CPU_PAIR, [32, 32])])
@pytest.mark.parametrize("warm", [False, True])
def test_one_solve_per_device(panda_runs, devices, batches, warm):
    """Each distinct device solves all its blocks as one batch, on a host
    thread of its own when there are several; the rows come back in mesh
    order, equal to the unsharded solve bit for bit (a warm state split
    the same way)."""
    tt, tp, q = panda_runs["tree"], panda_runs["problem"], panda_runs["q"]
    params = lt.SolverParams(**PARAMS, warm_start=warm)
    st = panda_runs["whole"].state if warm else None
    calls = []

    def counting(*args):
        calls.append((args[2].shape[0], threading.current_thread()))
        return lt.solve(*args)

    got = run_sharded(tt, params, q, tp, make_mesh(devices), st, solve_fn=counting)
    want = lt.solve(tt, params, q, tp, st)
    assert sorted(n for n, _ in calls) == batches
    on_main = [t is threading.main_thread() for _, t in calls]
    assert on_main == [len(batches) == 1] * len(batches)
    for name in ("nu", "converged", "iterations", "primal_residual"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in ("vis", "w", "yis", "mu"):
        assert torch.equal(getattr(got.state, name), getattr(want.state, name)), name


def test_sharded_per_problem_targets():
    """Per-problem targets (a leading batch axis on b) are split with the
    rows; shared leaves go to every shard once."""
    jt = jrobots.ur5()
    B = 16
    b = np.zeros((B, 1, 6))
    b[:, 0, 2] = np.linspace(0.05, 0.4, B)
    jp = jmake_problem(jt, (jt.njoints - 1,)).replace(b=jnp.asarray(b))
    q = np.broadcast_to(np.asarray(jt.neutral()), (B, jt.nq)).copy()
    ref = jsolve_sharded(jt, JParams(**PARAMS), jnp.asarray(q), jp, jmake_mesh())
    tt, tp = tree_from_arrays(jt, device="cpu"), problem_from_arrays(jp, device="cpu")
    mesh = make_mesh(CPU8)
    shards = shard_problem_batch(mesh, torch.as_tensor(q), tp)
    assert all(s[1].b.shape == (2, 1, 6) for s in shards)
    for i, (_, p) in enumerate(shards):
        assert torch.equal(p.b, tp.b[2 * i:2 * i + 2])
        assert p.A is shards[0][1].A  # the shared leaf, copied once
    got = solve_sharded(tt, lt.SolverParams(**PARAMS), torch.as_tensor(q), tp, mesh)
    assert bool(got.converged.all())
    np.testing.assert_allclose(_np(got.nu), np.asarray(ref.nu), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(_np(got.iterations), np.asarray(ref.iterations))
    np.testing.assert_allclose(_np(got.vis[:, -1, 2]), b[:, 0, 2], atol=1e-5)


def test_indivisible_batch_raises(panda_runs):
    tt, tp, q = panda_runs["tree"], panda_runs["problem"], panda_runs["q"]
    with pytest.raises(ValueError, match="not divisible by mesh size 8"):
        solve_sharded(tt, lt.SolverParams(**PARAMS), q[:12], tp, make_mesh(CPU8))
    with pytest.raises(ValueError, match="not divisible by mesh size 8"):
        solve_multistart(tt, lt.SolverParams(**PARAMS), tp, torch.Generator(), 12,
                         mesh=make_mesh(CPU8))


@pytest.mark.parametrize("solve_fn", [None, "delta"])
def test_multistart_mesh_equals_no_mesh(solve_fn):
    """The same generator state gives the same seeds with or without a
    mesh, and on the CPU the same solutions and ranking, bit for bit."""
    tree = lt.robots.panda_arm(device="cpu")
    problem = lt.make_problem(tree, (6,), b=np.array([[0, 0, 0.2, 0, 0, 0.0]]),
                              lb=-4 * np.ones(7), ub=4 * np.ones(7))
    params = lt.SolverParams(max_iter=60, tol_abs=1e-6, tol_rel=1e-6, check_interval=4)
    fn = None if solve_fn is None else (
        lambda t, p, q, pr: lt.solve_delta_duals(t, p, q, pr, stage1_max_iter=16))
    runs = [solve_multistart(tree, params, problem, torch.Generator().manual_seed(3), 32,
                             mesh=mesh, solve_fn=fn, k=4)
            for mesh in (None, make_mesh(["cpu"] * 4))]
    a, b = runs
    for name in ("q", "nu", "error", "num_converged"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.result.nu, b.result.nu)
    assert torch.equal(a.result.iterations, b.result.iterations)
    assert a.found and bool((a.error[1:] >= a.error[:-1]).all())
