"""Multi-start global IK: the port's ranking (`multistart_from_configs`,
the body of `solve_multistart`) fed loik_tpu's own seeds
(`tree.random_configuration(key, (n,))`: the two packages draw differently,
so their samplers cannot agree bit for bit), against loik_tpu's
`solve_multistart` on a one-device CPU mesh.

Budgets.  With the default float64 `solve` both packages do the same
arithmetic up to XLA's: num_converged equal, and on every finite slot the
same seed, nu within 1e-10 and the task error within 1e-12 (the budget of
tests/test_torch_solve.py).  With the float32 delta-duals `solve_fn` the
outcome is the compiled-reference budget of tests/test_torch_two_stage.py:
converged flags per seed within max(1, B/100), converged nu within 5e-5,
so num_converged within that and the finite slots as many; their errors are
task residuals of certified solves (at most 1e-5 either side).  Slots
beyond num_converged are inf in both; `jax.lax.top_k` and `torch.topk` need
not order equal keys alike, so only the finite slots are compared.

`task_error` with a per-problem A: loik_tpu's einsum sums A over the batch
(`"...cij,bcj->bci"`: the leading batch of A is an ellipsis missing from
the output), so its score mixes problems; the port scores each problem on
its own A and is held to numpy there (ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu.parallel.multistart import solve_multistart as jmultistart
from loik_tpu.parallel.multistart import task_error as jtask_error
from loik_tpu.parallel.sharding import make_mesh
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver.refine import solve_delta_duals as jdelta
from loik_tpu_torch.parallel import multistart_from_configs, solve_multistart, task_error

from tests.test_torch_model import FLAGSHIP, pair

PARAMS = dict(FLAGSHIP, check_interval=1)
N_SEEDS, K = 32, 4


def _seeds(jt, seed=0):
    key = jax.random.PRNGKey(seed)
    return key, np.array(jt.random_configuration(key, (N_SEEDS,)))


def _finite(res):
    return np.isfinite(np.asarray(res.error))


def test_multistart_default_solve_matches_reference():
    jt, tt, jp, tp = pair("panda_arm", "float64")
    key, qs = _seeds(jt)
    res_j = jmultistart(jt, JParams(**PARAMS), jp, key, N_SEEDS,
                        mesh=make_mesh(jax.devices()[:1]), k=K)
    res_t = multistart_from_configs(tt, lt.SolverParams(**PARAMS), tp, torch.as_tensor(qs), K)
    assert res_t.num_converged.dtype == torch.int32 and res_t.num_converged.ndim == 0
    assert int(res_t.num_converged) == int(res_j.num_converged) >= K
    fin = _finite(res_j)
    np.testing.assert_array_equal(np.isfinite(res_t.error.numpy()), fin)
    np.testing.assert_array_equal(res_t.q.numpy()[fin], np.asarray(res_j.q)[fin])
    np.testing.assert_allclose(res_t.nu.numpy()[fin], np.asarray(res_j.nu)[fin], rtol=0, atol=1e-10)
    np.testing.assert_allclose(res_t.error.numpy()[fin], np.asarray(res_j.error)[fin],
                               rtol=0, atol=1e-12)
    assert (np.diff(res_t.error.numpy()[fin]) >= 0).all()
    assert res_t.found and res_t.q.shape == (K, tt.nq) and res_t.nu.shape == (K, tt.nv)


def _delta(fused):
    return lambda t, p, q, pr: lt.solve_delta_duals(t, p, q, pr, fused=fused)


def test_multistart_delta_solve_fn_matches_reference():
    jt, tt, jp, tp = pair("panda_arm", "float64")
    key, qs = _seeds(jt, seed=1)
    res_j = jmultistart(jt, JParams(**PARAMS), jp, key, N_SEEDS, k=K,
                        solve_fn=lambda t, p, q, pr: jdelta(t, p, q, pr, fused=False))
    res_t = multistart_from_configs(tt, lt.SolverParams(**PARAMS), tp, torch.as_tensor(qs),
                                    K, solve_fn=_delta(False))
    budget = max(1, N_SEEDS // 100)
    ct, cj = res_t.result.converged.numpy(), np.asarray(res_j.result.converged)
    assert (ct != cj).sum() <= budget
    both = ct & cj
    assert np.abs(res_t.result.nu.numpy()[both] - np.asarray(res_j.result.nu)[both]).max() <= 5e-5
    assert abs(int(res_t.num_converged) - int(res_j.num_converged)) <= budget
    fin_t = np.isfinite(res_t.error.numpy())
    assert fin_t.sum() == min(K, int(res_t.num_converged)) >= 1
    assert (res_t.error.numpy()[fin_t] <= 1e-5).all()
    assert (np.asarray(res_j.error)[_finite(res_j)] <= 1e-5).all()
    assert np.isinf(res_t.error.numpy()[~fin_t]).all()


def test_ranking_takes_converged_seeds_in_ascending_error():
    """Each finite slot is a converged seed whose own task error is the
    slot's; the slots ascend; no converged seed left out has a smaller
    error than the last slot's."""
    _, tt, _, tp = pair("panda_arm", "float64")
    qs = tt.random_configuration((N_SEEDS,), generator=torch.Generator().manual_seed(3))
    res = multistart_from_configs(tt, lt.SolverParams(**PARAMS), tp, qs, K)
    err = torch.where(res.result.converged, task_error(res.result, tp), float("inf"))
    order = torch.argsort(err)[:K]
    assert torch.equal(res.error, err[order])
    assert torch.equal(res.q, qs[order]) and torch.equal(res.nu, res.result.nu[order])
    assert int(res.num_converged) == int(res.result.converged.sum())


def test_solve_multistart_draws_from_the_generator():
    _, tt, _, tp = pair("panda_arm", "float64")
    params = lt.SolverParams(**PARAMS)
    res = solve_multistart(tt, params, tp, torch.Generator().manual_seed(4), 8, k=2)
    qs = tt.random_configuration((8,), generator=torch.Generator().manual_seed(4))
    want = multistart_from_configs(tt, params, tp, qs, 2)
    assert torch.equal(res.q, want.q) and torch.equal(res.error, want.error)
    assert res.result.nu.shape == (8, tt.nv)


def test_nothing_converged_is_not_found():
    _, tt, _, tp = pair("panda_arm", "float64")
    qs = tt.random_configuration((6,), generator=torch.Generator().manual_seed(5))
    res = multistart_from_configs(tt, lt.SolverParams(max_iter=1), tp, qs, 3)
    assert not res.found and int(res.num_converged) == 0
    assert torch.isinf(res.error).all()


@pytest.mark.parametrize("k", [0, -1, N_SEEDS + 1])
def test_k_is_validated(k):
    _, tt, _, tp = pair("panda_arm", "float64")
    with pytest.raises(ValueError, match="k must be in"):
        solve_multistart(tt, lt.SolverParams(), tp, None, N_SEEDS, k=k)
    with pytest.raises(ValueError, match="k must be in"):
        multistart_from_configs(tt, lt.SolverParams(), tp,
                                torch.zeros((N_SEEDS, tt.nq), dtype=torch.float64), k)


def test_task_error_shared_and_per_problem_A():
    """Shared A: loik_tpu's score.  Per-problem A: each problem's own
    max_c |A_c v_c - b_c|, against numpy (loik_tpu's sums A over the batch
    there, module docstring).  A float32 solution of a float64 problem is
    scored in float64."""
    rng = np.random.default_rng(6)
    B, links = 5, (3, 6)
    vis = rng.standard_normal((B, 7, 6))
    b = rng.standard_normal((B, 2, 6))

    def problem(A):
        return lt.IkProblem(H_ref=None, v_ref=None, A=torch.as_tensor(A), b=torch.as_tensor(b),
                            lb=None, ub=None, constraint_links=links)

    def result(v):
        return lt.SolveResult(*([None] * 2), vis=v, **{n: None for n in (
            "converged", "primal_infeasible", "dual_infeasible", "iterations",
            "tail_iterations", "primal_residual", "dual_residual", "state")})

    res = result(torch.as_tensor(vis))
    for A in (rng.standard_normal((2, 6, 6)), rng.standard_normal((B, 2, 6, 6))):
        A_b = np.broadcast_to(A, (B, 2, 6, 6))
        want = np.abs(np.einsum("bcij,bcj->bci", A_b, vis[:, list(links)]) - b).max(axis=(1, 2))
        np.testing.assert_allclose(task_error(res, problem(A)).numpy(), want, rtol=1e-14, atol=0)
    jres = result(jnp.asarray(vis))
    jprob = lt.IkProblem(H_ref=None, v_ref=None, A=np.array(A_b[0]), b=b, lb=None, ub=None,
                         constraint_links=links)
    np.testing.assert_allclose(task_error(res, problem(jprob.A)).numpy(),
                               np.asarray(jtask_error(jres, jprob)), rtol=1e-14, atol=0)
    res32 = result(torch.as_tensor(vis, dtype=torch.float32))
    assert task_error(res32, problem(jprob.A)).dtype == torch.float64
