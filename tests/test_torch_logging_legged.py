"""Per-iteration logging on a legged robot and against the committed golden
trajectories, in float64 on the CPU, and a logged state carried across
from loik_tpu.

- solo12 (bench.py's stance task: a base twist command and four point-foot
  constraints, box +-12) at B=8: all 12 log fields against loik_tpu's at
  check_interval 1 and 3, as tests/test_torch_logging.py holds ur5 (one
  loik_tpu compile each);
- the port's log_rp / log_rd / log_mu and final nu / z against
  tests/golden/traces.json on its four robots, at tests/test_golden_trace.py's
  bounds for loik_tpu's fast solver (reading the JSON needs no JAX);
- `convert.state_from_arrays` / `state_to_numpy` carry a logged loik_tpu
  state's logs, and the port resumes from it.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver import solve as jsolve
from loik_tpu_torch import convert
from loik_tpu_torch.solver.state import LOG_FIELDS

from tests.test_torch_logging import assert_logs_match
from tests.test_torch_model import LEGGED, pair, q_batch

B = 8
PARAMS = dict(LEGGED, max_iter=60)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "traces.json")
with open(GOLDEN) as f:
    DOC = json.load(f)


@pytest.fixture(scope="module")
def runs():
    """check_interval -> (port result, loik_tpu result), both logged, and
    the inputs."""
    jt, tt, jp, tp = pair("solo12")
    q = q_batch(jt, B, seed=4)
    out = {}
    for K in (1, 3):
        params = dict(PARAMS, check_interval=K, logging=True)
        out[K] = (lt.solve(tt, lt.SolverParams(**params), torch.as_tensor(q), tp),
                  jsolve(jt, JParams(**params), jnp.asarray(q), jp))
    return out, (tt, tp, q)


@pytest.mark.parametrize("K", [1, 3])
def test_solo12_logs_match_reference(runs, K):
    res_t, res_j = runs[0][K]
    assert res_t.converged.any()
    assert_logs_match(res_t, res_j)


@pytest.mark.parametrize("trace", DOC["traces"], ids=lambda t: t["robot"])
def test_logs_match_golden_trace(trace):
    tree = lt.robots.get(trace["robot"], "float64", device="cpu")
    b = torch.as_tensor(np.asarray(trace["b"])[None])
    bound = trace["bounds"] * torch.ones(tree.nv, dtype=torch.float64)
    problem = lt.make_problem(tree, (trace["constraint_link"],), b=b, lb=-bound, ub=bound)
    res = lt.solve(tree, lt.SolverParams(logging=True, **DOC["params"]),
                   torch.as_tensor(np.asarray(trace["q"])), problem)
    n = trace["iterations"]
    assert int(res.iterations[0]) == n
    np.testing.assert_allclose(res.log_rp[:n, 0].numpy(), trace["primal_residuals"],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res.log_rd[:n, 0].numpy(), trace["dual_residuals"],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res.log_mu[:n, 0].numpy(), trace["mus"], rtol=1e-12)
    assert np.isnan(res.log_rp[n:, 0].numpy()).all()
    np.testing.assert_allclose(res.nu[0].numpy(), trace["nu_final"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res.z[0].numpy(), trace["z_final"], rtol=1e-9, atol=1e-12)


def test_logged_state_carries_across(runs):
    """A logged loik_tpu state converts with its 12 logs (exactly), goes
    back to numpy with them, and warm-starts the port as the port's own
    state does."""
    (res_t, res_j), (tt, tp, q) = runs[0][1], runs[1]
    st = convert.state_from_arrays(res_j.state, device="cpu")
    back = convert.state_to_numpy(st)
    for name in LOG_FIELDS:
        np.testing.assert_array_equal(back[name], np.asarray(getattr(res_j.state, name)),
                                      err_msg=name)
    params = lt.SolverParams(**PARAMS, warm_start=True, logging=True)
    b = tp.b.clone()
    b[0, 2] = 0.12
    moved = tp.replace(b=b)
    got = lt.solve(tt, params, torch.as_tensor(q), moved, warm_state=st)
    want = lt.solve(tt, params, torch.as_tensor(q), moved, warm_state=res_t.state)
    np.testing.assert_array_equal(got.iterations.numpy(), want.iterations.numpy())
    np.testing.assert_allclose(got.nu.numpy(), want.nu.numpy(), rtol=0, atol=1e-10)
    assert (got.iterations < res_t.iterations).any()
    assert got.log_rp.shape == (PARAMS["max_iter"], B)
