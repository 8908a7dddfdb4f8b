"""The graphed two-stage solve and the graphed scan over mixed super-batches
against loik_tpu in float64, each through the graph path of `utils.graphs`
(the stand-in capture of tests/test_torch_graphs.py):

- `solve_two_stage` on `mobile_ur5`, both stages the masked while loop (the
  kernel refuses a universal joint), against loik_tpu's `_two_stage_jit`,
  under the budget of tests/test_torch_two_stage_mobile.py (the
  compiled-reference outcome budget and the float64 certificate);
- `MixedPadded.solve_scan` over R = 3 staged super-batches, one captured
  solve replayed per rep (`graphs.scan`), against loik_tpu's
  `_packed_scan_jit` rep by rep, under tests/test_torch_solve.py's budget
  (flags and counts equal, nu within 1e-10, residuals within 1e-8
  relative).
"""

import jax.numpy as jnp
import numpy as np
import torch

import loik_tpu_torch as lt
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver.refine import solve_two_stage as jtwo_stage
from loik_tpu_torch.utils import graphs

from tests.test_torch_graphs import fake_graphs  # noqa: F401  (a fixture)
from tests.test_torch_mixed import PARAMS as MIXED_PARAMS
from tests.test_torch_mixed import prepared_pair
from tests.test_torch_model import pair, q_batch
from tests.test_torch_refine import certified
from tests.test_torch_two_stage import PARAMS, outcome_budget


def test_graphed_two_stage_mobile_ur5_matches_reference(fake_graphs):  # noqa: F811
    jt, tt, jp, tp = pair("mobile_ur5", "float64")
    B = 24
    n = len(graphs.CAPTURES)
    for seed in (1, 2):
        q = q_batch(jt, B, seed=seed)
        res_j = jtwo_stage(jt, JParams(**PARAMS), jnp.asarray(q), jp)
        res_t = lt.solve_two_stage(tt, lt.SolverParams(**PARAMS), torch.as_tensor(q), tp)
        outcome_budget(res_t, res_j, B)
        task, box = certified(res_t, q, "mobile_ur5", jp)
        assert task <= 1e-5 and box <= 1e-5
    assert len(graphs.CAPTURES) == n + 1
    assert len(graphs.CAPTURES[-1].loops) == 2 and graphs.CAPTURES[-1].launches.get("fused_admm", 0) == 0


def test_graphed_solve_scan_matches_reference(fake_graphs):  # noqa: F811
    jg, tg, jmp, tmp = prepared_pair((4, 4), seed=3)
    rng = np.random.default_rng(7)
    R = 3
    stacked = [rng.uniform(-np.pi, np.pi, (R, 4, t.nq)) for t, _, _ in tg]
    want = jmp.solve_scan(JParams(**MIXED_PARAMS), stacked)
    got = tmp.solve_scan(lt.SolverParams(**MIXED_PARAMS), stacked)
    assert graphs.CAPTURES[-1].tag == "solve_scan" and graphs.CAPTURES[-1].loops
    nu, conv, iters, rp, rd = got
    assert nu.shape == (R, 8, 7) and bool(conv.any())
    for g, w in zip((conv, iters), want[1:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(nu.numpy(), np.asarray(want[0]), rtol=0, atol=1e-10)
    for g, w in zip((rp, rd), want[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8, atol=1e-10)
    n = len(graphs.CAPTURES)
    again = tmp.solve_scan(lt.SolverParams(**MIXED_PARAMS), [s[::-1].copy() for s in stacked])
    assert len(graphs.CAPTURES) == n
    assert torch.equal(again[0][0], nu[-1])
