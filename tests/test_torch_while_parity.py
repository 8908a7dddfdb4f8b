"""The graphed plain solve against loik_tpu's `_solve_jit` in float64, on
the two kinds of tree that only the masked while loop solves: `mobile_ur5`
(a universal joint: configuration-dependent motion subspaces, so the kernel
refuses it) and the mixed super-batch's padded chain solved as one batch.
The port's call goes through the graph path of `utils.graphs` (the stand-in
capture of tests/test_torch_graphs.py: the loop a WHILE node's stand-in,
static buffers, a replay), and a second call with other inputs replays the
same graph.  Budget: tests/test_torch_solve.py's (flags and iteration
counts equal, nu, z and vis within 1e-10, residuals within 1e-8 relative).
"""

import jax.numpy as jnp
import numpy as np
import torch

import loik_tpu_torch as lt
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver import solve as jsolve
from loik_tpu_torch.utils import graphs

from tests.test_torch_graphs import fake_graphs  # noqa: F401  (a fixture)
from tests.test_torch_mixed import PARAMS as MIXED_PARAMS
from tests.test_torch_mixed import prepared_pair
from tests.test_torch_model import FLAGSHIP, pair, q_batch
from tests.test_torch_solve import assert_same


def test_graphed_solve_mobile_ur5_matches_reference(fake_graphs):  # noqa: F811
    jt, tt, jp, tp = pair("mobile_ur5", "float64")
    assert tt.has_q_dependent_S
    params = dict(FLAGSHIP, check_interval=4)
    n = len(graphs.CAPTURES)
    for seed in (1, 2):
        q = q_batch(jt, 16, seed=seed)
        res_j = jsolve(jt, JParams(**params), jnp.asarray(q), jp)
        res_t = lt.solve(tt, lt.SolverParams(**params), torch.as_tensor(q), tp)
        assert res_t.converged.any()
        assert_same(res_t, res_j)
    assert len(graphs.CAPTURES) == n + 1 and graphs.CAPTURES[-1].loops


def test_graphed_solve_mixed_chain_matches_reference(fake_graphs):  # noqa: F811
    jg, tg, jmp, tmp = prepared_pair((5, 3), seed=1)
    params = MIXED_PARAMS
    n = len(graphs.CAPTURES)
    for flip in (False, True):
        qs = [np.array(q)[::-1].copy() if flip else np.array(q) for _, q, _ in jg]
        res_j = jsolve(jmp.chain, JParams(**params), jmp.pack_q(qs), jmp.problem)
        res_t = lt.solve(tmp.chain, lt.SolverParams(**params),
                         tmp.pack_q([torch.as_tensor(q) for q in qs]), tmp.problem)
        assert res_t.converged.any()
        assert_same(res_t, res_j)
    assert len(graphs.CAPTURES) == n + 1 and graphs.CAPTURES[-1].loops
