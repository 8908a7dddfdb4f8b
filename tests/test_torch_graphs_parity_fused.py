"""`solve_fused` (the counterpart of loik_tpu's `_run_fused`) through the
graph path of `utils.graphs` (the stand-in capture of
tests/test_torch_graphs.py) against loik_tpu's `solve_fused` in interpret
mode on the CPU, in float32, under the budget of tests/test_torch_fused.py:
flags differing on at most max(1, B/100) problems, nu within 50 tol where
both converged, iteration counts equal on 90% (the float32 solve is
chaotic at the ulp level, and XLA contracts multiply-adds into FMAs).

The graph path of `solve_delta_duals` equals its eager path bit for bit
(tests/test_torch_graphs.py), which tests/test_torch_refine.py holds to
loik_tpu's compiled `_delta_duals_jit`; compiling that program once more
here would take this file past a minute.
"""

import jax.numpy as jnp
import torch

import loik_tpu_torch as lt
from loik_tpu.kernels import solve_fused as jsolve_fused
from loik_tpu.params import SolverParams as JParams
from loik_tpu_torch.kernels import fused
from loik_tpu_torch.utils import graphs

from tests.test_torch_fused import _budget
from tests.test_torch_graphs import fake_graphs  # noqa: F401  (a fixture)
from tests.test_torch_model import pair, q_batch


def test_graphed_solve_fused_matches_reference_f32(fake_graphs):  # noqa: F811
    jt, tt, jp, tp = pair("panda_arm", "float32")
    B = 32
    q = q_batch(jt, B, seed=0, dtype="float32")
    params = dict(max_iter=60, tol_abs=1e-4, tol_rel=1e-4, check_interval=1)
    res_j = jsolve_fused(jt, JParams(**params), jnp.asarray(q), jp, batch_tile=16,
                         interpret=True)
    n = len(graphs.CAPTURES)
    fused.solve_fused(tt, lt.SolverParams(**params), torch.as_tensor(q), tp)  # captures
    res_t = fused.solve_fused(tt, lt.SolverParams(**params), torch.as_tensor(q), tp)
    assert len(graphs.CAPTURES) == n + 1
    _budget(res_t, res_j, B, nu_atol=50 * 1e-4, it_frac=0.9)
