"""The graphed multistart (`solve_multistart` with the default solve: the
sampler, the solve with its masked while loop, the scoring and the top k as
ONE graph) against loik_tpu's `_multistart_jit` in float64.  The two
packages' samplers cannot agree bit for bit, so both rank loik_tpu's own
seeds: the port's tree draws them in place of its sampler inside the graph.
Budget: tests/test_torch_multistart.py's for the default solve
(num_converged equal; on every finite slot the same seed, nu within 1e-10
and the task error within 1e-12).
"""

import jax
import numpy as np
import torch

import loik_tpu_torch as lt
from loik_tpu.parallel.multistart import solve_multistart as jmultistart
from loik_tpu.parallel.sharding import make_mesh
from loik_tpu.params import SolverParams as JParams
from loik_tpu_torch.utils import graphs

from tests.test_torch_graphs import fake_graphs  # noqa: F401  (a fixture)
from tests.test_torch_model import pair
from tests.test_torch_multistart import K, N_SEEDS, PARAMS, _finite, _seeds


def test_graphed_multistart_default_solve_matches_reference(fake_graphs,  # noqa: F811
                                                            monkeypatch):
    jt, tt, jp, tp = pair("panda_arm", "float64")
    key, qs = _seeds(jt, seed=2)
    seeds = torch.as_tensor(qs)
    # the sampler draws loik_tpu's seeds (a copy of a tensor: no host data)
    monkeypatch.setattr(type(tt), "random_configuration",
                        lambda self, shape, generator=None: seeds.clone())
    res_j = jmultistart(jt, JParams(**PARAMS), jp, key, N_SEEDS,
                        mesh=make_mesh(jax.devices()[:1]), k=K)
    gen = torch.Generator().manual_seed(0)
    n = len(graphs.CAPTURES)
    for _ in range(2):                    # the capture's warm-up, then a replay
        res_t = lt.parallel.solve_multistart(tt, lt.SolverParams(**PARAMS), tp, gen,
                                             N_SEEDS, k=K)
        assert int(res_t.num_converged) == int(res_j.num_converged) >= K
        fin = _finite(res_j)
        np.testing.assert_array_equal(np.isfinite(res_t.error.numpy()), fin)
        np.testing.assert_array_equal(res_t.q.numpy()[fin], np.asarray(res_j.q)[fin])
        np.testing.assert_allclose(res_t.nu.numpy()[fin], np.asarray(res_j.nu)[fin], rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(res_t.error.numpy()[fin], np.asarray(res_j.error)[fin],
                                   rtol=0, atol=1e-12)
    assert len(graphs.CAPTURES) == n + 1 and graphs.CAPTURES[-1].tag == "solve_multistart"
