"""The graph paths of the tick loops against loik_tpu on the CPU: the
tracking stream (`solve_stream`, `track_scan`), the tracking tick
(`solve_tracking`) and the closed loop (`solve_clik`), each through the
graph path of `utils.graphs` (the stand-in capture of
tests/test_torch_graphs.py: static buffers, the carry in them, the tick
counter) against loik_tpu's compiled `_stream_jit`, `_tracking_jit` and
`_clik_jit`, in float64, under the budgets of tests/test_torch_stream.py
(per-tick nu within 1e-10, flags and iteration counts equal, the final
state at abs-or-rel 1e-10) and tests/test_torch_clik.py (q, nu and the
error history within 1e-9, pos_err / rot_err within 1e-10, flags and
counts equal).  On the CPU the kernel path of a tick is the eager loop.
"""

import jax.numpy as jnp
import numpy as np
import torch

import loik_tpu_torch as lt
from loik_tpu.api import DiffIkSolver as JSolver
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver.clik import solve_clik as jclik
from loik_tpu.solver.stream import solve_stream as jsolve_stream
from loik_tpu_torch.utils import graphs

from tests.test_torch_clik import PARAMS as CLIK_PARAMS
from tests.test_torch_clik import RUN, _setup
from tests.test_torch_clik import assert_same as clik_same
from tests.test_torch_graphs import fake_graphs  # noqa: F401  (a fixture)
from tests.test_torch_model import q_batch
from tests.test_torch_solve import assert_same
from tests.test_torch_stream import PARAMS, b_sweep, setup, streams_match


def test_graphed_stream_per_tick_q_and_A_matches_reference(fake_graphs):  # noqa: F811
    """A stream with a per-tick q and per-tick A, then a second stream
    warm-started from the first's state: each replays its captured tick."""
    jt, tt, jp, tp, _ = setup(B=4)
    T = 4
    b_seq = b_sweep(T)
    q_seq = np.stack([q_batch(jt, 4, seed=10 + t) for t in range(T)])
    A_seq = np.tile(np.eye(6), (T, 1, 1))
    A_seq[:, 0, 0] = np.linspace(1.0, 0.5, T)
    jparams, tparams = JParams(**PARAMS), lt.SolverParams(**PARAMS)
    n = len(graphs.CAPTURES)
    want = jsolve_stream(jt, jparams, jnp.asarray(q_seq), jp, 0, b_seq, A_seq=A_seq)
    got = lt.solve_stream(tt, tparams, torch.as_tensor(q_seq), tp, 0, b_seq, A_seq=A_seq,
                          fused=True)
    streams_match(got, want)
    want2 = jsolve_stream(jt, jparams, jnp.asarray(q_seq), jp, 0, b_seq[::-1].copy(),
                          A_seq=A_seq, warm_state=want.state)
    got2 = lt.solve_stream(tt, tparams, torch.as_tensor(q_seq), tp, 0, b_seq[::-1].copy(),
                           A_seq=A_seq, warm_state=got.state, fused=True)
    streams_match(got2, want2)
    assert len(graphs.CAPTURES) == n + 1     # the second stream replays the first's graph


def test_graphed_tracking_ticks_and_track_scan_match_reference(fake_graphs):  # noqa: F811
    """T graphed `solve_tracking` ticks (the first cold, the rest warm: two
    graphs), then the same horizon through a graphed `track_scan`."""
    jt, tt, jp, tp, q = setup()
    T, ee = 5, jt.njoints - 1
    b_seq = b_sweep(T)
    jq, tq = jnp.asarray(q), torch.as_tensor(q)
    jloop = JSolver(jt, JParams(**PARAMS), (ee,), problem=jp)
    tloop = lt.DiffIkSolver(tt, lt.SolverParams(**PARAMS), (ee,), problem=tp, fused=True)
    n = len(graphs.CAPTURES)
    for t in range(T):
        assert_same(tloop.solve_tracking(tq, ee, b=b_seq[t]),
                    jloop.solve_tracking(jq, ee, b=b_seq[t]))
    assert len(graphs.CAPTURES) == n + 2
    jscan = JSolver(jt, JParams(**PARAMS), (ee,), problem=jp)
    tscan = lt.DiffIkSolver(tt, lt.SolverParams(**PARAMS), (ee,), problem=tp, fused=True)
    streams_match(tscan.track_scan(tq, b_seq), jscan.track_scan(jq, b_seq))
    np.testing.assert_array_equal(tscan.problem.b[0].numpy(), b_seq[-1])


def test_graphed_clik_matches_reference(fake_graphs):  # noqa: F811
    """The closed loop with its tick captured and replayed, against
    loik_tpu's `_clik_jit`; then a second run on other targets replays."""
    jt, tt, q0, tR, tp, ee = _setup()
    n = len(graphs.CAPTURES)
    for target_p in (tp, tp + 0.02):
        want = jclik(jt, JParams(**CLIK_PARAMS), jnp.asarray(q0), tR, target_p, link=ee, **RUN)
        got = lt.solve_clik(tt, lt.SolverParams(**CLIK_PARAMS), torch.as_tensor(q0),
                            torch.as_tensor(tR), torch.as_tensor(target_p), ee, fused=True,
                            **RUN)
        clik_same(got, want)
    assert len(graphs.CAPTURES) == n + 1
