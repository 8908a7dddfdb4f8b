"""Warm-started tracking in loik_tpu_torch against loik_tpu on the CPU:
`solve_stream`, and `DiffIkSolver.solve_tracking`, `track_scan`,
`solve_init` + `resolve`.

The same numpy-seeded q, problem and target sweep go through both packages
in float64: per-tick nu within 1e-10, flags and iteration counts equal, the
final warm state field by field (abs-or-rel 1e-10, the predicate of
tests/test_torch_lockstep.py).  On the CPU the port's fused path is the
eager loop, so `fused=True` streams are held to the eager stream's bits.

`refine="delta"` runs float32 stages, which land on other iteration counts
than loik_tpu's compiled program at the float32 floor (tests/
test_torch_fused.py); that stream is held bit for bit to the port's own
warm loop of `solve_delta_duals`, and to loik_tpu by outcome.  Measured
over seeds 0-2, T=3: the delta stream (B=4) has equal flags on every tick,
iteration counts differing on 0 to 25% of (tick, problem) pairs and
converged nu within 1.2e-5 (held to 2e-5); the plain float32 stream at tol
1e-5 (B=8) has equal flags, counts differing on 0 to 25% and converged nu
within 5.4e-5, five times the tolerance (held to 5e-4, the tolerance times
50 as in tests/test_torch_fused.py).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
import loik_tpu_torch.solver.solve  # noqa: F401  (the module; the package exports a function)
from loik_tpu.api import DiffIkSolver as JSolver
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver.stream import solve_stream as jsolve_stream
from loik_tpu_torch import StreamResult, solve_stream
from loik_tpu_torch.kernels import fused
from loik_tpu_torch.solver.refine import solve_delta_duals

from tests.test_torch_lockstep import _close
from tests.test_torch_model import pair, q_batch
from tests.test_torch_solve import assert_same

tsm = sys.modules["loik_tpu_torch.solver.solve"]

PARAMS = dict(max_iter=60, tol_abs=1e-5, tol_rel=1e-5, warm_start=True)
PER_TICK = ("nu", "converged", "iterations", "primal_residual", "dual_residual")


def setup(B=8, seed=0, dtype="float64", robot="ur5"):
    """(jax tree, port tree, jax problem, port problem, q): a 6-D
    end-effector constraint with v_z = 0.1, box +-2 (tests/test_stream.py)."""
    jt, tt, jp, tp = pair(robot, dtype, b3=0.1)
    lb, ub = -2 * np.ones(jt.nv), 2 * np.ones(jt.nv)
    jp = jp.replace(lb=jnp.asarray(lb, jp.lb.dtype), ub=jnp.asarray(ub, jp.ub.dtype))
    tp = tp.replace(lb=torch.as_tensor(lb, dtype=tp.lb.dtype),
                    ub=torch.as_tensor(ub, dtype=tp.ub.dtype))
    return jt, tt, jp, tp, q_batch(jt, B, seed, dtype)


def b_sweep(T, dtype="float64"):
    b_seq = np.zeros((T, 6))
    b_seq[:, 2] = 0.1 * np.cos(2 * np.pi * np.arange(T) / T)
    b_seq[:, 0] = 0.05 * np.sin(2 * np.pi * np.arange(T) / T)
    return b_seq.astype(dtype)


def streams_match(got, want, atol=1e-10):
    """A port StreamResult against a loik_tpu one: per tick, then the
    final state field by field."""
    assert isinstance(got, StreamResult)
    for name in ("converged", "iterations"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.nu.numpy(), np.asarray(want.nu), rtol=0, atol=atol)
    for name in ("primal_residual", "dual_residual"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-8, atol=1e-10, err_msg=name)
    for name in fused._STATE_FIELDS + ("liMi_R", "liMi_p"):
        _close(f"final state {name}", getattr(got.state, name), getattr(want.state, name))


def states_equal(a, b):
    for name in fused._STATE_FIELDS + ("liMi_R", "liMi_p"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("warm", [True, False])
def test_solve_stream_f64_matches_reference(warm):
    jt, tt, jp, tp, q = setup()
    params = dict(PARAMS, warm_start=warm)
    b_seq = b_sweep(6)
    want = jsolve_stream(jt, JParams(**params), jnp.asarray(q), jp, 0, b_seq)
    got = solve_stream(tt, lt.SolverParams(**params), torch.as_tensor(q), tp, 0, b_seq,
                       fused=False)
    assert got.nu.shape == (6, 8, tt.nv) and got.converged.shape == (6, 8)
    assert got.converged.any()
    streams_match(got, want)
    if warm:  # warm ticks are shorter than the cold first one
        assert got.iterations[1:].double().mean() < got.iterations[0].double().mean()


def test_solve_stream_per_tick_q_and_A_match_reference():
    """(T, B, nq) configuration streams and per-tick A updates both apply,
    and a stream continues from the warm state of the one before."""
    jt, tt, jp, tp, _ = setup(B=4)
    T = 4
    b_seq = b_sweep(T)
    q_seq = np.stack([q_batch(jt, 4, seed=10 + t) for t in range(T)])
    A_seq = np.tile(np.eye(6), (T, 1, 1))
    A_seq[:, 0, 0] = np.linspace(1.0, 0.5, T)   # de-weight v_x over the horizon
    jparams, tparams = JParams(**PARAMS), lt.SolverParams(**PARAMS)
    want = jsolve_stream(jt, jparams, jnp.asarray(q_seq), jp, 0, b_seq, A_seq=A_seq)
    got = solve_stream(tt, tparams, torch.as_tensor(q_seq), tp, 0, b_seq, A_seq=A_seq,
                       fused=False)
    streams_match(got, want)
    # tick by tick through `solve`, in the port alone
    st = None
    for t in range(T):
        res = lt.solve(tt, tparams, torch.as_tensor(q_seq[t]),
                       tp.update_constraint(0, A=A_seq[t], b=b_seq[t]), st)
        st = res.state
        assert torch.equal(got.nu[t], res.nu) and torch.equal(got.iterations[t], res.iterations)
    want2 = jsolve_stream(jt, jparams, jnp.asarray(q_seq), jp, 0, b_seq[::-1].copy(),
                          warm_state=want.state)
    got2 = solve_stream(tt, tparams, torch.as_tensor(q_seq), tp, 0, b_seq[::-1].copy(),
                        warm_state=got.state, fused=False)
    streams_match(got2, want2)


def test_solve_stream_takes_device_resident_targets():
    """Targets given as tensors are used as they are (moved once, indexed
    per tick); per-problem (T, B, 6) targets apply row by row."""
    _, tt, _, tp, q = setup(B=4)
    params = lt.SolverParams(**PARAMS)
    b_seq = b_sweep(3)
    a = solve_stream(tt, params, torch.as_tensor(q), tp, 0, b_seq, fused=False)
    b = solve_stream(tt, params, torch.as_tensor(q), tp, 0, torch.as_tensor(b_seq), fused=False)
    assert torch.equal(a.nu, b.nu)
    per_problem = torch.as_tensor(b_seq)[:, None, :].expand(3, 4, 6)
    tpB = tp.replace(b=tp.b[None].expand(4, 1, 6).clone())
    c = solve_stream(tt, params, torch.as_tensor(q), tpB, 0, per_problem, fused=False)
    assert torch.equal(a.nu, c.nu) and torch.equal(a.iterations, c.iterations)


@pytest.mark.parametrize("check_interval", [1, 4])
def test_fused_stream_on_cpu_is_the_eager_stream(check_interval):
    """float32, fused=True: on CPU tensors every tick is the eager loop, the
    plain version of the kernel tick; no launch is counted.  Also what a
    tick's input loop counter must be: reset to 0, as the eager path's."""
    _, tt, _, tp, q = setup(dtype="float32")
    params = lt.SolverParams(**dict(PARAMS, tol_abs=1e-4, tol_rel=1e-4,
                                    check_interval=check_interval))
    b_seq = b_sweep(4, "float32")
    n0 = fused.LAUNCHES
    fus = solve_stream(tt, params, torch.as_tensor(q), tp, 0, b_seq, fused="require")
    eag = solve_stream(tt, params, torch.as_tensor(q), tp, 0, b_seq, fused=False)
    assert fused.LAUNCHES == n0
    for name in PER_TICK:
        assert torch.equal(getattr(fus, name), getattr(eag, name)), name
    states_equal(fus.state, eag.state)
    assert int(fus.state.it) == int(fus.iterations[-1].max())


def test_stream_f32_matches_reference_stream():
    """The float32 stream against loik_tpu's compiled float32 stream, by
    outcome (the module docstring has the measured differences)."""
    jt, tt, jp, tp, q = setup(dtype="float32")
    b_seq = b_sweep(3, "float32")
    want = jsolve_stream(jt, JParams(**PARAMS), jnp.asarray(q), jp, 0, b_seq, fused=False)
    got = solve_stream(tt, lt.SolverParams(**PARAMS), torch.as_tensor(q), tp, 0, b_seq)
    assert int((got.converged.numpy() != np.asarray(want.converged)).sum()) <= 1
    both = got.converged.numpy() & np.asarray(want.converged)
    assert both.mean() >= 0.5
    np.testing.assert_allclose(got.nu.numpy()[both], np.asarray(want.nu)[both],
                               rtol=0, atol=5e-4)


def test_delta_stream_is_the_warm_loop_of_delta_solves():
    """refine='delta' streams the tol-1e-6 path: each tick is
    `solve_delta_duals` warm-started from the previous tick's full-space
    float32 state, whatever q's dtype."""
    jt, tt, jp, tp, q = setup(B=4)
    params = dict(PARAMS, tol_abs=1e-6, tol_rel=1e-6)
    tparams = lt.SolverParams(**params)
    b_seq = b_sweep(3)
    got = solve_stream(tt, tparams, torch.as_tensor(q), tp, 0, b_seq, refine="delta")
    assert got.nu.dtype == torch.float32 and got.state.vis.dtype == torch.float32
    st = None
    for t in range(3):
        res = solve_delta_duals(tt, tparams, torch.as_tensor(q),
                                tp.update_constraint(0, b=b_seq[t]), warm_state=st)
        st = res.state
        for name in PER_TICK:
            assert torch.equal(getattr(got, name)[t], getattr(res, name)), (t, name)
    states_equal(got.state, st)
    # a float64 warm state is cast once, so the carried state keeps one dtype
    cold64 = lt.solve(tt, tparams, torch.as_tensor(q), tp).state
    again = solve_stream(tt, tparams, torch.as_tensor(q), tp, 0, b_seq, refine="delta",
                         warm_state=cold64)
    assert again.state.vis.dtype == torch.float32 and again.converged.any()
    # against loik_tpu's stream, by outcome
    want = jsolve_stream(jt, JParams(**params), jnp.asarray(q), jp, 0, b_seq, refine="delta")
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    both = got.converged.numpy()
    assert both.any()
    np.testing.assert_allclose(got.nu.numpy()[both], np.asarray(want.nu)[both],
                               rtol=0, atol=2e-5)


def test_solve_stream_refusals():
    _, tt, _, tp, q = setup(B=2)
    params, b_seq = lt.SolverParams(**PARAMS), b_sweep(2)
    tq = torch.as_tensor(q)
    with pytest.raises(ValueError, match="does not support per-iteration logging"):
        solve_stream(tt, params.replace(logging=True), tq, tp, 0, b_seq)
    with pytest.raises(ValueError, match="refine must be None or 'delta'; got 'two-stage'"):
        solve_stream(tt, params, tq, tp, 0, b_seq, refine="two-stage")
    with pytest.raises(ValueError, match=r"q must be \(B, nq\) or \(T, B, nq\)"):
        solve_stream(tt, params, tq[0], tp, 0, b_seq)
    with pytest.raises(ValueError, match="solve_stream: fused='require'.*float32"):
        solve_stream(tt, params, tq, tp, 0, b_seq, fused="require")


def test_solve_tracking_and_track_scan_match_reference():
    """T calls of solve_tracking in both packages, then the same horizon
    through track_scan: equal to the tick loop, and the solver carries the
    last target and the warm state on."""
    jt, tt, jp, tp, q = setup()
    T, ee = 6, jt.njoints - 1
    b_seq = b_sweep(T)
    jq, tq = jnp.asarray(q), torch.as_tensor(q)
    jloop = JSolver(jt, JParams(**PARAMS), (ee,), problem=jp)
    tloop = lt.DiffIkSolver(tt, lt.SolverParams(**PARAMS), (ee,), problem=tp, fused=False)
    ticks = []
    for t in range(T):
        rj = jloop.solve_tracking(jq, ee, b=b_seq[t])
        rt = tloop.solve_tracking(tq, ee, b=b_seq[t])
        assert_same(rt, rj)
        assert tloop.last_result is rt and tloop.state is rt.state
        ticks.append(rt)
    jscan = JSolver(jt, JParams(**PARAMS), (ee,), problem=jp)
    tscan = lt.DiffIkSolver(tt, lt.SolverParams(**PARAMS), (ee,), problem=tp, fused=False)
    want = jscan.track_scan(jq, b_seq)
    got = tscan.track_scan(tq, b_seq)
    streams_match(got, want)
    for name in PER_TICK:
        assert torch.equal(getattr(got, name), torch.stack([getattr(r, name) for r in ticks]))
    states_equal(got.state, tloop.state)
    assert tscan.state is got.state
    np.testing.assert_array_equal(tscan.problem.b[0].numpy(), b_seq[-1])
    # further per-tick calls continue seamlessly, in both packages
    assert_same(tscan.solve_tracking(tq, ee, b=b_seq[0]),
                jscan.solve_tracking(jq, ee, b=b_seq[0]))


def test_solve_tracking_updates_A_and_takes_one_configuration():
    jt, tt, jp, tp, q = setup(B=1)
    ee = jt.njoints - 1
    A = np.eye(6)
    A[0, 0] = 0.5
    b = np.array([0.02, 0.0, 0.1, 0.0, 0.0, 0.0])
    rj = JSolver(jt, JParams(**PARAMS), (ee,), problem=jp).solve_tracking(
        jnp.asarray(q[0]), ee, A=A, b=b)
    solver = lt.DiffIkSolver(tt, lt.SolverParams(**PARAMS), (ee,), problem=tp, fused=False)
    rt = solver.solve_tracking(torch.as_tensor(q[0]), ee, A=A, b=b)
    assert rt.nu.shape == (1, tt.nv)
    assert_same(rt, rj)
    assert float(solver.problem.A[0, 0, 0]) == 0.5


def test_track_scan_with_A_seq_and_delta_refinement():
    jt, tt, jp, tp, q = setup(B=4)
    T, ee = 3, jt.njoints - 1
    b_seq = b_sweep(T)
    A_seq = np.tile(np.eye(6), (T, 1, 1))
    A_seq[:, 1, 1] = np.linspace(1.0, 0.7, T)
    want = JSolver(jt, JParams(**PARAMS), (ee,), problem=jp).track_scan(
        jnp.asarray(q), b_seq, A_seq=A_seq)
    solver = lt.DiffIkSolver(tt, lt.SolverParams(**PARAMS), (ee,), problem=tp, fused=False)
    got = solver.track_scan(torch.as_tensor(q), b_seq, link=ee, A_seq=A_seq)
    streams_match(got, want)
    np.testing.assert_array_equal(solver.problem.A[0].numpy(), A_seq[-1])
    # refine="delta" through the solver equals the functional stream
    params = lt.SolverParams(**dict(PARAMS, tol_abs=1e-6, tol_rel=1e-6))
    a = lt.DiffIkSolver(tt, params, (ee,), problem=tp).track_scan(
        torch.as_tensor(q), b_seq, refine="delta")
    b = solve_stream(tt, params, torch.as_tensor(q), tp, 0, b_seq, refine="delta")
    assert torch.equal(a.nu, b.nu) and torch.equal(a.iterations, b.iterations)


def test_fused_tracking_on_cpu_equals_eager_tracking():
    """float32 ticks under fused=True / 'require' / None (all eligible): on
    the CPU each is the eager tick, and track_scan equals T solve_tracking
    calls bit for bit."""
    _, tt, _, tp, q = setup(dtype="float32")
    ee = tt.njoints - 1
    params = lt.SolverParams(**dict(PARAMS, tol_abs=1e-4, tol_rel=1e-4))
    b_seq = b_sweep(4, "float32")
    tq = torch.as_tensor(q)
    eager = lt.DiffIkSolver(tt, params, (ee,), problem=tp, fused=False)
    want = [eager.solve_tracking(tq, ee, b=b_seq[t]) for t in range(4)]
    n0 = fused.LAUNCHES
    for policy in (True, "require", None):
        solver = lt.DiffIkSolver(tt, params, (ee,), problem=tp, fused=policy)
        got = solver.track_scan(tq, b_seq)
        for name in PER_TICK:
            assert torch.equal(getattr(got, name),
                               torch.stack([getattr(r, name) for r in want])), (policy, name)
        states_equal(got.state, eager.state)
        ticker = lt.DiffIkSolver(tt, params, (ee,), problem=tp, fused=policy)
        for t in range(4):
            assert torch.equal(ticker.solve_tracking(tq, ee, b=b_seq[t]).nu, want[t].nu)
    assert fused.LAUNCHES == n0


def test_solve_init_and_resolve_match_reference():
    """FK frozen once, the loop re-run: equal to `solve` at the same q, warm
    re-solves thread the state, in both packages."""
    jt, tt, jp, tp, q = setup()
    ee = jt.njoints - 1
    jq, tq = jnp.asarray(q), torch.as_tensor(q)
    jcold, tcold = JParams(**dict(PARAMS, warm_start=False)), lt.SolverParams(
        **dict(PARAMS, warm_start=False))
    js, ts = JSolver(jt, jcold, (ee,), problem=jp), lt.DiffIkSolver(tt, tcold, (ee,), problem=tp)
    js.solve_init(jq)
    ts.solve_init(tq)
    r1 = ts.resolve()
    assert_same(r1, js.resolve())
    direct = lt.solve(tt, tcold, tq, tp)
    for name in ("nu", "z", "vis", "converged", "iterations", "primal_residual"):
        assert torch.equal(getattr(r1, name), getattr(direct, name)), name
    assert torch.equal(ts.resolve().nu, r1.nu)         # cold: the same solve again
    # warm: the second resolve starts from the first one's duals
    jw = JSolver(jt, JParams(**PARAMS), (ee,), problem=jp)
    tw = lt.DiffIkSolver(tt, lt.SolverParams(**PARAMS), (ee,), problem=tp)
    jw.solve_init(jq)
    tw.solve_init(tq, problem=tp.update_constraint(0, b=b_sweep(4)[1]))
    jw.problem = jp.update_constraint(0, b=b_sweep(4)[1])
    first, second = tw.resolve(), tw.resolve()
    jw.resolve()
    assert_same(second, jw.resolve())
    conv = first.converged
    assert second.iterations[conv].double().mean() < first.iterations[conv].double().mean()
    assert tw.state is second.state
    # a single configuration is batched, as in `solve`
    one = lt.DiffIkSolver(tt, tcold, (ee,), problem=tp)
    one.solve_init(tq[0])
    assert one.resolve().nu.shape == (1, tt.nv)


def test_solve_from_fk_refuses_q_dependent_subspaces_without_q():
    tree = lt.robots.mobile_ur5(device="cpu")
    problem = lt.make_problem(tree, (tree.njoints - 1,))
    R, p = tsm.fwd_pass_init(tree, tree.neutral()[None])
    with pytest.raises(ValueError, match="cannot reconstruct S from liMi"):
        tsm.solve_from_fk(tree, lt.SolverParams(), R, p, problem)


def test_api_refusals():
    _, tt, _, tp, q = setup(B=2)
    ee = tt.njoints - 1
    params = lt.SolverParams(**PARAMS)
    solver = lt.DiffIkSolver(tt, params, (ee,), problem=tp, fused=False)
    with pytest.raises(RuntimeError, match="call solve_init first"):
        solver.resolve()
    with pytest.raises(ValueError, match="no constraint at link 0"):
        solver.solve_tracking(torch.as_tensor(q), 0, b=np.zeros(6))
    with pytest.raises(ValueError, match="no constraint at link 0"):
        solver.track_scan(torch.as_tensor(q), b_sweep(2), link=0)
    with pytest.raises(ValueError, match="fused must be None, True, False, or 'require'"):
        lt.DiffIkSolver(tt, params, (ee,), fused="yes")
    two = lt.DiffIkSolver(tt, params, (2, ee), fused=False)
    with pytest.raises(ValueError, match="multiple constraints; pass link= explicitly"):
        two.track_scan(torch.as_tensor(q), b_sweep(2))
    with pytest.raises(ValueError, match="solve_tracking: fused='require'.*float32"):
        lt.DiffIkSolver(tt, params, (ee,), problem=tp, fused="require").solve_tracking(
            torch.as_tensor(q), ee, b=np.zeros(6))
    with pytest.raises(ValueError, match="logging"):
        lt.DiffIkSolver(tt, params.replace(logging=True), (ee,), problem=tp,
                        fused=False).track_scan(torch.as_tensor(q), b_sweep(2))
    with pytest.raises(ValueError, match="multiple constraints; pass link= explicitly"):
        two.reach(torch.as_tensor(q), torch.eye(3, dtype=torch.float64),
                  torch.zeros(3, dtype=torch.float64))
