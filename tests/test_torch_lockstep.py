"""Pass-by-pass lockstep of the port's eager ADMM iteration against
loik_tpu's, in float64: both run `_iteration(debug=True)` on their own
state, every pass-level intermediate (FwdPass1 H/p/r, the accumulated
Riccati H/p, D^-1, r_tot, the dual-update deltas, the residual components,
the adaptive tolerances and the certificate pieces) is compared with the
abs-or-rel predicate of tests/test_lockstep.py at 1e-10, then both advance
one `make_loop_body` call and every state field is compared the same way.
The robots: the arms (1-dof joints), solo12 (a 6-dof base, five constraints
on one tree, its stance task) and mobile_ur5 (planar base, universal head:
per-problem subspaces from q).
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu.solver.solve  # noqa: F401  (the module; the package exports a function)
import loik_tpu_torch.solver.solve  # noqa: F401
from loik_tpu.params import SolverParams as JParams
from loik_tpu.solver.state import init_state as jinit_state
from loik_tpu_torch import SolverParams, convert
from loik_tpu_torch.kernels.fused import _STATE_FIELDS
from loik_tpu_torch.solver.state import init_state

from tests.test_torch_model import pair, q_batch

jsm = sys.modules["loik_tpu.solver.solve"]
tsm = sys.modules["loik_tpu_torch.solver.solve"]

PARAMS = dict(max_iter=40, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
              mu_equality_scale_factor=1e5)


def _close(name, got, want, atol=1e-10):
    """abs-OR-rel, as tests/test_lockstep.py:49-57."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    got, want = got.astype(np.float64), want.astype(np.float64)
    with np.errstate(invalid="ignore"):  # equal infinities (unrun residuals)
        err = np.where(got == want, 0.0, np.abs(got - want))
    rel = err / np.maximum(np.abs(want), 1.0)
    assert np.all(np.minimum(err, rel) <= atol), f"{name}: max err {err.max():.3e}"


def _jax_S_list(jt, q):
    """Per-problem subspaces as loik_tpu's `_solve_impl` builds them."""
    out = []
    for i in range(jt.njoints):
        Si = jt.joint_S(i, q)
        out.append(jnp.broadcast_to(Si[:, :, None], Si.shape + (q.shape[0],))
                   if Si.ndim == 2 else jnp.moveaxis(Si, 0, -1))
    return tuple(out)


def _start(robot, params, B=8, seed=0):
    jt, tt, jp, tp = pair(robot)
    q = q_batch(jt, B, seed)
    nc = jp.num_constraints
    jprob = jsm.prepare_problem(jt, jp, B, jnp.float64)
    tprob = tsm.prepare_problem(tt, tp, B, torch.float64)
    if jt.has_q_dependent_S:
        jprob = dataclasses.replace(jprob, S_list=_jax_S_list(jt, jnp.asarray(q)))
        tprob = dataclasses.replace(
            tprob, S_list=tsm.q_dependent_S_list(tt, torch.as_tensor(q), torch.float64))
    js = jsm._reset_state(jt, JParams(**params), jinit_state(jt, B, nc, jnp.float64),
                          jnp.float64)
    R, p = jsm.fwd_pass_init(jt, jnp.asarray(q))
    js = dataclasses.replace(js, liMi_R=R, liMi_p=p)
    ts = tsm._reset_state(tt, SolverParams(**params),
                          init_state(tt, B, nc, torch.float64, "cpu"), torch.float64)
    R, p = tsm.fwd_pass_init(tt, torch.as_tensor(q))
    ts = dataclasses.replace(ts, liMi_R=R, liMi_p=p)
    return (jt, jprob, js), (tt, tprob, ts)


def _compare_states(tag, ts, js):
    for name in _STATE_FIELDS + ("liMi_R", "liMi_p"):
        _close(f"{tag} {name}", getattr(ts, name), getattr(js, name))


@pytest.mark.parametrize("robot,B,min_iters", [
    ("panda_arm", 8, 5), ("panda", 8, 5), ("solo12", 4, 3), ("mobile_ur5", 4, 3)])
def test_iteration_lockstep_f64(robot, B, min_iters):
    jparams, tparams = JParams(**PARAMS), SolverParams(**PARAMS)
    (jt, jprob, js), (tt, tprob, ts) = _start(robot, PARAMS, B=B)
    for name in ("H_ref", "Hv", "A", "b", "AtA", "Atb", "lb", "ub", "b_inf", "Hv_inf"):
        _close(f"prepare {name}", getattr(tprob, name), getattr(jprob, name))
    _compare_states("init", ts, js)
    jbody = jsm.make_loop_body(jt, jprob, jparams)
    tbody = tsm.make_loop_body(tt, tprob, tparams)
    compared = 0
    for it in range(2 * min_iters):
        if not bool(ts.running.any()):
            break
        jnew, jchk = jsm._iteration(jt, jprob, jparams, js, debug=True)
        tnew, tchk = tsm._iteration(tt, tprob, tparams, ts, debug=True)
        assert tchk["debug"].keys() == jchk["debug"].keys()
        for key, want in jchk["debug"].items():
            got = tchk["debug"][key]
            if isinstance(want, list):
                assert len(got) == len(want)
                for i, (g, w) in enumerate(zip(got, want)):
                    _close(f"iter {it} {key}[{i}]", g, w)
            else:
                _close(f"iter {it} {key}", got, want)
        for key in ("tol_primal", "tol_dual", "primal_infeasible_now"):
            _close(f"iter {it} {key}", tchk[key], jchk[key])
        for key, want in jnew.items():
            _close(f"iter {it} new {key}", tnew[key], want)
        js, ts = jbody(js), tbody(ts)
        _compare_states(f"after iter {it}", ts, js)
        assert not bool(ts.dual_infeasible.any())
        compared += 1
    assert compared >= min_iters


@pytest.mark.parametrize("robot,K", [("panda_arm", 8), ("panda", 8), ("solo12", 4),
                                     ("mobile_ur5", 4)])
def test_loop_body_check_interval(robot, K):
    """One body call at check_interval K: the K-1 check-free micro-iterations
    on the hoisted H half, the checked one, and the single masked merge."""
    params = dict(PARAMS, check_interval=K)
    (jt, jprob, js), (tt, tprob, ts) = _start(robot, params, B=4, seed=4)
    js = jsm.make_loop_body(jt, jprob, JParams(**params))(js)
    ts = tsm.make_loop_body(tt, tprob, SolverParams(**params))(ts)
    _compare_states(f"K={K} body", ts, js)
    assert int(ts.it) == K


def test_iteration_without_checks_and_with_h_cache():
    """compute_checks=False returns only the iterate update, and a shared
    h_cache gives the same values as the in-iteration H sweep."""
    (jt, jprob, js), (tt, tprob, ts) = _start("panda_arm", PARAMS, seed=2)
    tparams = SolverParams(**PARAMS)
    full, _ = tsm._iteration(tt, tprob, tparams, ts)
    part, chk = tsm._iteration(tt, tprob, tparams, ts, compute_checks=False)
    assert chk is None and set(part) == {"vis", "fis", "nu", "z", "w", "yis", "Aty"}
    S = tsm._S_lists(tt, tprob, torch.float64)
    cached, _ = tsm._iteration(tt, tprob, tparams, ts,
                               h_cache=(S, tsm._h_sweep(tt, tprob, tparams, ts, S)))
    for key in part:
        assert torch.equal(part[key], full[key]) and torch.equal(cached[key], full[key])
    jpart, _ = jsm._iteration(jt, jprob, JParams(**PARAMS), js, compute_checks=False)
    for key in part:
        _close(key, part[key], jpart[key])


@pytest.mark.parametrize("robot", ["panda", "solo12", "talos"])
def test_kkt_residual_f64(robot):
    """The one-shot KKT residual the delta-duals stage starts from, at a
    state a few iterations in."""
    params = dict(PARAMS, check_interval=4)
    (jt, jprob, js), (tt, tprob, ts) = _start(robot, params, B=4, seed=6)
    js = jsm.make_loop_body(jt, jprob, JParams(**params))(js)
    ts = tsm.make_loop_body(tt, tprob, SolverParams(**params))(ts)
    for name, g, w in zip(("d0_v", "d0_nu", "fdpa"), tsm.kkt_residual(tt, tprob, ts),
                          jsm.kkt_residual(jt, jprob, js)):
        _close(name, g, w)


def test_state_round_trip():
    (_, _, js), _ = _start("panda", PARAMS)
    st = convert.state_from_arrays(js, device="cpu")
    back = convert.state_to_numpy(st)
    for name, arr in back.items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(js, name)), err_msg=name)
