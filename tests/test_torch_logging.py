"""Per-iteration logging and the verbose console mode of the port against
loik_tpu's, in float64 on the CPU.

ur5 with one 6-D end-effector constraint, box +-0.5, nine numpy-seeded
configurations; every third problem commands v_z = 40, unreachable within
the box, so it is certified infeasible and runs the tail solve.  All 12 log
fields are held to loik_tpu's at 1e-10 abs-or-rel with NaN in the same
slots (the dual residuals of problems with large duals also get the
rounding of those duals, `assert_logs_match`), at check_interval 1 and 3
(one loik_tpu compile each).  The verbose
lines and the acceptance or refusal of `logging` / `verbose` by every
entry point are checked on the port alone: loik_tpu is run where it
refuses (before anything compiles), and its accepting cases, one compile
each, are the table `ACCEPTS` (each measured once with loik_tpu on the CPU).
"""

import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu.api import DiffIkSolver as JDiffIkSolver
from loik_tpu.kernels.fused import solve_fused as jsolve_fused
from loik_tpu.model import robots as jrobots
from loik_tpu.params import SolverParams as JParams
from loik_tpu.problem import make_problem as jmake_problem
from loik_tpu.solver import solve as jsolve
from loik_tpu.solver.refine import _cast_problem as _jcast_problem
from loik_tpu.solver.stream import solve_stream as jsolve_stream
from loik_tpu_torch import convert
from loik_tpu_torch.kernels.fused import solve_fused
from loik_tpu_torch.solver.refine import _cast_problem
from loik_tpu_torch.solver.state import LOG_FIELDS

from tests.test_torch_model import q_batch

B = 9
PARAMS = dict(max_iter=60, tol_abs=1e-6, tol_rel=1e-6)


def setup():
    """(jax tree, port tree, jax problem, port problem, q)."""
    jt = jrobots.ur5()
    b = np.zeros((B, 1, 6))
    b[:, 0, 2] = 0.2
    b[::3, 0, 2] = 40.0
    jp = jmake_problem(jt, (jt.njoints - 1,), b=b, lb=-0.5 * np.ones(jt.nv),
                       ub=0.5 * np.ones(jt.nv))
    return (jt, convert.tree_from_arrays(jt, device="cpu"), jp,
            convert.problem_from_arrays(jp, device="cpu"), q_batch(jt, B, seed=11))


DUAL_RESIDUAL_LOGS = ("log_rd", "log_rd_v", "log_rd_nu")


def assert_logs_match(res_t, res_j, atol=1e-10):
    """Every log field: shape, NaN slots, and values within atol abs-or-rel.
    The dual-residual logs also get 1e-14 x the problem's largest task dual
    |y|_inf: they subtract terms of that size, and a certified-infeasible
    problem's duals grow without bound (to 4e5 here, where the two
    packages' float64 roundings then differ by up to 3.1e-10; a feasible
    problem's by at most 6.4e-15)."""
    ymax = np.abs(np.asarray(res_j.state.yis)).max(axis=(0, 1))          # (B,)
    for name in LOG_FIELDS:
        a, b = getattr(res_t, name).numpy(), np.asarray(getattr(res_j, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        tol = atol * np.maximum(1.0, np.abs(np.nan_to_num(b)))
        if name in DUAL_RESIDUAL_LOGS:
            tol = tol + 1e-14 * ymax
        ran = ~np.isnan(b)
        err = np.abs(a - np.nan_to_num(b))[ran]
        assert (err <= tol[ran]).all(), (name, err.max())
    for name in ("converged", "primal_infeasible", "iterations", "tail_iterations"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                      np.asarray(getattr(res_j, name)), err_msg=name)


@pytest.fixture(scope="module")
def runs():
    """check_interval -> (port result, loik_tpu result), both logged."""
    jt, tt, jp, tp, q = setup()
    out = {}
    for K in (1, 3):
        params = dict(PARAMS, check_interval=K, logging=True)
        out[K] = (lt.solve(tt, lt.SolverParams(**params), torch.as_tensor(q), tp),
                  jsolve(jt, JParams(**params), jnp.asarray(q), jp))
    return out


@pytest.mark.parametrize("K", [1, 3])
def test_logs_match_reference(runs, K):
    res_t, res_j = runs[K]
    assert res_t.primal_infeasible.any() and res_t.converged.any()
    assert_logs_match(res_t, res_j)
    # logged slots: the check iterations each problem ran, NaN elsewhere
    rp = res_t.log_rp.numpy()
    for j, it in enumerate(res_t.iterations.tolist()):
        ran = np.zeros(PARAMS["max_iter"], bool)
        ran[K - 1:it:K] = True
        np.testing.assert_array_equal(~np.isnan(rp[:, j]), ran)
    # the last logged residual is the reported one
    last = res_t.log_rp.gather(0, (res_t.iterations.long() - 1)[None])[0]
    assert torch.equal(last, res_t.primal_residual)


def test_tail_solve_flags(runs):
    """log_in_tail marks the tail iterations: one per tail iteration the
    problem ran (`tail_iterations`; 0 when the iterates had already stopped
    moving at the detection), only on problems certified infeasible, and
    after every normal-mode iteration of that problem."""
    res_t, _ = runs[1]
    in_tail = np.nan_to_num(res_t.log_in_tail.numpy())
    np.testing.assert_array_equal(in_tail.sum(0), res_t.tail_iterations.numpy())
    pinf = res_t.primal_infeasible.numpy()
    assert (in_tail.sum(0)[~pinf] == 0).all() and in_tail.sum() > 0
    for j in np.nonzero(in_tail.sum(0))[0]:
        rows = np.nonzero(in_tail[:, j])[0]
        assert (np.diff(rows) == 1).all() and rows[-1] == res_t.iterations[j] - 1


def test_verbose_lines(capfd):
    """The banner of every body call and the terminal notices, in
    loik_tpu's format, with the batch aggregates of the logs beside them."""
    _, tt, _, tp, q = setup()
    params = lt.SolverParams(**PARAMS, logging=True, verbose=True, tail_solve=False)
    res = lt.solve(tt, params, torch.as_tensor(q), tp)
    out = capfd.readouterr().out.splitlines()
    banner = [ln for ln in out if ln.startswith("[loik] iter ")]
    iters = res.iterations.numpy()
    assert len(banner) == iters.max()
    rp = res.log_rp.numpy()
    for i, line in enumerate(banner, 1):
        m = re.fullmatch(r"\[loik\] iter (\d+): primal res (\S+), dual res (\S+), running (\d+)",
                         line)
        assert m, line
        assert int(m.group(1)) == i
        assert m.group(2) == f"{np.nanmax(rp[i - 1]):.3e}"
        assert int(m.group(4)) == int((iters > i).sum())
    n_conv, n_pinf = int(res.converged.sum()), int(res.primal_infeasible.sum())
    assert f"[loik] solve finished: {n_conv} converged, max iterations {iters.max()}" in out
    assert f"[loik] WARNING: {n_pinf} problem(s) certified primal infeasible" in out
    assert n_pinf and n_conv + n_pinf == B
    assert not any("hit max_iter" in ln for ln in out)
    lt.solve(tt, params.replace(max_iter=3), torch.as_tensor(q), tp)
    out = capfd.readouterr().out
    assert "[loik] WARNING: 9 problem(s) hit max_iter without converging" in out


# loik_tpu's answer on the CPU for every (entry point, flag) it accepts —
# True: the result carries the logs; `solve_delta_duals` returns a result
# it assembles from the two stages, without logs.  A refusal is a
# ValueError from both packages, checked by running both.
ACCEPTS = {
    ("solve", "logging"): True, ("solve", "verbose"): False,
    ("solve_delta_duals", "logging"): False, ("solve_delta_duals", "verbose"): False,
    ("solve_two_stage", "logging"): True, ("solve_two_stage", "verbose"): False,
    ("solve_delta_refined", "logging"): True, ("solve_delta_refined", "verbose"): False,
    ("solve_stream", "verbose"): False, ("solve_clik", "verbose"): False,
    ("DiffIkSolver(fused=None)", "logging"): True,
    ("DiffIkSolver(fused=None)", "verbose"): False,
}
REFUSES = {
    "solve_fused": "fused path does not support",
    "solve_stream": "does not support per-iteration logging",
    "DiffIkSolver(fused='require')": "fused='require'",
}
ENTRIES = ("solve", "solve_fused", "solve_delta_duals", "solve_two_stage",
           "solve_delta_refined", "solve_stream", "solve_clik",
           "DiffIkSolver(fused=None)", "DiffIkSolver(fused='require')")


def _port_call(entry, params, tree, problem, q):
    small = dict(stage1_max_iter=2, stage2_max_iter=2)
    ee = problem.constraint_links[0]
    calls = {
        "solve": lambda: lt.solve(tree, params, q, problem),
        "solve_fused": lambda: solve_fused(tree.astype(torch.float32), params, q.float(),
                                           _cast_problem(problem, torch.float32)),
        "solve_delta_duals": lambda: lt.solve_delta_duals(tree, params, q, problem, **small),
        "solve_two_stage": lambda: lt.solve_two_stage(tree, params, q, problem, **small),
        "solve_delta_refined": lambda: lt.solve_delta_refined(tree, params, q, problem,
                                                              stage2_max_iter=2),
        "solve_stream": lambda: lt.solve_stream(tree, params, q, problem, 0,
                                                torch.zeros((2, 6), dtype=q.dtype)),
        "solve_clik": lambda: lt.solve_clik(tree, params, q, torch.eye(3, dtype=q.dtype),
                                            torch.zeros(3, dtype=q.dtype), ee, steps=2),
        "DiffIkSolver(fused=None)": lambda: lt.DiffIkSolver(
            tree, params, (ee,), problem=problem).solve_tracking(q, ee, b=problem.b[0]),
        "DiffIkSolver(fused='require')": lambda: lt.DiffIkSolver(
            tree, params, (ee,), problem=problem, fused="require").solve_tracking(
                q, ee, b=problem.b[0]),
    }
    return calls[entry]()


def _reference_call(entry, params, tree, problem, q):
    ee = problem.constraint_links[0]
    calls = {
        "solve_fused": lambda: jsolve_fused(tree.astype(jnp.float32), params,
                                            q.astype(jnp.float32),
                                            _jcast_problem(problem, jnp.float32),
                                            interpret=True),
        "solve_stream": lambda: jsolve_stream(tree, params, q, problem, 0,
                                              jnp.zeros((2, 6))),
        "DiffIkSolver(fused='require')": lambda: JDiffIkSolver(
            tree, params, (ee,), problem=problem, fused="require").solve_tracking(
                q, ee, b=problem.b[0]),
    }
    return calls[entry]()


@pytest.mark.parametrize("flag", ["logging", "verbose"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_accept_or_refuse_as_reference(entry, flag):
    jt, tt, _, _, q = setup()
    jp = jmake_problem(jt, (jt.njoints - 1,), b=np.array([[0, 0, 0.2, 0, 0, 0.0]]),
                       lb=-2 * np.ones(jt.nv), ub=2 * np.ones(jt.nv))
    tp = convert.problem_from_arrays(jp, device="cpu")
    params = dict(max_iter=4, **{flag: True})
    qt = torch.as_tensor(q[:2])
    if entry == "solve_clik" and flag == "logging":
        # the one departure: loik_tpu crashes here (its cold self-heal state
        # has no logs, loik_tpu/solver/clik.py:72); the port refuses
        with pytest.raises(ValueError, match="keeps no per-tick logs"):
            _port_call(entry, lt.SolverParams(**params), tt, tp, qt)
        return
    if (entry, flag) in ACCEPTS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # the kernel's blocker, named once
            res = _port_call(entry, lt.SolverParams(**params), tt, tp, qt)
        if entry == "solve_clik":
            assert res.q.shape == qt.shape
        elif entry == "solve_stream":
            assert res.nu.shape[:2] == (2, 2)
        else:
            assert (res.log_rp is not None) == ACCEPTS[(entry, flag)]
            if res.log_rp is not None:
                assert res.log_rp.shape[1] == 2
        return
    match = REFUSES[entry]
    with pytest.raises(ValueError, match=re.escape(match)):
        _port_call(entry, lt.SolverParams(**params), tt, tp, qt)
    with pytest.raises(ValueError, match=re.escape(match)):
        _reference_call(entry, JParams(**params), jt, jp, jnp.asarray(q[:2]))


def test_logged_state_carries_into_warm_start(runs):
    """A logged state's logs stay in a warm solve without logging (as in
    loik_tpu, whose result returns the state's logs), and a logged warm
    solve gets fresh ones."""
    res_t, _ = runs[1]
    _, tt, _, tp, q = setup()
    params = lt.SolverParams(**PARAMS, warm_start=True)
    warm = lt.solve(tt, params, torch.as_tensor(q), tp, warm_state=res_t.state)
    assert torch.allclose(warm.log_rp, res_t.log_rp, rtol=0, atol=0, equal_nan=True)
    logged = lt.solve(tt, params.replace(logging=True), torch.as_tensor(q), tp,
                      warm_state=res_t.state)
    assert logged.log_rp.shape == (PARAMS["max_iter"], B)
    assert np.isnan(logged.log_rp.numpy()[logged.iterations.max():]).all()



def test_first_call_past_the_logs_end():
    """max_iter < check_interval: the first body call runs K iterations, so
    its row would lie past the log's end; loik_tpu's scatter drops that
    write, the port leaves the (still NaN) last row NaN instead of indexing
    out of range."""
    _, tt, _, tp, q = setup()
    res = lt.solve(tt, lt.SolverParams(**dict(PARAMS, max_iter=2, check_interval=4),
                                       logging=True), torch.as_tensor(q), tp)
    assert (res.iterations == 4).all()
    assert res.log_rp.shape == (2, B) and torch.isnan(res.log_rp).all()
