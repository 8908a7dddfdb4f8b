"""The mixed super-batch of loik_tpu_torch (`parallel/mixed.py`) against
loik_tpu's on the CPU: the batched geometry leaves of the padded chain (FK,
motion subspaces), the assembly (`prepare_mixed_padded`, `pack_q`), the
float64 solve pass by pass and end to end, the per-problem subspaces as data
(`PreparedProblem.S_all`, the operand the fused kernel reads), the refusals,
and the tight-tolerance float32 path through `solve_delta_duals`.

Inputs come from numpy seeds and go through both packages: UR5 (6 joints,
padded by one zero-subspace joint) and panda_arm (7 joints).

Float32 budgets, as in tests/test_torch_fused.py and test_torch_refine.py.
Against loik_tpu run op by op with the port fed loik_tpu's FK both add
alike: nu within 2e-5 where both converged, converged flags differing on at
most max(1, B/100) problems, equal iteration counts on at least 99%.
Against loik_tpu's compiled program (FMA contraction, its own sin/cos) the
float32 solve lands on other counts at the float32 floor; measured here at
8 + 8 problems, check_interval 4, seeds 0-3: iteration counts differ on 0
to 5 of a group's 8 problems, by one check interval (two on one problem of
seed 0), flags on none, converged nu by at most 3.3e-5 (seed 3; under 1.3e-5
on the others).  That comparison holds flags to the same bound, nu to 5e-5
and iteration counts to two check intervals.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu.solver.solve  # noqa: F401  (the module; the package exports a function)
import loik_tpu_torch as lt
import loik_tpu_torch.solver.solve  # noqa: F401
from loik_tpu.kernels.fused import with_S_all as jwith_S_all
from loik_tpu.model import robots as jrobots
from loik_tpu.parallel import prepare_mixed_padded as jprepare
from loik_tpu.parallel import solve_mixed_padded as jsolve_mixed_padded
from loik_tpu.params import SolverParams as JParams
from loik_tpu.problem import make_problem as jmake_problem
from loik_tpu.solver.refine import solve_delta_duals as jdelta
from loik_tpu.solver.state import init_state as jinit_state
from loik_tpu_torch import convert
from loik_tpu_torch.kernels import fused
from loik_tpu_torch.parallel import (MixedPadded, prepare_mixed_padded, solve_mixed,
                                     solve_mixed_padded)
from loik_tpu_torch.parallel.mixed import _is_1dof_chain
from loik_tpu_torch.solver.refine import solve_delta_duals
from loik_tpu_torch.solver.state import init_state

from tests.test_torch_lockstep import _close, _compare_states
from tests.test_torch_solve import assert_same

jsm = sys.modules["loik_tpu.solver.solve"]
tsm = sys.modules["loik_tpu_torch.solver.solve"]

PARAMS = dict(max_iter=300, tol_abs=1e-8, tol_rel=1e-8)
# bench.py's mixed line: tol 1e-6 through the delta-duals path, K = 4
MIXED = dict(max_iter=200, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
             mu_equality_scale_factor=1e5, tail_solve=False, check_interval=4)
ROBOTS = ("ur5", "panda_arm")


def groups(sizes=(5, 3), seed=0, dtype="float64", b3=(0.15, 0.1), capped=False):
    """[(jax tree, q, jax problem)], [(port tree, q tensor, port problem)]:
    the same robots, problems and numpy-seeded q for both packages.
    capped=True takes bench.py's box (the velocity limits capped at 4)."""
    rng = np.random.default_rng(seed)
    jg, tg = [], []
    for robot, Bg, b3g in zip(ROBOTS, sizes, b3):
        jt = jrobots.get(robot, dtype)
        b = np.zeros((1, 6))
        b[0, 2] = b3g
        vl = (np.minimum(np.asarray(jt.velocity_limit), 4.0) if capped
              else 4.0 * np.ones(jt.nv))
        jp = jmake_problem(jt, (jt.njoints - 1,), b=b, lb=-vl, ub=vl,
                           dtype=jnp.dtype(dtype))
        q = rng.uniform(-np.pi, np.pi, (Bg, jt.nq)).astype(dtype)
        jg.append((jt, jnp.asarray(q), jp))
        tg.append((convert.tree_from_arrays(jt, device="cpu"), torch.as_tensor(q),
                   convert.problem_from_arrays(jp, device="cpu")))
    return jg, tg


def prepared_pair(sizes=(5, 3), seed=0, dtype="float64"):
    jg, tg = groups(sizes, seed, dtype)
    jmp = jprepare([(t, q.shape[0], p) for t, q, p in jg])
    tmp = prepare_mixed_padded([(t, q.shape[0], p) for t, q, p in tg])
    return jg, tg, jmp, tmp


def _leaves_equal(got, want):
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(g, torch.Tensor):
            assert g.dtype == getattr(torch, str(w.dtype)), f.name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f.name)
        else:
            assert g == (tuple(w) if isinstance(w, (list, tuple)) else w), f.name


def test_prepare_mixed_padded_equals_reference():
    jg, tg, jmp, tmp = prepared_pair()
    assert isinstance(tmp, MixedPadded)
    assert tmp.group_sizes == tuple(jmp.group_sizes) == (5, 3)
    assert tmp.group_njoints == tuple(jmp.group_njoints) == (6, 7)
    _leaves_equal(tmp.chain, jmp.chain)
    _leaves_equal(tmp.problem, jmp.problem)
    assert tmp.chain.has_batched_geometry and tmp.chain.axis.shape == (7, 8, 3)
    assert not tg[0][0].has_batched_geometry
    # the padded joint of the UR5 rows: zero axis, identity placement
    assert not tmp.chain.axis[6, :5].any()
    assert torch.equal(tmp.chain.placement_R[6, 0], torch.eye(3, dtype=torch.float64))
    # carried across whole, the reference's object is the same thing
    carried = convert.mixed_from_arrays(jmp, device="cpu")
    _leaves_equal(carried.chain, jmp.chain)
    _leaves_equal(carried.problem, jmp.problem)
    assert carried.group_sizes == tmp.group_sizes and carried.group_njoints == tmp.group_njoints


def test_prepare_mixed_padded_dtype_and_device_arguments():
    _, tg = groups()
    mp = prepare_mixed_padded([(t, 2, p) for t, _, p in tg], dtype=torch.float32,
                              device="cpu")
    assert mp.chain.dtype == torch.float32 and mp.problem.lb.dtype == torch.float32
    assert mp.chain.device.type == "cpu" and mp.chain.axis.shape == (7, 4, 3)


def test_pack_q_equals_reference():
    jg, tg, jmp, tmp = prepared_pair()
    got = tmp.pack_q([q for _, q, _ in tg])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmp.pack_q([q for _, q, _ in jg])))
    assert got.shape == (8, 7) and not got[:5, 6:].any()
    rng = np.random.default_rng(5)
    stacked = [rng.uniform(-1, 1, (3, Bg, n)) for Bg, n in ((5, 6), (3, 7))]
    got = tmp.pack_q_stacked(stacked)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmp.pack_q_stacked(stacked)))
    for r in range(3):
        assert torch.equal(got[r], tmp.pack_q([s[r] for s in stacked]))


def test_batched_leaves_fk_and_subspaces_match_reference():
    """joint_S, joint_calc and fwd_kinematics over (N, B, ...) leaves, on the
    reference's own padded chain carried across: float64 within 1e-12."""
    jg, _, jmp, _ = prepared_pair()
    chain = convert.tree_from_arrays(jmp.chain, device="cpu")
    q = np.array(jmp.pack_q([q for _, q, _ in jg]))
    for i in range(chain.njoints):
        S = chain.joint_S(i)
        assert S.shape == (8, 6, 1)
        np.testing.assert_allclose(S.numpy(), np.asarray(jmp.chain.joint_S(i)),
                                   rtol=0, atol=1e-12)
        for g, w in zip(chain.joint_calc(i, torch.as_tensor(q)),
                        jmp.chain.joint_calc(i, jnp.asarray(q))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    for g, w in zip(chain.fwd_kinematics(torch.as_tensor(q)),
                    jmp.chain.fwd_kinematics(jnp.asarray(q))):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    assert chain.joint_S_padded().shape == (7, 8, 6, 1)
    assert chain.astype(torch.float32).axis.shape == (7, 8, 3)


@pytest.mark.parametrize("jtype", ["prismatic", "helical"])
def test_batched_leaves_other_one_dof_types(jtype):
    """Prismatic and helical joints take batched axes too: each problem's
    subspace and transform equal those of a plain tree with that axis."""
    from loik_tpu_torch.model import tree as ttree

    code = {"prismatic": ttree.PRISMATIC, "helical": ttree.HELICAL}[jtype]
    rng = np.random.default_rng(1)
    axes = rng.normal(size=(3, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    plain = [lt.make_tree([dict(name="j", parent=-1, type=code, axis=a, pitch=0.3,
                                xyz=(0.1, 0.2, 0.3))], device="cpu") for a in axes]
    batched = dataclasses.replace(
        plain[0],
        placement_R=torch.stack([t.placement_R for t in plain], 1),
        placement_p=torch.stack([t.placement_p for t in plain], 1),
        axis=torch.stack([t.axis for t in plain], 1))
    q = torch.as_tensor(rng.uniform(-1, 1, (3, 1)))
    S = batched.joint_S(0)
    outs = batched.fwd_kinematics(q)
    for b, t in enumerate(plain):
        assert torch.equal(S[b], t.joint_S(0))
        for g, w in zip(outs, t.fwd_kinematics(q[b])):
            np.testing.assert_allclose(g[b].numpy(), w.numpy(), rtol=0, atol=1e-15)


def _start(jmp, tmp, jq, tq, params):
    """Prepared problem and reset state with FK on the padded chain, in both
    packages."""
    B, f64 = tq.shape[0], jnp.float64
    jprob = jsm.prepare_problem(jmp.chain, jmp.problem, B, f64)
    tprob = tsm.prepare_problem(tmp.chain, tmp.problem, B, torch.float64)
    js = jsm._reset_state(jmp.chain, JParams(**params),
                          jinit_state(jmp.chain, B, 1, f64), f64)
    R, p = jsm.fwd_pass_init(jmp.chain, jq)
    js = dataclasses.replace(js, liMi_R=R, liMi_p=p)
    ts = tsm._reset_state(tmp.chain, lt.SolverParams(**params),
                          init_state(tmp.chain, B, 1, torch.float64, "cpu"), torch.float64)
    R, p = tsm.fwd_pass_init(tmp.chain, tq)
    ts = dataclasses.replace(ts, liMi_R=R, liMi_p=p)
    return jprob, js, tprob, ts


def test_padded_chain_iteration_lockstep_f64():
    """Pass by pass on the padded chain, `_iteration(debug=True)` in both
    packages within 1e-10, then one body call each; the padded joint's dofs
    stay exactly zero throughout."""
    params = dict(max_iter=40, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
                  mu_equality_scale_factor=1e5)
    jg, tg, jmp, tmp = prepared_pair()
    jq, tq = jmp.pack_q([q for _, q, _ in jg]), tmp.pack_q([q for _, q, _ in tg])
    jprob, js, tprob, ts = _start(jmp, tmp, jq, tq, params)
    for name in ("H_ref", "Hv", "A", "b", "AtA", "Atb", "lb", "ub", "b_inf", "Hv_inf"):
        _close(f"prepare {name}", getattr(tprob, name), getattr(jprob, name))
    jbody = jsm.make_loop_body(jmp.chain, jprob, JParams(**params))
    tbody = tsm.make_loop_body(tmp.chain, tprob, lt.SolverParams(**params))
    for it in range(6):
        assert bool(ts.running.any())
        jnew, jchk = jsm._iteration(jmp.chain, jprob, JParams(**params), js, debug=True)
        tnew, tchk = tsm._iteration(tmp.chain, tprob, lt.SolverParams(**params), ts,
                                    debug=True)
        assert tchk["debug"].keys() == jchk["debug"].keys()
        for key, want in jchk["debug"].items():
            got = tchk["debug"][key]
            if isinstance(want, list):
                for i, (g, w) in enumerate(zip(got, want)):
                    _close(f"iter {it} {key}[{i}]", g, w)
            else:
                _close(f"iter {it} {key}", got, want)
        for key, want in jnew.items():
            _close(f"iter {it} new {key}", tnew[key], want)
        js, ts = jbody(js), tbody(ts)
        _compare_states(f"after iter {it}", ts, js)
        for name in ("nu", "z", "w", "stfw"):
            assert not getattr(ts, name)[6, :, :5].any(), name


def test_solve_mixed_padded_f64_matches_reference():
    jg, tg = groups((5, 3), seed=1)
    res_j = jsolve_mixed_padded(jg, JParams(**PARAMS))
    res_t = solve_mixed_padded(tg, lt.SolverParams(**PARAMS))
    assert len(res_t) == 2
    for (tree, _, _), rt, rj in zip(tg, res_t, res_j):
        assert rt.nu.shape == (rj.nu.shape[0], tree.nv) and rt.state is None
        assert_same(rt, rj)
    assert any(bool(r.converged.any()) for r in res_t)


def test_padded_result_matches_per_group_solves():
    """The budget of tests/test_mixed.py: the same optimum per group, status
    flips rare, commonly-converged solutions equal to solver tolerance; the
    raw super-batch's padded dofs are exactly zero."""
    _, tg = groups((5, 3), seed=2)
    params = lt.SolverParams(**PARAMS)
    mp = prepare_mixed_padded([(t, q.shape[0], p) for t, q, p in tg])
    raw = mp.solve_packed(params, [q for _, q, _ in tg])
    assert raw.nu.shape == (8, 7) and not raw.nu[:5, 6].any() and not raw.z[:5, 6].any()
    for name in ("nu", "z", "w", "stfw"):
        assert not getattr(raw.state, name)[6, :, :5].any(), name
    # the padded tip carries the real end-effector's velocity unchanged
    assert torch.equal(raw.vis[:5, 6], raw.vis[:5, 5])
    padded = mp.unpack(raw)
    plain = solve_mixed(tg, params)
    for rp, rg in zip(padded, plain):
        both = rp.converged & rg.converged
        assert int(both.sum()) >= max(1, int(rg.converged.sum()) - 1)
        assert int((rp.converged != rg.converged).sum()) <= 1
        np.testing.assert_allclose(rp.nu[both].numpy(), rg.nu[both].numpy(), atol=1e-6)
        np.testing.assert_allclose(rp.vis[both, -1].numpy(), rg.vis[both, -1].numpy(),
                                   atol=1e-6)
    # the prepared object gives what the one-call form gives
    for a, b in zip(padded, solve_mixed_padded(tg, params)):
        assert torch.equal(a.nu, b.nu) and torch.equal(a.converged, b.converged)


def test_solve_scan_equals_repeated_solves():
    _, tg = groups((4, 4), seed=3)
    params = lt.SolverParams(**PARAMS)
    mp = prepare_mixed_padded([(t, 4, p) for t, _, p in tg])
    rng = np.random.default_rng(7)
    R = 3
    stacked = [rng.uniform(-np.pi, np.pi, (R, 4, t.nq)) for t, _, _ in tg]
    nu, conv, iters, rp, rd = mp.solve_scan(params, stacked)
    assert nu.shape == (R, 8, 7) and conv.shape == iters.shape == rp.shape == (R, 8)
    for r in range(R):
        res = mp.solve_packed(params, [s[r] for s in stacked])
        assert torch.equal(nu[r], res.nu) and torch.equal(conv[r], res.converged)
        assert torch.equal(iters[r], res.iterations)
        assert torch.equal(rp[r], res.primal_residual)
        assert torch.equal(rd[r], res.dual_residual)
    q_packed = mp.pack_q_stacked(stacked)
    conv2, iters2 = mp.solve_scan(params, q_packed=q_packed, light=True)
    assert torch.equal(conv2, conv) and torch.equal(iters2, iters)


@pytest.mark.parametrize("args,match", [
    (dict(both=True), "exactly one"), (dict(both=False), "exactly one")])
def test_solve_scan_wants_exactly_one_input(args, match):
    _, tg = groups((2, 2))
    mp = prepare_mixed_padded([(t, 2, p) for t, _, p in tg])
    stacked = [np.zeros((1, 2, t.nq)) for t, _, _ in tg]
    with pytest.raises(ValueError, match=match):
        if args["both"]:
            mp.solve_scan(lt.SolverParams(), stacked, q_packed=mp.pack_q_stacked(stacked))
        else:
            mp.solve_scan(lt.SolverParams())


def test_rejects_non_chain():
    tree = lt.robots.solo12(device="cpu")
    problem = lt.make_problem(tree, (tree.njoints - 1,))
    assert not _is_1dof_chain(tree) and _is_1dof_chain(lt.robots.ur5(device="cpu"))
    with pytest.raises(ValueError, match="serial 1-dof chains; 'solo12' is not"):
        solve_mixed_padded([(tree, tree.neutral()[None], problem)], lt.SolverParams())


def test_rejects_non_end_effector_constraint():
    tree = lt.robots.ur5(device="cpu")
    problem = lt.make_problem(tree, (2,))
    with pytest.raises(ValueError, match=r"one end-effector constraint per problem; "
                                         r"got links \(2,\) for 'ur5'"):
        solve_mixed_padded([(tree, tree.neutral()[None], problem)], lt.SolverParams())


def test_rejects_mixed_joint_types_per_slot():
    from loik_tpu_torch.model import builders
    from loik_tpu_torch.model import tree as ttree

    rev = builders.serial_chain(3, ttree.REVOLUTE, device="cpu")
    pri = builders.serial_chain(3, ttree.PRISMATIC, device="cpu")
    groups_ = [(t, 2, lt.make_problem(t, (2,))) for t in (rev, pri)]
    with pytest.raises(ValueError, match="joint slot 0 mixes types"):
        prepare_mixed_padded(groups_)


def _with_and_without_S_all(dtype, K):
    torch_dtype = getattr(torch, dtype)
    _, tg = groups((4, 4), seed=4, dtype=dtype)
    mp = prepare_mixed_padded([(t, 4, p) for t, _, p in tg])
    params = lt.SolverParams(**dict(MIXED, check_interval=K, max_iter=60))
    q = mp.pack_q([q for _, q, _ in tg])
    prob = tsm.prepare_problem(mp.chain, mp.problem, 8, torch_dtype)
    st = tsm._reset_state(mp.chain, params,
                          init_state(mp.chain, 8, 1, torch_dtype, "cpu"), torch_dtype)
    R, p = tsm.fwd_pass_init(mp.chain, q)
    st = dataclasses.replace(st, liMi_R=R, liMi_p=p)
    return mp.chain, params, prob, fused.with_S_all(mp.chain, prob, torch_dtype), st


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_S_all_as_data_equals_in_loop_subspaces(dtype, K):
    """The eager loop on precomputed per-problem subspaces (the plain
    version of the kernel's S_all operand) returns the bits of the loop that
    derives S from the batched axis leaf; `fused_solve_loop` on CPU tensors
    is that loop."""
    chain, params, prob, prob_S, st = _with_and_without_S_all(dtype, K)
    assert prob.S_all is None and prob_S.S_all.shape == (7, 6, 1, 8)
    assert prob_S.S_all.is_contiguous() and not prob_S.S_all[6, :, :, :4].any()
    want = tsm._solve_loop(chain, prob, params, st)
    assert bool(want.converged.any())
    for got in (tsm._solve_loop(chain, prob_S, params, st),
                fused.fused_solve_loop(chain, params, prob_S, st)):
        for name in fused._STATE_FIELDS:
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    for g, w in zip(tsm.kkt_residual(chain, prob_S, want), tsm.kkt_residual(chain, prob, want)):
        assert torch.equal(g, w)


def test_S_all_equals_reference():
    jg, tg, jmp, tmp = prepared_pair()
    jprob = jwith_S_all(jmp.chain, jsm.prepare_problem(jmp.chain, jmp.problem, 8,
                                                       jnp.float64), jnp.float64)
    tprob = fused.with_S_all(tmp.chain, tsm.prepare_problem(tmp.chain, tmp.problem, 8,
                                                            torch.float64), torch.float64)
    np.testing.assert_array_equal(tprob.S_all.numpy(), np.asarray(jprob.S_all))


def test_with_S_all_refuses_non_uniform_dofs():
    tree = lt.robots.solo12("float32", device="cpu")
    prob = tsm.prepare_problem(tree, lt.make_problem(tree, (12,)), 2, torch.float32)
    with pytest.raises(ValueError, match="uniform joint dof counts"):
        fused.with_S_all(tree, prob, torch.float32)


def test_fused_solve_loop_refuses_batched_tree_without_S_all():
    chain, params, prob, prob_S, st = _with_and_without_S_all("float32", 1)
    with pytest.raises(ValueError, match="needs precomputed per-problem subspaces"):
        fused.fused_solve_loop(chain, params, prob, st)
    with pytest.raises(ValueError, match="no shared S operand"):
        fused._subspace_operand(chain, torch.float32)


def test_eligibility_of_batched_trees():
    """A mixed chain is eligible; a batched tree taller than the one-dof
    instantiation is refused by name."""
    chain, params, _, _, _ = _with_and_without_S_all("float32", 1)
    assert fused.fused_eligibility(chain, params, 8, 64, torch.float32) == (True, None)
    from loik_tpu_torch.model import builders
    from loik_tpu_torch.model import tree as ttree

    tall = builders.serial_chain(fused.SMALL_JOINTS + 1, ttree.REVOLUTE, device="cpu")
    tall = dataclasses.replace(
        tall, axis=tall.axis[:, None].expand(-1, 2, -1),
        placement_R=tall.placement_R[:, None].expand(-1, 2, -1, -1),
        placement_p=tall.placement_p[:, None].expand(-1, 2, -1))
    ok, why = fused.fused_eligibility(tall, params, 2, 64, torch.float32)
    assert not ok and "S_all" in why and "LOIK_SMALL_JOINTS" in why
    with pytest.raises(ValueError, match="fused='require'.*S_all"):
        fused.resolve_fused("require", tall, params, 2, 64)


def _delta(solve, fused_arg):
    return lambda t, p, q, pr: solve(t, p, q, pr, fused=fused_arg)


def _outcomes(res_t, res_j):
    ct, cj = res_t.converged.numpy(), np.asarray(res_j.converged)
    both = ct & cj
    nu_err = float(np.abs(res_t.nu.numpy()[both] - np.asarray(res_j.nu)[both]).max())
    d_it = res_t.iterations.numpy().astype(int) - np.asarray(res_j.iterations).astype(int)
    return int((ct != cj).sum()), nu_err, d_it


def test_mixed_delta_duals_same_arithmetic_as_reference(monkeypatch):
    """bench.py's mixed line at B=16 (box: velocity limits capped at 4):
    loik_tpu op by op, the port fed loik_tpu's FK of the padded chain."""
    jg, tg = groups((8, 8), seed=0, dtype="float32", b3=(0.2, 0.2), capped=True)
    jmp = jprepare([(t, 8, p) for t, _, p in jg])
    tmp = prepare_mixed_padded([(t, 8, p) for t, _, p in tg])
    R, p = jsm.fwd_pass_init(jmp.chain, jmp.pack_q([q for _, q, _ in jg]))
    liMi = (torch.as_tensor(np.array(R)), torch.as_tensor(np.array(p)))
    monkeypatch.setattr(tsm, "fwd_pass_init", lambda tree, q_: liMi)
    with jax.disable_jit():
        res_j = jdelta(jmp.chain, JParams(**MIXED), jmp.pack_q([q for _, q, _ in jg]),
                       jmp.problem, fused=False)
    n0 = fused.LAUNCHES
    res_t = tmp.solve_packed(lt.SolverParams(**MIXED), [q for _, q, _ in tg],
                             solve_fn=_delta(solve_delta_duals, "require"))
    assert fused.LAUNCHES == n0          # CPU tensors: the eager loop
    flag_diff, nu_err, d_it = _outcomes(res_t, res_j)
    assert flag_diff <= 1 and nu_err <= 2e-5 and (d_it == 0).mean() >= 0.99
    assert not res_t.nu[:8, 6].any() and not res_t.state.w[6, :, :8].any()
    assert res_t.converged.double().mean() > 0.5


def test_mixed_delta_duals_matches_compiled_reference():
    jg, tg = groups((8, 8), seed=1, dtype="float32", b3=(0.2, 0.2), capped=True)
    res_j = jsolve_mixed_padded(jg, JParams(**MIXED), solve_fn=_delta(jdelta, False))
    res_t = solve_mixed_padded(tg, lt.SolverParams(**MIXED),
                               solve_fn=_delta(solve_delta_duals, "require"))
    for rt, rj in zip(res_t, res_j):
        flag_diff, nu_err, d_it = _outcomes(rt, rj)
        assert flag_diff <= 1 and nu_err <= 5e-5
        assert np.abs(d_it).max() <= 2 * MIXED["check_interval"]
        np.testing.assert_array_equal(rt.primal_infeasible.numpy(),
                                      np.asarray(rj.primal_infeasible))


def test_mixed_delta_duals_certifies_on_each_groups_own_tree():
    """What shows that the embedding is right: every problem flagged
    converged meets its task and its box on the group's UNPADDED tree, the
    link velocity recomputed in float64 from (q, nu) by loik_tpu's Jacobian."""
    from loik_tpu.model.kinematics import frame_velocity

    jg, tg = groups((8, 8), seed=2, dtype="float32", b3=(0.2, 0.2), capped=True)
    res_t = solve_mixed_padded(tg, lt.SolverParams(**MIXED),
                               solve_fn=_delta(solve_delta_duals, None))
    for robot, (jt, q, jp), rt in zip(ROBOTS, jg, res_t):
        conv = rt.converged.numpy()
        assert conv.any()
        nu = rt.nu.numpy().astype(np.float64)[conv]
        tree64 = jrobots.get(robot, "float64")
        v = np.asarray(jax.vmap(lambda q_, n: frame_velocity(tree64, q_, n, jt.njoints - 1))(
            jnp.asarray(np.asarray(q)[conv], jnp.float64), jnp.asarray(nu)))
        assert np.abs(v - np.asarray(jp.b[0], np.float64)).max() <= 1e-5
        lb, ub = np.asarray(jp.lb, np.float64), np.asarray(jp.ub, np.float64)
        assert np.maximum(np.maximum(lb - nu, nu - ub), 0).max() <= 1e-5
