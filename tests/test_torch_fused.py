"""The fused-kernel host side of loik_tpu_torch on the CPU: the CPU branch
of `fused_solve_loop` (the eager loop, the port's analog of Pallas
interpret mode), `solve_fused` against loik_tpu's `solve_fused`, the
eligibility reasons and the `fused=` policy, the launch counter, the build
without nvcc, and the layout the wrapper shares with the CUDA source.  The
kernel itself runs only on a card: tests/test_torch_kernel.py holds its
tests.

Float32 outcome budgets.  Where both packages do the same arithmetic
(loik_tpu run op by op and the port fed loik_tpu's FK) the budget is the
one of ROADMAP's North star: nu within 2e-5 where both converged, converged
flags differing on at most max(1, B/100) problems, equal iteration counts
on at least 99%.  Against loik_tpu's compiled program the iteration counts
cannot be held equal: XLA contracts multiply-adds into FMAs and evaluates
FK's sin/cos differently, and the float32 solve is chaotic at the ulp level
(measured: loik_tpu's own `solve_fused` at tol 1e-4, given q moved by one
ulp, changes iteration counts on up to 1.6% of problems and converged nu by
up to 1.7e-3, B=64, four seeds).  That comparison holds flags to the same
bound, iteration counts to equality on 90%, and nu to 50 tol.
"""

import os
import shutil
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu.solver.solve  # noqa: F401  (the module; the package exports a function)
import loik_tpu_torch as lt
import loik_tpu_torch.solver.solve  # noqa: F401
from loik_tpu.kernels import solve_fused as jsolve_fused
from loik_tpu.params import SolverParams as JParams
from loik_tpu_torch.kernels import _build
from loik_tpu_torch.kernels import fused
from loik_tpu_torch.model import builders
from loik_tpu_torch.model import tree as ttree

from tests.test_torch_kernel import CSRC, prepared, states_equal
from tests.test_torch_model import pair, q_batch, shared_fk

jsm = sys.modules["loik_tpu.solver.solve"]
tsm = sys.modules["loik_tpu_torch.solver.solve"]

def _budget(res_t, res_j, B, nu_atol, it_frac):
    ct, cj = res_t.converged.numpy(), np.asarray(res_j.converged)
    for name in ("converged", "primal_infeasible"):
        diff = int((getattr(res_t, name).numpy() != np.asarray(getattr(res_j, name))).sum())
        assert diff <= max(1, B // 100), (name, diff)
    both = ct & cj
    assert both.sum() >= B // 4
    nu_err = np.abs(res_t.nu.numpy()[both] - np.asarray(res_j.nu)[both]).max()
    assert nu_err <= nu_atol, nu_err
    same = (res_t.iterations.numpy() == np.asarray(res_j.iterations)).mean()
    assert same >= it_frac, same


@pytest.mark.parametrize("check_interval", [1, 8])
def test_fused_solve_loop_on_cpu_is_the_eager_loop(check_interval):
    params = lt.SolverParams(max_iter=60, tol_abs=1e-4, tol_rel=1e-4,
                             check_interval=check_interval)
    tree, prob, st = prepared(params)
    n0 = fused.LAUNCHES
    # batch_tile 5 does not divide B=12: a ragged batch is no blocker
    states_equal(fused.fused_solve_loop(tree, params, prob, st, batch_tile=5),
                  tsm._solve_loop(tree, prob, params, st))
    assert fused.LAUNCHES == n0


@pytest.mark.parametrize("check_interval", [1, 8])
def test_solve_fused_matches_reference_f32(check_interval):
    jt, tt, jp, tp = pair("panda_arm", "float32")
    B = 32
    q = q_batch(jt, B, seed=0, dtype="float32")
    params = dict(max_iter=60, tol_abs=1e-4, tol_rel=1e-4, check_interval=check_interval)
    res_j = jsolve_fused(jt, JParams(**params), jnp.asarray(q), jp, batch_tile=16,
                         interpret=True)
    res_t = fused.solve_fused(tt, lt.SolverParams(**params), torch.as_tensor(q), tp)
    _budget(res_t, res_j, B, nu_atol=50 * 1e-4, it_frac=0.9)


@pytest.mark.parametrize("check_interval", [1, 8])
def test_solve_fused_same_arithmetic_as_reference(check_interval, monkeypatch):
    """loik_tpu's solver run op by op (jax.disable_jit) and the port fed the
    same FK: the North-star budget holds (both add alike, term by term)."""
    jt, tt, jp, tp = pair("panda_arm", "float32")
    B = 32
    q = q_batch(jt, B, seed=1, dtype="float32")
    params = dict(max_iter=60, tol_abs=1e-4, tol_rel=1e-4, check_interval=check_interval)
    liMi = shared_fk(jt, q)
    monkeypatch.setattr(tsm, "fwd_pass_init", lambda tree, q_: liMi)
    with jax.disable_jit(), jax.default_matmul_precision("highest"):
        res_j = jsm._solve_impl(jt, JParams(**params), jnp.asarray(q), jp, None)
    res_t = fused.solve_fused(tt, lt.SolverParams(**params), torch.as_tensor(q), tp)
    _budget(res_t, res_j, B, nu_atol=2e-5, it_frac=0.99)


def test_rejections():
    tree, prob, st = prepared(lt.SolverParams())
    q = torch.zeros(4, 7)
    problem = lt.make_problem(tree, (6,))
    for bad, match in ((dict(logging=True), "logging"), (dict(verbose=True), "verbose")):
        params = lt.SolverParams(**bad)
        with pytest.raises(ValueError, match=match):
            fused.fused_solve_loop(tree, params, prob, st)
        with pytest.raises(ValueError, match=match):
            fused.solve_fused(tree, params, q, problem)
    tree64 = lt.robots.panda_arm(device="cpu")
    with pytest.raises(ValueError, match="float32-only"):
        fused.solve_fused(tree64, lt.SolverParams(), torch.zeros(4, 7, dtype=torch.float64),
                          lt.make_problem(tree64, (6,)))


def _chain(n, jtype):
    return builders.serial_chain(n, jtype, device="cpu")


@pytest.mark.parametrize("case,reason", [
    (dict(params=dict(logging=True)), "logging"),
    (dict(params=dict(verbose=True)), "verbose"),
    (dict(dtype=torch.float64), "float32"),
    (dict(tree=lambda: _chain(fused.MAX_JOINTS + 1, ttree.REVOLUTE)), "LOIK_MAX_JOINTS"),
    (dict(tree=lambda: _chain(17, ttree.SPHERICAL)), "LOIK_MAX_NV"),
    (dict(tree=lambda: lt.robots.mobile_ur5("float32", device="cpu")),
     "configuration-dependent motion subspaces"),
    (dict(num_constraints=fused.MAX_CONSTRAINTS + 1), "LOIK_MAX_CONSTRAINTS"),
    (dict(batch_tile=0), "CUDA block size"),
    (dict(batch_tile=2048), "CUDA block size"),
])
def test_eligibility_reasons(case, reason):
    tree = case["tree"]() if "tree" in case else lt.robots.panda_arm("float32", device="cpu")
    ok, why = fused.fused_eligibility(
        tree, lt.SolverParams(**case.get("params", {})), 100,
        case.get("batch_tile", 128), case.get("dtype"),
        case.get("num_constraints", 1))
    assert not ok and reason in why


def test_eligible_shapes():
    tree = lt.robots.panda(device="cpu")
    for B, bt in ((16384, 128), (1000, 128), (7, 1024)):
        assert fused.fused_eligibility(tree, lt.SolverParams(), B, bt, torch.float32) == (True, None)
    assert fused.fused_eligibility(tree, lt.SolverParams(), 8, 8, None)[0]


@pytest.mark.parametrize("tree,num_constraints", [
    (lambda: lt.robots.solo12("float32", device="cpu"), 5),
    (lambda: lt.robots.talos("float32", device="cpu"), 2),
    (lambda: lt.robots.talos_like("float32", device="cpu"), 2),
    (lambda: _chain(fused.MAX_JOINTS, ttree.REVOLUTE), 1),
    (lambda: _chain(8, ttree.FREE_FLYER), fused.MAX_CONSTRAINTS),
], ids=["solo12", "talos", "talos_like", "40 joints", "48 dofs"])
def test_eligible_trees(tree, num_constraints):
    """Joints of up to 6 dofs and trees up to the caps are eligible."""
    assert fused.fused_eligibility(tree(), lt.SolverParams(), 4096, 128, torch.float32,
                                   num_constraints) == (True, None)


def test_resolve_fused_policy(monkeypatch):
    monkeypatch.setattr(fused, "_fallback_warned", set())
    tree, ok_params = lt.robots.panda_arm("float32", device="cpu"), lt.SolverParams()
    bad = lt.SolverParams(logging=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert fused.resolve_fused(None, tree, ok_params, 64, 128) is True
        assert fused.resolve_fused(False, tree, ok_params, 64, 128) is False
        assert fused.resolve_fused(True, tree, bad, 64, 128) is True
    with pytest.warns(UserWarning, match="logging"):
        assert fused.resolve_fused(None, tree, bad, 64, 128, where="here") is False
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # once per (call site, reason)
        assert fused.resolve_fused(None, tree, bad, 64, 128, where="here") is False
    with pytest.warns(UserWarning, match="logging"):
        fused.resolve_fused(None, tree, bad, 64, 128, where="elsewhere")
    with pytest.raises(ValueError, match="fused='require'.*logging"):
        fused.resolve_fused("require", tree, bad, 64, 128)
    assert fused.resolve_fused("require", tree, ok_params, 64, 128) is True


def test_no_launches_on_cpu():
    """CPU tensors never reach the kernel: the launch counter stays put
    through every public entry point of the fused path."""
    tree = lt.robots.panda_arm("float32", device="cpu")
    problem = lt.make_problem(tree, (6,), b=np.array([[0, 0, 0.2, 0, 0, 0]]))
    q = torch.as_tensor(q_batch(tree, 8, seed=2), dtype=torch.float32)
    n0 = fused.LAUNCHES
    fused.solve_fused(tree, lt.SolverParams(max_iter=20), q, problem)
    lt.solve_delta_duals(tree, lt.SolverParams(max_iter=20), q, problem, fused="require")
    lt.DiffIkSolver(tree, lt.SolverParams(max_iter=20), (6,), fused=True).solve_refined(q)
    assert fused.LAUNCHES == n0


def test_kernel_modules_import_and_build_refuses_without_nvcc(monkeypatch, tmp_path):
    """Importing the kernel modules (done at the top of this file) needs no
    CUDA toolkit; building without nvcc raises with the places searched (no
    fallback)."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not os.path.exists(tmp_path / "build" / os.path.basename(_build.library_path()))


def test_build_key_follows_sources(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    shutil.copy(CSRC, src)
    monkeypatch.setattr(_build, "CSRC", str(src))
    before = _build.library_path()
    with open(src / "fused_admm.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path() != before
    assert before.startswith(_build.BUILD_DIR)
