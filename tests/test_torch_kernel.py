"""The fused ADMM CUDA kernel (loik_tpu_torch/kernels/csrc/fused_admm.cu)
against its eager PyTorch twin.

The tests marked `cuda` need a CUDA device and skip without one.  This file
imports torch and numpy only, so it also runs on the machine with the card,
which has no jax:

    python -m pytest tests/test_torch_kernel.py -m cuda --noconftest -q

(`--noconftest`: tests/conftest.py configures jax).  The kernel sums in the
eager loop's order and is built with -fmad=false, so the expected difference
is none: every state field is compared for equality.
"""

import dataclasses
import os
import re
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import loik_tpu_torch as lt
import loik_tpu_torch.solver.solve  # noqa: F401  (the module; the package exports a function)
from loik_tpu_torch.kernels import fused
from loik_tpu_torch.solver.state import init_state

tsm = sys.modules["loik_tpu_torch.solver.solve"]
CSRC = os.path.join(os.path.dirname(fused.__file__), "csrc", "fused_admm.cu")
FLAGSHIP = dict(max_iter=200, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
                mu_equality_scale_factor=1e5, tail_solve=False)


def prepared(params, B=12, seed=0, dtype=torch.float32, device="cpu"):
    """(tree, prepared problem, reset state with FK) for the flagship task
    on panda_arm, q uniform in [-pi, pi] from numpy."""
    tree = lt.robots.panda_arm(str(dtype).removeprefix("torch."), device=device)
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.uniform(-np.pi, np.pi, (B, 7)), dtype=dtype, device=device)
    problem = lt.make_problem(tree, (6,), b=np.array([[0, 0, 0.2, 0, 0, 0]]),
                              lb=-4 * np.ones(7), ub=4 * np.ones(7))
    prob = tsm.prepare_problem(tree, problem, B, dtype)
    st = tsm._reset_state(tree, params, init_state(tree, B, 1, dtype, device), dtype)
    R, p = tsm.fwd_pass_init(tree, q)
    return tree, prob, dataclasses.replace(st, liMi_R=R, liMi_p=p)


def prepared_path(name, B, check_interval, dtype=torch.float32, device="cpu", max_iter=200):
    """(tree, params, prepared problem, reset state with FK) of one of
    chip_smoke.py's paths: "flagship", "solo12" or "talos"."""
    tree, _, problem, params, q = chip_smoke.config(
        lt, torch, name, dtype, torch.device(device), B, check_interval, max_iter)
    prob, st = chip_smoke.initial_state(tsm, tree, problem, params, q)
    return tree, params, prob, st


def prepared_mixed(Bg, check_interval, dtype=torch.float32, max_iter=200):
    """(chain, params, prepared problem with S_all, reset state with FK) of
    chip_smoke.py's mixed super-batch: Bg UR5 + Bg panda_arm on the card."""
    mp, groups, params = chip_smoke.mixed_setup(lt, torch, dtype, Bg, check_interval, max_iter)
    q = mp.pack_q([q for _, q, _ in groups])
    prob, st = chip_smoke.initial_state(tsm, mp.chain, mp.problem, params, q)
    return mp.chain, params, fused.with_S_all(mp.chain, prob, dtype), st


def states_equal(a, b):
    for name in fused._STATE_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python -m pytest tests/test_torch_kernel.py -m cuda --noconftest`")


def test_wrapper_layout_matches_cuda_source():
    """The pointer order, the caps and the config struct the wrapper packs
    are the ones csrc/fused_admm.cu declares (the library also reports them
    at first load; this catches a mismatch without a card)."""
    with open(CSRC) as f:
        src = f.read()
    enum = re.search(r"enum LoikPtr \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in enum.replace("\n", " ").split(",") if n.strip()]
    assert names[-1] == "P_COUNT" and len(names) - 1 == fused._N_PTRS
    state = [n.lower().removeprefix("p_") for n in names[:len(fused._STATE_FIELDS)]]
    short = {"primal_infeasible": "pinf", "dual_infeasible": "dinf",
             "primal_residual": "rp", "dual_residual": "rd",
             "delta_x_inf": "dx", "delta_z_inf": "dz"}
    assert state == [short.get(n, n).lower() for n in fused._STATE_FIELDS]
    assert f"#define LOIK_MAX_JOINTS {fused.MAX_JOINTS}" in src
    assert f"#define LOIK_MAX_NV {fused.MAX_NV}" in src
    assert f"#define LOIK_MAX_CONSTRAINTS {fused.MAX_CONSTRAINTS}" in src
    struct = re.search(r"struct LoikConfig \{(.*?)\};", src, re.S).group(1)
    declared = re.findall(r"(\w+)(?:\[\w+\])*[,;]", struct)
    assert declared == [name for name, _ in fused._LoikConfig._fields_]


@pytest.mark.cuda
@pytest.mark.parametrize("check_interval", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_eager_loop_on_card(dtype, check_interval):
    """B=1000 with 128 threads per block: a ragged last block."""
    _need_card()
    params = lt.SolverParams(**FLAGSHIP, check_interval=check_interval)
    tree, prob, st = prepared(params, B=1000, dtype=dtype, device="cuda")
    n0 = fused.LAUNCHES
    ker = fused.fused_solve_loop(tree, params, prob, st, batch_tile=128)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == n0 + 1
    states_equal(ker, tsm._solve_loop(tree, prob, params, st))


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,check_interval", [
    ("solo12", 1000, 1), ("solo12", 1000, 4), ("talos", 300, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_eager_loop_on_card_multi_dof(dtype, name, B, check_interval):
    """Joints of 6 dofs (k x k D blocks), five constraints on one tree, 33
    joints: still the eager loop's bits, and padded dof slots stay zero."""
    _need_card()
    tree, params, prob, st = prepared_path(name, B, check_interval, dtype, "cuda")
    n0 = fused.LAUNCHES
    ker = fused.fused_solve_loop(tree, params, prob, st, batch_tile=64)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == n0 + 1
    states_equal(ker, tsm._solve_loop(tree, prob, params, st))
    for field in ("nu", "z", "w", "stfw"):
        for i, k in enumerate(tree.nvs):
            assert not getattr(ker, field)[i, k:].any(), (field, i)


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,check_interval", [("solo12", 2048, 4), ("talos", 512, 1)])
def test_delta_duals_kernel_path_equals_eager_path_on_card_legged(name, B, check_interval):
    _need_card()
    tree, links, problem, params, q = chip_smoke.config(
        lt, torch, name, torch.float32, torch.device("cuda"), B, check_interval)
    n0 = fused.LAUNCHES
    res = lt.solve_delta_duals(tree, params, q, problem, fused="require")
    torch.cuda.synchronize()
    assert fused.LAUNCHES == n0 + 2
    ref = lt.solve_delta_duals(tree, params, q, problem, fused=False)
    for field in ("nu", "z", "vis", "converged", "primal_infeasible", "iterations",
                  "primal_residual", "dual_residual"):
        assert torch.equal(getattr(res, field), getattr(ref, field)), field
    states_equal(res.state, ref.state)
    assert res.converged.double().mean() > 0.9


@pytest.mark.cuda
def test_subspace_operand_is_built_once_per_tree_on_card():
    _need_card()
    tree = lt.robots.solo12("float32", device="cuda")
    S = fused._subspace_operand(tree, torch.float32)
    assert S.shape == (13, 6, 6) and S.is_cuda
    assert fused._subspace_operand(tree, torch.float32) is S
    assert fused._subspace_operand(tree.astype(torch.float32), torch.float32) is S


@pytest.mark.cuda
def test_delta_duals_kernel_path_equals_eager_path_on_card():
    """Both float32 stages through the kernel (r_offset and the tolerance
    floors in stage 2) return the eager path's bits."""
    _need_card()
    tree = lt.robots.panda_arm("float32", device="cuda")
    problem = lt.make_problem(tree, (6,), b=np.array([[0, 0, 0.2, 0, 0, 0]]),
                              lb=-4 * np.ones(7), ub=4 * np.ones(7))
    q = tree.random_configuration((4096,), generator=torch.Generator("cuda").manual_seed(1))
    params = lt.SolverParams(**FLAGSHIP, check_interval=8)
    n0 = fused.LAUNCHES
    res = lt.solve_delta_duals(tree, params, q, problem, fused="require")
    torch.cuda.synchronize()
    assert fused.LAUNCHES == n0 + 2
    ref = lt.solve_delta_duals(tree, params, q, problem, fused=False)
    for name in ("nu", "z", "vis", "converged", "primal_infeasible", "iterations",
                 "primal_residual", "dual_residual"):
        assert torch.equal(getattr(res, name), getattr(ref, name)), name
    states_equal(res.state, ref.state)
    assert res.converged.double().mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("check_interval", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_with_per_problem_subspaces_matches_eager_loop_on_card(dtype, check_interval):
    """The mixed chain (500 UR5 + 500 panda_arm, a ragged last block): S_all
    read as data gives the eager loop's bits, and the padded joint of the UR5
    rows stays exactly zero."""
    _need_card()
    chain, params, prob, st = prepared_mixed(500, check_interval, dtype)
    assert prob.S_all.shape == (7, 6, 1, 1000)
    n0 = fused.LAUNCHES
    ker = fused.fused_solve_loop(chain, params, prob, st, batch_tile=128)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == n0 + 1
    states_equal(ker, tsm._solve_loop(chain, prob, params, st))
    states_equal(ker, tsm._solve_loop(chain, dataclasses.replace(prob, S_all=None), params, st))
    for field in ("nu", "z", "w", "stfw"):
        assert not getattr(ker, field)[6, :, :500].any(), field
    assert ker.converged.double().mean() > 0.5


@pytest.mark.cuda
def test_shared_subspaces_as_S_all_give_the_same_bits_on_card():
    _need_card()
    params = lt.SolverParams(**FLAGSHIP, check_interval=8)
    tree, prob, st = prepared(params, B=1000, device="cuda")
    S = fused._subspace_operand(tree, torch.float32)
    prob_S = dataclasses.replace(prob, S_all=S[..., None].expand(S.shape + (1000,)).contiguous())
    states_equal(fused.fused_solve_loop(tree, params, prob_S, st),
                 fused.fused_solve_loop(tree, params, prob, st))


@pytest.mark.cuda
def test_mixed_delta_duals_kernel_path_equals_eager_path_on_card():
    _need_card()
    mp, groups, params = chip_smoke.mixed_setup(lt, torch, torch.float32, 256, 4)
    qs = [q for _, q, _ in groups]
    n0 = fused.LAUNCHES
    res = mp.solve_packed(params, qs, solve_fn=lambda t, p, q, pr: lt.solve_delta_duals(
        t, p, q, pr, fused="require"))
    torch.cuda.synchronize()
    assert fused.LAUNCHES == n0 + 2
    ref = mp.solve_packed(params, qs, solve_fn=lambda t, p, q, pr: lt.solve_delta_duals(
        t, p, q, pr, fused=False))
    for field in ("nu", "z", "vis", "converged", "primal_infeasible", "iterations",
                  "primal_residual", "dual_residual"):
        assert torch.equal(getattr(res, field), getattr(ref, field)), field
    states_equal(res.state, ref.state)
    assert not res.nu[:256, 6].any()


@pytest.mark.cuda
def test_tracking_ticks_on_card_equal_eager_ticks():
    """Warm ticks: each launch takes the previous launch's state; one launch
    per tick, through track_scan and through solve_tracking."""
    _need_card()
    tree, links, problem, params, q = chip_smoke.config(
        lt, torch, "flagship", torch.float32, torch.device("cuda"), 512, 1)
    params = params.replace(tol_abs=1e-4, tol_rel=1e-4, warm_start=True)
    T = 6
    b_seq = torch.zeros((T, 6), device="cuda")
    b_seq[:, 2] = 0.2 * torch.cos(2 * torch.pi * torch.arange(T, device="cuda") / T)
    kern = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")
    n0 = fused.LAUNCHES
    got = kern.track_scan(q, b_seq)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == n0 + T
    want = lt.DiffIkSolver(tree, params, links, problem=problem, fused=False).track_scan(q, b_seq)
    states_equal(got.state, want.state)
    ticker = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")
    for t in range(T):
        res = ticker.solve_tracking(q, links[0], b=b_seq[t])
        assert torch.equal(res.nu, got.nu[t]) and torch.equal(res.nu, want.nu[t])
        assert torch.equal(res.iterations, want.iterations[t])
    assert fused.LAUNCHES == n0 + 2 * T


@pytest.mark.cuda
def test_kernel_refuses_S_all_outside_the_one_dof_instantiation():
    _need_card()
    tree, params, prob, st = prepared_path("solo12", 64, 4, device="cuda")
    bad = dataclasses.replace(prob, S_all=torch.zeros((13, 6, 6, 64), device="cuda"))
    with pytest.raises(ValueError, match="S_all is taken for chains"):
        fused.fused_solve_loop(tree, params, bad, st)


@pytest.mark.cuda
def test_kernel_rejects_operands_on_another_device():
    _need_card()
    params = lt.SolverParams(**FLAGSHIP)
    tree, prob, st = prepared(params, B=64, device="cuda")
    with pytest.raises(ValueError, match="expected torch.float32 on cuda"):
        fused.fused_solve_loop(tree, params, dataclasses.replace(prob, b=prob.b.cpu()), st)
