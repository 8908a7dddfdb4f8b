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
from loik_tpu_torch.kernels import common, fused
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
    """The pointer order, the caps, the lane count, the shared-memory limit
    and the config struct the wrapper packs are the ones csrc/fused_admm.cu
    declares, and `frame_words` adds up the fields `loik_layout` lays out
    (the library also reports them at first load; this catches a mismatch
    without a card)."""
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
    assert f"#define LOIK_LANES {fused.LANES}" in src
    assert f"#define LOIK_NACC {fused._NACC}" in src
    assert f"#define LOIK_MAX_SMEM_BYTES {fused.MAX_SMEM_BYTES}" in src
    assert fused.MAX_SMEM_BYTES == 227 * 1024 and 32 % fused.LANES == 0
    # the frame: every LOIK_FIELD(name, words) of loik_layout, evaluated here
    layout = re.search(r"static LoikLayout loik_layout\(.*?\n\}", src, re.S).group(0)
    fields = re.findall(r"LOIK_FIELD\((\w+), (.*?)\);", layout)
    assert len(fields) == len(set(n for n, _ in fields)) == 34
    scalars = re.search(r"enum LoikScalar \{(.*?)\}", src).group(1).split(",")
    for nvs, NC, s_all in [((1,) * 7, 1, False), ((1,) * 7, 1, True),
                           ((6,) + (1,) * 12, 5, False), ((6,) + (1,) * 32, 2, False),
                           ((1,), 1, False), ((6, 3, 2), 8, False)]:
        names = dict(N=len(nvs), NC=NC, nv=sum(nvs), nd=sum(k * k for k in nvs),
                     LOIK_NACC=fused._NACC, LOIK_LANES=fused.LANES,
                     SC_COUNT=len(scalars) - 1)
        names["hw"] = max(names["N"] * 36, fused._NACC * fused.LANES)
        total = 0
        for _, words in fields:
            m = re.fullmatch(r"s_all \? (.*) : (.*)", words)
            total += eval(m.group(1 if s_all else 2) if m else words, {}, names)
        frame, block = fused.frame_words(nvs, NC, s_all)
        assert frame == total | 1, (nvs, NC, s_all)
        assert block == (0 if s_all else len(nvs) * 6 * max(nvs))


def _robot_nvs(name):
    """(dofs per joint, constraints, per-problem S) of chip_smoke.py's paths."""
    if name == "mixed":             # the padded chain of UR5 + panda_arm
        return (1,) * 7, 1, True
    tree = lt.robots.get(name, "float32", device="cpu")
    return tree.nvs, {"panda_arm": 1, "solo12": 5, "talos": 2}[name], False


# words of one problem's frame and of the block's S, counted by hand from
# the field list in the docstring of csrc/fused_admm.cu::LoikLayout
FRAME_WORDS = {
    # H 252, U+UD^-1 84, D^-1 7, p+facc 84, r 7, transforms 147, vis/fis/fdpa/Hv
    # 168, yis/Aty/Atb 18, A 36, b 6, dofs 49, Ha+D 72, sums 14+12, scalars 3
    "panda_arm": (959, 42),
    "mixed": (1001, 0),             # + S_all 42, no block copy of S
    # 13 joints, 18 dofs, D^-1 36+12, 5 constraints
    "solo12": (2089, 468),
    # 33 joints, 38 dofs, D^-1 36+32, 2 constraints
    "talos": (4193, 1188),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["panda_arm", "mixed", "solo12", "talos"])
def test_shared_memory_bytes_per_problem(name, dtype):
    nvs, NC, s_all = _robot_nvs(name)
    frame, block = fused.frame_words(nvs, NC, s_all)
    assert (frame, block) == FRAME_WORDS[name]
    size = 4 if dtype == torch.float32 else 8
    # sized by the tree, not by the caps: talos in float32 is under 17 KB
    kib = {"panda_arm": 4, "mixed": 5, "solo12": 9, "talos": 17}[name]
    assert frame * size <= kib * 1024 * (size // 4)
    assert frame % 2 == 1           # an odd stride over the banks


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["panda_arm", "mixed", "solo12", "talos"])
@pytest.mark.parametrize("batch_tile", [1, 3, 8, 64, 1024])
def test_problems_per_block_fit_the_block(name, dtype, batch_tile):
    nvs, NC, s_all = _robot_nvs(name)
    tile = fused.problems_per_block(nvs, NC, dtype, batch_tile, s_all)
    frame, block = fused.frame_words(nvs, NC, s_all)
    size = 4 if dtype == torch.float32 else 8
    assert 1 <= tile <= batch_tile
    assert tile * fused.LANES <= 1024
    assert (block + tile * frame) * size <= 227 * 1024
    # whole warps once more than a warp's worth of problems fits
    assert tile <= 4 or tile % (32 // fused.LANES) == 0
    # and no smaller than needed: one more warp of problems would not fit
    if tile < min(batch_tile, 1024 // fused.LANES) - 3:
        assert (block + (tile + 4) * frame) * size > 227 * 1024


def test_eligibility_names_a_tree_whose_problem_does_not_fit(monkeypatch):
    """No robot within the kernel's caps needs more than a block has, so the
    limit is lowered to show the refusal: by name, before any launch."""
    tree = lt.robots.talos("float32", device="cpu")
    params = lt.SolverParams(**FLAGSHIP)
    assert fused.fused_eligibility(tree, params, 8, 8, num_constraints=2) == (True, None)
    monkeypatch.setattr(fused, "MAX_SMEM_BYTES", 16 * 1024)
    ok, reason = fused.fused_eligibility(tree, params, 8, 8, num_constraints=2)
    assert not ok and "shared memory" in reason and "33 joints" in reason
    assert str((4193 + 1188) * 4) in reason
    with pytest.raises(ValueError, match="shared memory"):
        fused.resolve_fused("require", tree, params, 8, 8, num_constraints=2)
    small = lt.robots.panda_arm("float32", device="cpu")
    assert fused.fused_eligibility(small, params, 8, 8)[0]


@pytest.mark.parametrize("name", ["panda_arm", "solo12"])
def test_rehearsed_kernel_equals_eager_loop(name):
    """The CUDA source compiled for the host (tools/rehearse_kernel.py): the
    lanes of a group phase by phase in both orders, a ragged block, a warm
    tick and the delta-duals stages, bit for bit against the eager loop."""
    sys.path.insert(0, os.path.join(os.path.dirname(chip_smoke.__file__), "tools"))
    import rehearse_kernel

    if rehearse_kernel.GXX is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    lines = []
    n = rehearse_kernel.rehearse((name,), B=8, tiles=(4, 3), log=lines.append)
    assert n == len(lines) >= 17, lines


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
    # the stream's first call captures its tick: one warm-up tick, T replays
    assert fused.LAUNCHES == n0 + T + 1
    want = lt.DiffIkSolver(tree, params, links, problem=problem, fused=False).track_scan(q, b_seq)
    states_equal(got.state, want.state)
    ticker = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")
    for t in range(T):
        res = ticker.solve_tracking(q, links[0], b=b_seq[t])
        assert torch.equal(res.nu, got.nu[t]) and torch.equal(res.nu, want.nu[t])
        assert torch.equal(res.iterations, want.iterations[t])
    assert fused.LAUNCHES == n0 + 2 * T + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,batch_tile", [(1, 8), (13, 8), (1000, 12), (37, 5), (37, 3)])
@pytest.mark.parametrize("name", ["flagship", "solo12"])
def test_ragged_batches_on_card(name, B, batch_tile):
    """B = 1 and B not a multiple of the problems per block: the last block's
    empty groups are masked, the rest get the eager loop's bits."""
    _need_card()
    tree, params, prob, st = prepared_path(name, B, 4, device="cuda")
    tile = fused.problems_per_block(tree.nvs, len(prob.constraint_links),
                                    torch.float32, batch_tile)
    assert B == 1 or B % tile
    ker = fused.fused_solve_loop(tree, params, prob, st, batch_tile=batch_tile)
    torch.cuda.synchronize()
    states_equal(ker, tsm._solve_loop(tree, prob, params, st))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_groups_of_one_warp_leave_at_different_iterations_on_card(dtype):
    """Four problems share a warp (8 lanes each) and stop at different
    iterations, some of them at the cap: every group synchronises on its
    own mask, and the results are the eager loop's."""
    _need_card()
    params = lt.SolverParams(**FLAGSHIP, check_interval=1)
    tree, prob, st = prepared(params, B=64, dtype=dtype, device="cuda")
    ker = fused.fused_solve_loop(tree, params, prob, st, batch_tile=4)
    torch.cuda.synchronize()
    states_equal(ker, tsm._solve_loop(tree, prob, params, st))
    its = ker.iterations.reshape(16, 4)
    assert (its.max(1).values > its.min(1).values).all()
    assert int(ker.it) == int(ker.iterations.max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship", "mixed", "solo12", "talos"])
def test_library_reports_the_wrappers_frame_on_card(name):
    _need_card()
    import ctypes

    nvs, NC, s_all = _robot_nvs("panda_arm" if name == "flagship" else name)
    lib = common.library(fused._bind)
    cfg = fused._LoikConfig(B=1, N=len(nvs), NC=NC, nv_max=max(nvs), tile=1, check_interval=1)
    cfg.nvs[:len(nvs)] = nvs
    frame, block = ctypes.c_int(), ctypes.c_int()
    assert lib.loik_fused_admm_frame(ctypes.byref(cfg), int(s_all), ctypes.byref(frame),
                                     ctypes.byref(block)) == 0
    assert (frame.value, block.value) == fused.frame_words(nvs, NC, s_all)


@pytest.mark.cuda
def test_launch_refused_for_shared_memory_raises_on_card(monkeypatch):
    """More problems per block than the block's shared memory holds: CUDA
    refuses, and the wrapper raises with CUDA's message."""
    _need_card()
    tree, params, prob, st = prepared_path("talos", 64, 1, device="cuda")
    monkeypatch.setattr(fused, "problems_per_block", lambda *a, **k: 64)
    with pytest.raises(RuntimeError, match="launch failed: .*cuda error"):
        fused.fused_solve_loop(tree, params, prob, st)
    monkeypatch.undo()
    states_equal(fused.fused_solve_loop(tree, params, prob, st),
                 tsm._solve_loop(tree, prob, params, st))


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


def _clik_inputs(B, device):
    """panda_arm from neutral towards FK of neutral moved by 0.35 N(0, 1)
    tangent steps (seeded on the host), float32 on ``device``."""
    tree = lt.robots.panda_arm("float32", device=device)
    gen = torch.Generator().manual_seed(2)
    dq = (0.35 * torch.randn((B, tree.nv), generator=gen)).to(device)
    q0 = tree.neutral().expand(B, tree.nq).contiguous()
    _, _, oR, op = tree.fwd_kinematics(tree.integrate(q0, dq))
    return tree, q0, oR[:, 6].contiguous(), op[:, 6].contiguous()


@pytest.mark.cuda
def test_clik_ticks_on_card_equal_eager_ticks():
    """Closed-loop IK: one launch per tick, every tick's solve warm from the
    self-healed state of the last, the same bits as the eager loop's ticks."""
    _need_card()
    B, T = 1024, 6
    tree, q0, tR, tp = _clik_inputs(B, "cuda")
    params = lt.SolverParams(max_iter=200, tol_abs=1e-4, tol_rel=1e-4)
    run = dict(dt=0.1, steps=T, gain=2.0)
    n0 = fused.LAUNCHES
    got = lt.solve_clik(tree, params, q0, tR, tp, 6, fused="require", **run)
    torch.cuda.synchronize()
    # the loop's first call captures its tick: one warm-up tick, T replays
    assert fused.LAUNCHES == n0 + T + 1
    want = lt.solve_clik(tree, params, q0, tR, tp, 6, fused=False, **run)
    for name in ("q", "nu", "err_history", "pos_err", "rot_err", "reached", "converged",
                 "iterations"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    states_equal(got.state, want.state)
    assert bool(torch.isfinite(got.q).all())


@pytest.mark.cuda
def test_two_stage_stage1_on_card_equals_eager_stage1():
    """solve_two_stage: the float32 stage 1 as one launch, then the eager
    float64 stage 2; the same bits as both stages eager."""
    _need_card()
    tree = lt.robots.panda_arm("float32", device="cuda")
    problem = lt.make_problem(tree, (6,), b=np.array([[0, 0, 0.2, 0, 0, 0]]),
                              lb=-4 * np.ones(7), ub=4 * np.ones(7))
    q = tree.random_configuration((2048,), generator=torch.Generator("cuda").manual_seed(3))
    params = lt.SolverParams(**FLAGSHIP, check_interval=8)
    n0 = fused.LAUNCHES
    res = lt.solve_two_stage(tree, params, q, problem, stage1_max_iter=32, stage2_max_iter=4)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == n0 + 1
    ref = lt.solve_two_stage(tree, params, q, problem, stage1_max_iter=32, stage2_max_iter=4,
                             fused_stage1=False)
    for name in ("nu", "z", "vis", "converged", "primal_infeasible", "iterations",
                 "primal_residual", "dual_residual"):
        assert torch.equal(getattr(res, name), getattr(ref, name)), name
    assert res.nu.dtype == torch.float64


@pytest.mark.cuda
def test_multistart_delta_on_card_launches_twice_per_batch():
    _need_card()
    tree = lt.robots.panda_arm("float32", device="cuda")
    problem = lt.make_problem(tree, (6,), b=np.array([[0, 0, 0.2, 0, 0, 0]]),
                              lb=-4 * np.ones(7), ub=4 * np.ones(7))
    params = lt.SolverParams(**FLAGSHIP, check_interval=8)
    gen = torch.Generator("cuda").manual_seed(4)
    n0 = fused.LAUNCHES
    res = lt.parallel.solve_multistart(
        tree, params, problem, gen, 4096, k=8,
        solve_fn=lambda t, p, q, pr: lt.solve_delta_duals(t, p, q, pr, fused="require"))
    torch.cuda.synchronize()
    assert fused.LAUNCHES == n0 + 2
    assert res.found and bool((res.error[:-1] <= res.error[1:]).all())
    assert bool(torch.isfinite(res.error).all()) and float(res.error.max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("check_interval", [1, 8])
def test_debug_mirror_of_a_kernel_solve_at_atol_0_on_card(check_interval):
    """`utils.debug_mirror` re-runs a `solve_fused` result on the eager loop
    with logging and holds flags, iterations and both residuals to it bit
    for bit (atol 0): the logs describe the solve the kernel ran."""
    from loik_tpu_torch.kernels.fused import solve_fused
    from loik_tpu_torch.utils import debug_mirror

    _need_card()
    tree, _, problem, params, q = chip_smoke.config(
        lt, torch, "flagship", torch.float32, torch.device("cuda"), 2048, check_interval)
    n0 = fused.LAUNCHES
    res = solve_fused(tree, params, q, problem)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == n0 + 1
    mirror = debug_mirror(tree, params, q, problem, result=res, atol=0.0)
    assert fused.LAUNCHES == n0 + 1
    assert mirror.log_rp.shape == (params.max_iter, 2048) and mirror.log_rp.is_cuda
    last = mirror.log_rp.gather(0, (mirror.iterations.long() - 1)[None])[0]
    assert torch.equal(last, res.primal_residual)


@pytest.mark.cuda
def test_solve_unrolled_on_card_equals_cpu_float64():
    """The differentiable solve on the card and on the CPU copy of its
    inputs, float64: iterations equal, nu within 1e-10, and the gradient of
    sum(nu^2) with respect to q within 1e-8 relative (sin and cos of the
    kinematics round differently on the two devices)."""
    _need_card()
    outs = []
    for device in ("cuda", "cpu"):
        tree, _, problem, params, q = chip_smoke.config(
            lt, torch, "flagship", torch.float64, torch.device("cuda"), 256, 1)
        tree = tree.to(device) if device == "cpu" else tree
        problem = problem.replace(**{f: getattr(problem, f).to(device) for f in
                                     ("H_ref", "v_ref", "A", "b", "lb", "ub")})
        q = q.to(device).requires_grad_(True)
        res = lt.solve_unrolled(tree, params, q, problem, num_iters=40)
        g, = torch.autograd.grad((res.nu ** 2).sum(), q)
        outs.append((res.nu.detach().cpu(), g.cpu(), res.iterations.cpu()))
    (nu_c, g_c, it_c), (nu_h, g_h, it_h) = outs
    assert torch.equal(it_c, it_h)
    torch.testing.assert_close(nu_c, nu_h, rtol=0, atol=1e-10)
    torch.testing.assert_close(g_c, g_h, rtol=1e-8, atol=1e-10)


def _unrolled_step(order, dtype, B=256, num_iters=10):
    """(the training step of `utils.jit`'s tests on the card, its arguments,
    other arguments): the flagship task with b_z the parameter,
    check_interval 1; "first": (sum nu^2, d/d b_z, d/d q), "newton": (the
    loss, its gradient and Hessian in b_z)."""
    tree, _, problem, params, q = chip_smoke.config(
        lt, torch, "flagship", dtype, torch.device("cuda"), B, 1)
    mask = (torch.arange(6, device="cuda") == 2).to(dtype)

    def loss(qq, bz):
        prob = problem.replace(b=problem.b * (1 - mask) + bz * mask)
        return (lt.solve_unrolled(tree, params, qq, prob, num_iters=num_iters).nu ** 2).sum()

    bz = torch.full((), 0.2, dtype=dtype, device="cuda")
    if order == "first":
        def step(b, qq):
            b.requires_grad_()
            qq.requires_grad_()
            value = loss(qq, b)
            return (value,) + torch.autograd.grad(value, (b, qq))
        return step, (bz, q), (bz + 0.05, q.flip(0))

    def step(b):
        b.requires_grad_()
        value = loss(q, b)
        g, = torch.autograd.grad(value, b, create_graph=True)
        h, = torch.autograd.grad(g, b)
        return value, g, h
    return step, (bz,), (bz + 0.05,)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", ["first", "newton"])
def test_jit_training_step_on_card_equals_eager(order, dtype):
    """`utils.jit` of the differentiable solve's training step on the card:
    one capture, then replays; the first call, a replay and a replay with
    other inputs equal the same step launched eagerly, bit for bit, and a
    second call leaves the first result unchanged."""
    from loik_tpu_torch.utils import graphs

    _need_card()
    fn, args, other = _unrolled_step(order, dtype)
    step = lt.utils.jit(fn)
    n = len(graphs.CAPTURES)
    got = [step(*args), step(*args)]
    kept = [t.clone() for t in got[1]]
    got.append(step(*other))
    assert len(graphs.CAPTURES) == n + 1 and graphs.CAPTURES[-1].nodes > 0
    with graphs.disable_graphs():
        want = [step(*args), step(*other)]
    torch.cuda.synchronize()
    for g, w in zip(got, [want[0], want[0], want[1]]):
        for x, y in zip(g, w):
            assert torch.equal(x, y)
    assert all(torch.equal(a, b) for a, b in zip(got[1], kept))
    assert not torch.equal(got[1][1], got[2][1])


@pytest.mark.cuda
def test_jit_backward_runs_inside_the_capture():
    """The backward of a `utils.jit` function runs on autograd's worker
    thread, on the capturing stream: there the graph layer sees the capture
    (`graphs.capturing()`, no entry point captures a graph of its own), its
    operators land in the graph (a replay recomputes the gradient), and
    the function's graphs go when the function does."""
    import gc
    import threading

    from loik_tpu_torch.utils import graphs

    _need_card()
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 3.0

        @staticmethod
        def backward(ctx, g):
            seen.append((threading.get_ident(), graphs.capturing(), graphs._graphable([g])))
            return g * 3.0

    def fn(x):
        x.requires_grad_()
        y = (Probe.apply(x) ** 2).sum()
        return torch.autograd.grad(y, x)[0]

    step = lt.utils.jit(fn)
    x = torch.arange(4.0, device="cuda")
    n = graphs.cached_graphs()
    step(x)                                   # the warm-up, then the capture
    assert graphs.cached_graphs() == n + 1
    (_, warm_capturing, _), (tid, capturing, graphable) = seen
    assert not warm_capturing
    assert capturing and not graphable and tid != threading.get_ident()
    got = step(x + 1)                         # a replay: no Python backward
    torch.cuda.synchronize()
    assert len(seen) == 2 and torch.equal(got, 18.0 * (x + 1))
    del step, fn
    gc.collect()
    graphs.cached_graphs()                    # drains the dropped graphs
    assert graphs.cached_graphs() == n


@pytest.mark.cuda
def test_jit_traces_python_numbers_on_card():
    """`utils.jit` on the card traces Python floats as `jax.jit` does: 100
    distinct floats are one capture, every replay equals the eager call
    (`disable_graphs()`, the same 0-d float64 tensor) bit for bit, and the
    replays with new floats never make the host wait (torch's sync debug
    mode set to raise).  ``if flag:`` on a traced bool raises, naming
    ``static_argnums``; marked static, it captures once per value."""
    from loik_tpu_torch.utils import graphs

    _need_card()

    def f(x, s):
        return x / s + s * x, (x * s).sum()

    step = lt.utils.jit(f)
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(1024,)), device="cuda")
    vals = np.random.default_rng(6).uniform(0.1, 10.0, 100).tolist()
    n = len(graphs.CAPTURES)
    got = [step(x, vals[0])]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got += [step(x, s) for s in vals[1:]]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(graphs.CAPTURES) == n + 1
    with graphs.disable_graphs():
        want = [step(x, s) for s in vals]
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))

    def branch(x, flag):
        return x + 1 if flag else x - 1

    with pytest.raises(RuntimeError, match="'flag'.*static_argnums"):
        lt.utils.jit(branch)(x, True)
    g = lt.utils.jit(branch, static_argnames="flag")
    assert torch.equal(g(x, True), x + 1) and torch.equal(g(x, False), x - 1)
    assert len(graphs.CAPTURES) == n + 3
