"""The FK kernel (loik_tpu_torch/kernels/csrc/fk.cu, `kernels.fk`) against
the plain FK (`KinematicTree.fwd_kinematics`), and the route
`solver.solve.fwd_pass_init` takes between them.

On the CPU: CPU tensors take the plain FK and launch nothing; an input
whose q or geometry requires a gradient under grad mode is sent to the
plain FK on the card, by its reason, whatever the counters read; a
captured graph counts the kernel's launches per replay; and the CUDA
source, compiled for the host against tools/rehearse/cuda_runtime.h,
computes every joint type, batched geometry and a strided q (the host's
sums and sines are not the card's: a few units of 2^-22).

The tests marked `cuda` need a CUDA device and skip without one.  This
file imports torch and numpy only, so it also runs on the machine with
the card, which has no jax:

    python -m pytest tests/test_torch_fk_kernel.py -m cuda --noconftest -q

There the kernel is held against the plain FK for every joint type, in
float32 and float64, at B 1, 333, 4096 and 16384 (`BUDGET_UNITS`), the
graphed refined solve with the kernel against the same solve with the
plain FK (the kernel budget: nu within 2e-5, at most 1% of the flags and
iteration counts within 1 apart), `FK_LAUNCHES` per replay, and a graph
replayed on another tree of the topology.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
import loik_tpu_torch.solver.solve  # noqa: F401  (the module; the package exports a function)
from loik_tpu_torch.kernels import fk
from loik_tpu_torch.model import tree as mtree
from loik_tpu_torch.utils import graphs, observability

from fk_fixtures import configurations, per_problem, plain, zoo
from test_torch_graphs import fake_graphs  # noqa: F401  (the graphs' CPU stand-in)

tsm = sys.modules["loik_tpu_torch.solver.solve"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "loik_tpu_torch", "kernels", "csrc", "fk.cu")


def within(got, want, units, p_units=None):
    """Each liMi entry within ``units`` of 2^-22 (float32; 2^-51 in
    float64) of the plain FK's: rotation entries absolutely, translations
    relative to max(1, |p|) and within ``p_units`` where given."""
    (R, p), (lR, lp) = got, want
    unit = 2.0 ** -22 if R.dtype == torch.float32 else 2.0 ** -51
    assert R.shape == lR.shape and p.shape == lp.shape
    assert R.is_contiguous() and p.is_contiguous()
    dR = (R - lR).abs().max().item() / unit if R.numel() else 0.0
    dp = ((p - lp).abs() / lp.abs().clamp(min=1)).max().item() / unit if p.numel() else 0.0
    assert dR <= units and dp <= (units if p_units is None else p_units), (dR, dp)


# --------------------------------------------------------------------------- #
# the route, on the CPU
# --------------------------------------------------------------------------- #


def test_cpu_tensors_take_the_plain_fk():
    tree = zoo(0, device="cpu")
    q = configurations(tree, 5)
    n0, calls0 = fk.FK_LAUNCHES, dict(fk.PLAIN_CALLS)
    R, p = tsm.fwd_pass_init(tree, q)
    want = plain(tree, q)
    assert torch.equal(R, want[0]) and torch.equal(p, want[1])
    assert not fk.on_kernel(tree, q)
    assert fk.FK_LAUNCHES == n0 and fk.PLAIN_CALLS == calls0


class OnCard:
    """The attributes of a tensor that `fk.on_kernel` reads, on a card."""

    def __init__(self, requires_grad=False):
        self.device = torch.device("cuda")
        self.requires_grad = requires_grad


@pytest.mark.parametrize("case,reason", [
    ("none", None), ("q", "q requires grad"), ("geometry", "geometry requires grad"),
    ("no_grad", None)])
@pytest.mark.parametrize("counted", [0, 10 ** 9])
def test_a_gradient_sends_a_card_input_to_the_plain_fk(case, reason, counted, monkeypatch):
    """A CUDA input takes the kernel unless grad mode is on and q or a
    geometry leaf requires a gradient; the plain calls are counted by
    reason.  The route reads the input alone: the counters' values do not
    move it."""
    tree = zoo(1, device="cpu")
    if case == "geometry":
        tree = dataclasses.replace(tree, axis=tree.axis.clone().requires_grad_())
    q = OnCard(requires_grad=case in ("q", "no_grad"))
    monkeypatch.setattr(fk, "FK_LAUNCHES", counted)
    monkeypatch.setattr(fk, "PLAIN_CALLS", {"q requires grad": counted})
    before = dict(fk.PLAIN_CALLS)
    with torch.set_grad_enabled(case != "no_grad"):
        assert fk.grad_reason(tree, q) == reason
        assert fk.on_kernel(tree, q) is (reason is None)
    after = dict(before)
    if reason is not None:
        after[reason] = after.get(reason, 0) + 1
    assert fk.PLAIN_CALLS == after and fk.FK_LAUNCHES == counted
    counts = observability.kernel_counts()
    assert counts["launches"]["fk_limi"] == counted and counts["fk_plain_calls"] == after


def test_fwd_pass_init_takes_the_route(monkeypatch):
    """`fwd_pass_init` launches where `on_kernel` says so and runs the
    plain FK elsewhere, with a gradient kept there."""
    tree = zoo(2, device="cpu")
    q = configurations(tree, 4).requires_grad_()
    seen = []
    monkeypatch.setattr(fk, "fk_limi", lambda tree, q: seen.append(q) or plain(tree, q))
    monkeypatch.setattr(fk, "on_kernel", lambda tree, q: not q.requires_grad)
    R, p = tsm.fwd_pass_init(tree, q)
    assert not seen and R.requires_grad and p.requires_grad
    R.sum().backward()
    assert q.grad is not None
    tsm.fwd_pass_init(tree, q.detach())
    assert len(seen) == 1


def test_a_replay_counts_its_fk_launches(fake_graphs, monkeypatch):
    """A graph counts the launches its capture recorded (`Capture.
    launches`) into `FK_LAUNCHES` on every replay, as it does the fused
    kernel's; the first call's warm-up launches once."""
    def standin(tree, q):
        # the wrapper's count: a recorded launch per thread, else one now
        if fake_graphs.mode != "replay":
            fk.COUNTER.launched(fake_graphs.mode == "capture")
        return plain(tree, q)

    monkeypatch.setattr(fk, "on_kernel", lambda tree, q: True)
    monkeypatch.setattr(fk, "fk_limi", standin)
    tree = lt.robots.panda_arm("float32", device="cpu")
    n0, caps = fk.FK_LAUNCHES, len(graphs.CAPTURES)
    for seed in range(3):
        q = configurations(tree, 6, seed)
        R, p = graphs.run("fk_test", tree, (), tsm.fwd_pass_init, (q,))
        want = plain(tree, q)
        assert torch.equal(R, want[0]) and torch.equal(p, want[1])
        assert fk.FK_LAUNCHES == n0 + 1 + seed
    assert len(graphs.CAPTURES) == caps + 1
    launches = graphs.CAPTURES[-1].launches
    assert launches["fk_limi"] == 1 and launches.get("fused_admm", 0) == 0


# --------------------------------------------------------------------------- #
# the CUDA source, rehearsed on the host
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/fk.cu compiled for the host (g++, no contraction, the stub
    cuda_runtime.h of tools/rehearse/), bound by the real wrapper."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    out = str(tmp_path_factory.mktemp("fk") / "libfk_rehearsal.so")
    cmd = [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-x", "c++",
           f"-I{os.path.join(ROOT, 'tools', 'rehearse')}", "-o", out, CSRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return fk._bind(ctypes.CDLL(out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["zoo0", "zoo1", "batched", "panda_arm", "talos"])
def test_rehearsed_kernel_computes_every_joint_type(host_lib, name, dtype):
    """Every joint type (the mimic pairs' members both revolute and
    prismatic), batched geometry, a ragged last block (B 333), within a
    few units of 2^-22 of the plain FK on the host."""
    B = 333
    if name.startswith("zoo"):
        tree = zoo(int(name[3:]), dtype, "cpu")
    elif name == "batched":
        tree = per_problem(lt.robots.panda_arm(str(dtype).removeprefix("torch."),
                                               device="cpu"), B)
    else:
        tree = lt.robots.get(name, str(dtype).removeprefix("torch."), device="cpu")
    if name.startswith("zoo"):
        members = {m[:2] for m in tree.mimic if m is not None}
        assert {t for pair in members for t in pair} == {mtree.REVOLUTE, mtree.PRISMATIC}
    q = configurations(tree, B)
    n0 = fk.FK_LAUNCHES
    within(fk.fk_limi(tree, q, lib=host_lib), plain(tree, q), 4)
    assert fk.FK_LAUNCHES == n0


def test_rehearsed_kernel_reads_q_and_geometry_through_strides(host_lib):
    """A q that is a strided view and geometry leaves that are views give
    the bits of their contiguous copies."""
    tree = zoo(0, torch.float32, "cpu")
    q = configurations(tree, 40)
    wide = torch.zeros((40, 3 * tree.nq), dtype=q.dtype)
    wide[:, 1::3] = q
    view = dataclasses.replace(
        tree, placement_R=tree.placement_R.transpose(-1, -2).contiguous().transpose(-1, -2))
    got = fk.fk_limi(view, wide[:, 1::3], lib=host_lib)
    want = fk.fk_limi(tree, q, lib=host_lib)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_the_kernel_refuses_what_it_does_not_take(host_lib):
    tree = lt.robots.panda_arm("float32", device="cpu")
    q = configurations(tree, 3)
    with pytest.raises(ValueError, match="float32 or float64"):
        fk.fk_limi(tree.to(dtype=torch.bfloat16), q.to(torch.bfloat16), lib=host_lib)
    with pytest.raises(ValueError, match="cast one"):
        fk.fk_limi(tree, q.double(), lib=host_lib)
    with pytest.raises(ValueError, match="expected"):
        fk.fk_limi(tree, q[:, :5], lib=host_lib)
    with pytest.raises(ValueError, match="batch of"):
        fk.fk_limi(per_problem(tree, 4), q, lib=host_lib)


def test_topology_table():
    """The kernel's topology words: type, first q index, a mimic pair's
    member types, and the float64 bits of pitch, multiplier and offset;
    one tensor per topology, so that a graph taking another tree of it
    recomputes the table as a copy onto itself (no copy from the host)."""
    tree = zoo(1, device="cpu")
    moved = dataclasses.replace(tree, placement_p=tree.placement_p + 0.1)
    assert fk._topology(moved) is fk._topology(tree)
    assert fk._topology(zoo(0, device="cpu")) is not fk._topology(tree)
    table = fk._topology(tree).numpy()
    assert table.shape == (tree.njoints, fk._WORDS)
    consts = table[:, 4:].copy().view(np.float64)
    for i, t in enumerate(tree.jtypes):
        assert tuple(table[i, :2]) == (t, tree.idx_q[i])
        assert consts[i, 0] == tree.pitches[i]
        m = tree.mimic[i]
        if m is not None:
            assert tuple(table[i, 2:4]) == m[:2] and tuple(consts[i, 1:]) == m[2:]
        else:
            assert not table[i, 2:4].any() and not consts[i, 1:].any()


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python -m pytest tests/test_torch_fk_kernel.py -m cuda --noconftest`")


# joint types whose M(q) moves no translation: liMi_p is the placement's
# translation plus its rotation times 0, exact in any order
_NO_TRANSLATION = (mtree.REVOLUTE, mtree.REVOLUTE_UNBOUNDED, mtree.SPHERICAL,
                   mtree.UNIVERSAL, mtree.SPHERICAL_ZYX)
# the budget, in units of 2^-22 (2^-51; `within`), of a rotation entry and of a
# translation: at B 1 cuBLAS runs another float32 gemm kernel than from B 333
# up (csrc/fk.cu `gemm_dot`; measured at most 0.25 units off), and it sums a
# float32 matrix times a vector in an order that changes with B (`gemv_dot`),
# so a translation that M(q) moves may differ in its last bits: a mimic pair
# chains three such products (measured at most 2.5 units at B 4096)
BUDGET_UNITS = (1, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 333, 4096, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["zoo0", "zoo1", "batched", "panda_arm", "talos"])
def test_kernel_matches_the_plain_fk_on_card(name, dtype, B):
    """Bit for bit from B 333 up: every rotation, and the translation of
    every joint whose M(q) moves none (panda_arm's and talos' liMi whole:
    talos' free-flyer root sits at the identity).  Every entry within the
    budget (in float64, and in float32 at B 16384, the card gave every
    bit: tools/fk_check.py)."""
    _need_card()
    ds = str(dtype).removeprefix("torch.")
    if name.startswith("zoo"):
        tree = zoo(int(name[3:]), dtype, "cuda")
    elif name == "batched":
        tree = per_problem(lt.robots.panda_arm(ds, device="cuda"), B)
    else:
        tree = lt.robots.get(name, ds, device="cuda")
    q = configurations(tree, B)
    n0 = fk.FK_LAUNCHES
    with tsm.full_f32_matmul():
        got = fk.fk_limi(tree, q)
        want = plain(tree, q)
    torch.cuda.synchronize()
    assert fk.FK_LAUNCHES == n0 + 1
    within(got, want, *BUDGET_UNITS)
    if B < 333:
        return
    for j, t in enumerate(tree.jtypes):
        assert torch.equal(got[0][j], want[0][j]), (j, t)
        if t in _NO_TRANSLATION or name in ("panda_arm", "talos"):
            assert torch.equal(got[1][j], want[1][j]), (j, t)


def _refined(name, B, plain_fk, monkeypatch):
    """The benchmark's plan call (`DiffIkSolver.solve_refined`, delta
    duals, the fused kernel required), captured anew, with the FK kernel
    or with the plain FK; (result, the capture)."""
    import chip_smoke

    with monkeypatch.context() as m:
        if plain_fk:
            m.setattr(fk, "on_kernel", lambda tree, q: False)
        tree, links, problem, params, q = chip_smoke.config(
            lt, torch, "flagship" if name == "panda_arm" else name, torch.float32,
            torch.device("cuda"), B, 8 if name == "panda_arm" else 1)
        graphs.clear_graphs()
        solver = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")
        solver.solve_refined(q)
        res = solver.solve_refined(q)
        torch.cuda.synchronize()
        return res, graphs.CAPTURES[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("name,B", [("panda_arm", 16384), ("talos", 4096)])
def test_graphed_solve_with_the_kernel_matches_the_plain_fk(name, B, monkeypatch):
    """The kernel budget: nu within 2e-5, at most 1% of the converged
    flags differ, iteration counts at most 1 apart.  The FK phase of the
    graph is one node."""
    _need_card()
    want, cap_plain = _refined(name, B, True, monkeypatch)
    got, cap = _refined(name, B, False, monkeypatch)
    assert (got.nu - want.nu).abs().max().item() <= 2e-5
    assert (got.converged != want.converged).double().mean().item() <= 0.01
    assert (got.iterations - want.iterations).abs().max().item() <= 1
    fk_nodes = [end - first for phase, first, end in cap.phases if phase == "solver.fk"]
    assert fk_nodes == [1] and cap.launches["fk_limi"] == 1
    assert cap_plain.launches["fk_limi"] == 0
    assert cap.nodes < cap_plain.nodes


@pytest.mark.cuda
def test_fk_launches_rise_once_per_replay():
    _need_card()
    import chip_smoke

    tree, links, problem, params, q = chip_smoke.config(
        lt, torch, "flagship", torch.float32, torch.device("cuda"), 256, 8)
    graphs.clear_graphs()
    solver = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")
    n0, f0 = fk.FK_LAUNCHES, dict(fk.PLAIN_CALLS)
    for _ in range(4):
        solver.solve_refined(q)
    torch.cuda.synchronize()
    # the first call's warm-up launches once, its capture records one
    # launch, and the next three calls replay it
    assert graphs.CAPTURES[-1].launches["fk_limi"] == 1
    assert fk.FK_LAUNCHES == n0 + 4 and fk.PLAIN_CALLS == f0


@pytest.mark.cuda
def test_a_second_tree_replays_with_its_own_placements():
    """A graph captured on one tree, replayed on a calibrated copy of the
    topology: the copy's liMi, not the first tree's (nothing baked in at
    capture), and no new capture."""
    _need_card()
    tree = lt.robots.panda_arm("float32", device="cuda")
    calibrated = dataclasses.replace(tree, placement_p=tree.placement_p + 0.01,
                                     axis=torch.nn.functional.normalize(tree.axis + 0.05, dim=-1))
    q = configurations(tree, 1000)
    graphs.clear_graphs()
    first = graphs.run("fk_test", tree, (), tsm.fwd_pass_init, (q,))
    again = graphs.run("fk_test", tree, (), tsm.fwd_pass_init, (q,))
    n = len(graphs.CAPTURES)
    other = graphs.run("fk_test", calibrated, (), tsm.fwd_pass_init, (q,))
    torch.cuda.synchronize()
    assert len(graphs.CAPTURES) == n
    for a, b in zip(again, first):
        assert torch.equal(a, b)
    with graphs.disable_graphs():
        want = fk.fk_limi(calibrated, q)
    for a, b, c in zip(other, want, first):
        assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.cuda
def test_the_kernel_refuses_on_card():
    _need_card()
    tree = lt.robots.panda_arm("float32", device="cuda")
    q = configurations(tree, 8)
    with pytest.raises(ValueError, match="cast one"):
        tsm.fwd_pass_init(tree, q.double())
    with pytest.raises(ValueError, match="float32 or float64"):
        tsm.fwd_pass_init(tree.to(dtype=torch.bfloat16), q.to(torch.bfloat16))
