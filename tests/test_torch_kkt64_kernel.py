"""The KKT64 kernel (loik_tpu_torch/kernels/csrc/kkt64.cu, `kernels.kkt64`)
against the plain float64 step (`solver.refine._kkt64_plain`), and the
route `refine._delta_duals` takes between them.

On the CPU: CPU tensors take the plain step and launch nothing; every
CUDA input takes the kernel, one that requires a gradient under grad mode
through an autograd function whose backward is the plain step's; the
topology table lists each joint's children in
the order `solve.kkt_residual` adds them; stage 1's prepared problem,
which the delta problem now keeps, equals the rebuild the step used to
make, bit for bit; a captured graph counts the kernel's launches per
replay; and the CUDA source, compiled for the host against
tools/rehearse/cuda_runtime.h, equals the plain step in every bit (float64
products and sums round alike on any IEEE machine once no multiply-add is
contracted) on the plan cells' robots, every constant-subspace joint type,
float32 and float64 problem leaves, shared or one per problem, two
constraints on one link, batched geometry and more constraints than the
fused loop takes; its gradient, first and second order, is the plain
step's in every bit.

The tests marked `cuda` need a CUDA device and skip without one.  This
file imports torch and numpy only, so it also runs on the machine with
the card, which has no jax:

    python -m pytest tests/test_torch_kkt64_kernel.py -m cuda --noconftest -q

There the kernel is held against the plain step in every bit at the plan
cells' batches (panda_arm B 16384, talos 4096, solo12 10240) on real
stage-1 states and on the cases above; the graphed refined solve with the
kernel gives the answers, flags and iterations of the same solve with the
plain step, the gradient through the kernel is the plain step's, and
`KKT64_LAUNCHES` rises by one a replay.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

import loik_tpu_torch as lt
import loik_tpu_torch.solver.solve  # noqa: F401  (the module; the package exports a function)
from loik_tpu_torch.kernels import fk, kkt64
from loik_tpu_torch.solver import refine
from loik_tpu_torch.utils import graphs, observability

from kkt64_fixtures import (CASES, CELLS, case, differences, prepared32, random_problem,
                            random_state, stage1, zoo)
from test_torch_graphs import fake_graphs  # noqa: F401  (the graphs' CPU stand-in)

tsm = sys.modules["loik_tpu_torch.solver.solve"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "loik_tpu_torch", "kernels", "csrc", "kkt64.cu")


def flagship(B, dtype="float32", device="cpu", seed=0):
    tree = lt.robots.panda_arm(dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    q = tree.random_configuration((B,), generator=gen)
    b = torch.tensor([[0.0, 0.0, 0.2, 0.0, 0.0, 0.0]], dtype=tree.dtype)
    problem = lt.make_problem(tree, (6,), b=b, lb=-4.0 * torch.ones(7, dtype=tree.dtype),
                              ub=4.0 * torch.ones(7, dtype=tree.dtype))
    params = lt.SolverParams(max_iter=200, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
                             mu_equality_scale_factor=1e5, tail_solve=False)
    return tree, q, problem, params


def same_result(a, b):
    """The names of a solve's results that differ in a bit."""
    names = ("nu", "z", "vis", "converged", "primal_infeasible", "iterations",
             "primal_residual", "dual_residual")
    out = [n for n in names if not torch.equal(getattr(a, n), getattr(b, n))]
    for f in dataclasses.fields(a.state):
        x, y = getattr(a.state, f.name), getattr(b.state, f.name)
        if isinstance(x, torch.Tensor) and not torch.equal(x, y):
            out.append(f"state.{f.name}")
    return out


# --------------------------------------------------------------------------- #
# the route, on the CPU
# --------------------------------------------------------------------------- #


def test_cpu_tensors_take_the_plain_step(monkeypatch):
    tree, q, problem, params = flagship(5)
    n0 = kkt64.KKT64_LAUNCHES

    def refuse(*a, **kw):
        raise AssertionError("the kernel's route on CPU tensors")

    monkeypatch.setattr(kkt64, "kkt64_step", refuse)
    res = lt.solve_delta_duals(tree, params, q, problem, fused=False)
    assert res.nu.shape == (5, 7) and bool(res.converged.any())
    assert not kkt64.on_kernel(tree, problem, res.state)
    assert kkt64.KKT64_LAUNCHES == n0


def _on_card(state_grad=False, problem_grad=False, axis_grad=False):
    """Stand-ins with the attributes `kkt64.on_kernel` reads, on a card."""
    def leaf(grad):
        return types.SimpleNamespace(requires_grad=grad, device=torch.device("cuda"))

    st = types.SimpleNamespace(**{f: leaf(state_grad and f == "fis") for f in kkt64._STATE})
    problem = types.SimpleNamespace(**{f: leaf(problem_grad and f == "b")
                                       for f in kkt64._PROBLEM})
    tree = types.SimpleNamespace(axis=leaf(axis_grad))
    return tree, problem, st


@pytest.mark.parametrize("case,grad", [
    ("none", False), ("state", True), ("problem", True), ("geometry", True),
    ("no_grad", False)])
@pytest.mark.parametrize("counted", [0, 10 ** 9])
def test_a_card_input_takes_the_kernel_with_or_without_a_gradient(case, grad, counted,
                                                                  monkeypatch):
    """A CUDA input takes the kernel, also where grad mode is on and a
    state leaf, a problem leaf or the tree's axes require a gradient: then
    it keeps an autograd record (`needs_grad`).  The route reads the input
    alone: the launch count does not move it, nor does routing move the
    count."""
    tree, problem, st = _on_card(state_grad=case in ("state", "no_grad"),
                                 problem_grad=case == "problem", axis_grad=case == "geometry")
    monkeypatch.setattr(kkt64, "KKT64_LAUNCHES", counted)
    with torch.set_grad_enabled(case != "no_grad"):
        assert kkt64.needs_grad(tree, problem, st) is grad
        assert kkt64.on_kernel(tree, problem, st)
    assert kkt64.KKT64_LAUNCHES == counted


def test_delta_duals_takes_the_route(monkeypatch):
    """`_delta_duals` runs the kernel's step where `on_kernel` says so,
    with a gradient kept through it, and the plain step elsewhere."""
    tree, q, problem, params = flagship(3)
    problem = dataclasses.replace(problem, b=problem.b.clone().requires_grad_())
    seen = []

    def standin(tree, problem, prob32, st):
        seen.append(st)
        return refine._kkt64_plain(tree, problem, prob32, st)

    monkeypatch.setattr(kkt64, "kkt64_step", standin)
    short = dict(fused=False, stage1_max_iter=4, stage2_max_iter=4)
    monkeypatch.setattr(kkt64, "on_kernel", lambda tree, problem, st: True)
    res = lt.solve_delta_duals(tree, params, q, problem, **short)
    assert len(seen) == 1 and res.nu.requires_grad
    res.nu.sum().backward()
    assert problem.b.grad is not None
    monkeypatch.setattr(kkt64, "on_kernel", lambda tree, problem, st: False)
    lt.solve_delta_duals(tree, params, q, dataclasses.replace(problem, b=problem.b.detach()),
                         **short)
    assert len(seen) == 1


def test_kernel_counts_reports_the_new_counters(monkeypatch):
    monkeypatch.setattr(kkt64, "KKT64_LAUNCHES", 17)
    counts = observability.kernel_counts()
    assert counts["launches"]["kkt64"] == 17
    assert counts["fk_plain_calls"] == fk.PLAIN_CALLS
    assert set(counts) == {"launches", "fk_plain_calls"}
    assert set(counts["launches"]) >= {"fused_admm", "fk_limi", "kkt64"}


@pytest.mark.parametrize("name", ["panda_arm", "talos", "solo12", "zoo"])
def test_child_table_lists_children_in_kkt_residual_order(name, monkeypatch):
    """Per joint, its children in the order `kkt_residual` adds their
    act_force to its slot (recorded by tagging each joint's liMi with its
    index), its type, dofs and first dof, the last constraint on its link,
    and the constraints' links."""
    tree = zoo(0) if name == "zoo" else lt.robots.get(name, "float64", device="cpu")
    N = tree.njoints
    links = (N - 1, 0, N - 1) if name == "zoo" else (N - 1, 0)
    table = kkt64._topology(tree, links).tolist()
    words, kids, con_links = table[:N * kkt64._WORDS], table[N * kkt64._WORDS:][:N], \
        table[N * kkt64._WORDS + N:]
    st = random_state(tree, 2, len(links))
    tags = torch.arange(N, dtype=torch.float32)[:, None, None, None].expand(N, 3, 3, 2)
    st = dataclasses.replace(st, liMi_R=tags.clone())
    added = {i: [] for i in range(N)}
    plain_act_force = tsm.bsp.act_force

    def act_force(R, p, f):
        child = int(R[0, 0, 0])
        added[tree.parents[child]].append(child)
        return plain_act_force(R, p, f)

    monkeypatch.setattr(tsm.bsp, "act_force", act_force)
    prob = tsm.prepare_problem(tree, random_problem(tree, links, 2, torch.float64), 2,
                               torch.float64)
    tsm.kkt_residual(tree, prob, refine._cast_state(st, torch.float64))
    assert any(len(v) > 1 for v in added.values()) is (name != "panda_arm")  # a chain
    for i in range(N):
        w = words[i * kkt64._WORDS:(i + 1) * kkt64._WORDS]
        assert w[:3] == [tree.jtypes[i], tree.nvs[i], tree.idx_v[i]]
        assert kids[w[3]:w[3] + w[4]] == added[i]
        assert added[i] == sorted(added[i], reverse=True)
        assert w[5] == max([k for k, c in enumerate(links) if c == i], default=-1)
    assert con_links == list(links)
    assert kkt64._topology(dataclasses.replace(tree, placement_p=tree.placement_p + 0.1),
                           links) is kkt64._topology(tree, links)


@pytest.mark.parametrize("name", ["panda_arm", "solo12"])
def test_stage1_problem_equals_the_rebuild(name, monkeypatch):
    """The delta problem keeps stage 1's prepared float32 problem: it equals
    `prepare_problem` run anew on the same inputs (what the step used to
    do) in every field and bit, and the refined solve built on either gives
    the same bits."""
    if name == "panda_arm":
        tree, q, problem, params = flagship(6)
    else:
        tree = lt.robots.solo12("float32", device="cpu")
        links = (0,) + tree.leaf_joints
        problem = lt.make_problem(tree, links, lb=-12.0 * torch.ones(tree.nv),
                                  ub=12.0 * torch.ones(tree.nv))
        q = tree.integrate(tree.neutral(), 0.1 * torch.randn(
            (4, tree.nv), generator=torch.Generator().manual_seed(0)))
        params = lt.SolverParams(max_iter=200, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
                                 mu_equality_scale_factor=1e5, tail_solve=False)
    plain = refine._kkt64_plain
    kept = []

    def recording(tree, problem, prob32, st):
        kept.append(prob32)
        return plain(tree, problem, prob32, st)

    def rebuilding(tree, problem, prob32, st):
        rebuilt = prepared32(tree, problem, st.vis.shape[-1])
        for f in dataclasses.fields(rebuilt):
            x, y = getattr(prob32, f.name), getattr(rebuilt, f.name)
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y), f.name
        return plain(tree, problem, rebuilt, st)

    monkeypatch.setattr(refine, "_kkt64_plain", recording)
    got = lt.solve_delta_duals(tree, params, q, problem, fused=False)
    monkeypatch.setattr(refine, "_kkt64_plain", rebuilding)
    want = lt.solve_delta_duals(tree, params, q, problem, fused=False)
    assert len(kept) == 1 and same_result(got, want) == []


def test_a_replay_counts_its_kkt64_launches(fake_graphs, monkeypatch):
    """A graph counts the launches its capture recorded (`Capture.
    launches`) into `KKT64_LAUNCHES` on every replay, as it does the other
    kernels'; the first call's warm-up launches once."""
    def standin(tree, problem, prob32, st):
        # the wrapper's count: a recorded launch per thread, else one now
        if fake_graphs.mode != "replay":
            kkt64.COUNTER.launched(fake_graphs.mode == "capture")
        return refine._kkt64_plain(tree, problem, prob32, st)

    monkeypatch.setattr(kkt64, "on_kernel", lambda tree, problem, st: True)
    monkeypatch.setattr(kkt64, "kkt64_step", standin)
    tree, q, problem, params = flagship(4)
    params = params.replace(max_iter=8)
    n0, caps = kkt64.KKT64_LAUNCHES, len(graphs.CAPTURES)
    for i in range(3):
        lt.solve_delta_duals(tree, params, q, problem, fused=False, stage1_max_iter=4,
                             stage2_max_iter=4)
        assert kkt64.KKT64_LAUNCHES == n0 + 1 + i
    assert len(graphs.CAPTURES) == caps + 1
    assert graphs.CAPTURES[-1].launches["kkt64"] == 1


# --------------------------------------------------------------------------- #
# the CUDA source, rehearsed on the host
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/kkt64.cu compiled for the host (g++, no contraction, the stub
    cuda_runtime.h of tools/rehearse/), bound by the real wrapper."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    out = str(tmp_path_factory.mktemp("kkt64") / "libkkt64_rehearsal.so")
    cmd = [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-x", "c++",
           f"-I{os.path.join(ROOT, 'tools', 'rehearse')}", "-o", out, CSRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return kkt64._bind(ctypes.CDLL(out))


@pytest.mark.parametrize("name", CASES)
def test_rehearsed_kernel_equals_the_plain_step(host_lib, name):
    """Every output of the kernel, in every bit (a ragged last block: B 45)."""
    tree, problem, st = case(name)
    B = st.vis.shape[-1]
    prob32 = prepared32(tree, problem, B)
    n0 = kkt64.KKT64_LAUNCHES
    got = kkt64.kkt64_step(tree, problem, prob32, st, lib=host_lib)
    assert differences(got, refine._kkt64_plain(tree, problem, prob32, st)) == []
    assert kkt64.KKT64_LAUNCHES == n0
    assert got[0].H_ref is prob32.H_ref and got[0].AtA is prob32.AtA


def test_rehearsed_kernel_on_a_real_stage1_state(host_lib):
    """On the state a float32 stage 1 leaves (panda_arm, B 33)."""
    tree, q, problem, params = flagship(33)
    p1 = params.replace(tol_abs=2e-5, tol_rel=2e-5, max_iter=32)
    res1, prob32 = tsm._solve_impl(tree, p1, q, problem, None, with_problem=True)
    got = kkt64.kkt64_step(tree, problem, prob32, res1.state, lib=host_lib)
    assert differences(got, refine._kkt64_plain(tree, problem, prob32, res1.state)) == []


def test_rehearsed_kernel_reads_through_strides(host_lib):
    """State and problem leaves that are views give the bits of their
    contiguous copies; a leaf with a problem axis of 1 is shared."""
    tree, problem, st = case("solo12", B=40)
    prob32 = prepared32(tree, problem, 40)
    want = kkt64.kkt64_step(tree, problem, prob32, st, lib=host_lib)
    views = dataclasses.replace(
        st, vis=st.vis.transpose(0, 1).contiguous().transpose(0, 1),
        nu=torch.zeros((st.nu.shape[0], 2 * st.nu.shape[1], 40))[:, ::2].copy_(st.nu))
    leaves = dataclasses.replace(problem, H_ref=problem.H_ref.transpose(-1, -2).contiguous()
                                 .transpose(-1, -2), b=problem.b[None])
    got = kkt64.kkt64_step(tree, leaves, prob32, views, lib=host_lib)
    assert not views.vis.is_contiguous() and not views.nu.is_contiguous()
    assert differences(got, want) == []


def test_the_kernel_refuses_what_it_does_not_take(host_lib):
    tree, problem, st = case("panda_arm", B=8)
    prob32 = prepared32(tree, problem, 8)
    with pytest.raises(ValueError, match="float32"):
        kkt64.kkt64_step(tree, problem, prob32, refine._cast_state(st, torch.float64),
                         lib=host_lib)
    with pytest.raises(ValueError, match="batch of"):
        kkt64.kkt64_step(tree, dataclasses.replace(problem, b=problem.b.expand(3, 1, 6)),
                         prob32, st, lib=host_lib)
    mobile = lt.robots.mobile_ur5("float32", device="cpu")
    with pytest.raises(ValueError, match="configuration-dependent"):
        kkt64.kkt64_step(mobile, problem, prob32, st, lib=host_lib)


# the leaves each gradient case marks, by owner
GRAD_CASES = {"state": {"st": ("liMi_R", "liMi_p", "vis", "fis", "nu", "z", "w", "Aty")},
              "problem": {"problem": ("H_ref", "v_ref", "A", "b", "lb", "ub")},
              "geometry": {"tree": ("axis",)},
              "some": {"st": ("fis", "z"), "problem": ("b",)}}


def _with_grad(tree, problem, st, marks):
    """Copies of the inputs with the named leaves as fresh leaves that
    require a gradient; (tree, problem, state, those leaves)."""
    owners = {"tree": tree, "problem": problem, "st": st}
    leaves = []
    for owner, names in marks.items():
        new = {n: getattr(owners[owner], n).detach().clone().requires_grad_() for n in names}
        leaves += new.values()
        owners[owner] = dataclasses.replace(owners[owner], **new)
    return owners["tree"], owners["problem"], owners["st"], leaves


def _weighted(out, seed=3):
    """A scalar of every output of the step, each weighted at random."""
    prob_d, st_d, fdpa_hat = out
    gen = torch.Generator(device=fdpa_hat.device).manual_seed(seed)
    xs = ([getattr(prob_d, n) for n in kkt64._PROBLEM_OUT]
          + [getattr(st_d, n) for n in kkt64._STATE_OUT] + [fdpa_hat])
    return sum((x * torch.randn(x.shape, generator=gen, device=x.device)).sum() for x in xs)


def _gradients(step, name, marks, device="cpu", B=45, order=1):
    """The step's gradient (``order`` 2: the gradient of the squared
    gradient's sum, through ``create_graph``) in the marked leaves."""
    tree, problem, st = case(name, device, B)
    prob32 = prepared32(tree, problem, B)
    tree, problem, st, leaves = _with_grad(tree, problem, st, marks)
    grads = torch.autograd.grad(_weighted(step(tree, problem, prob32, st)), leaves,
                                create_graph=order == 2, allow_unused=True)
    if order == 2:
        used = [g for g in grads if g is not None and g.requires_grad]
        grads = torch.autograd.grad(sum((g * g).sum() for g in used), leaves,
                                    allow_unused=True)
    return grads


def _same_gradients(got, want):
    return [i for i, (g, w) in enumerate(zip(got, want))
            if (g is None) != (w is None)
            or (g is not None and not (g.dtype == w.dtype and torch.equal(g, w)))]


@pytest.mark.parametrize("marks", list(GRAD_CASES))
@pytest.mark.parametrize("name", ["solo12", "zoo_two_on_one_link", "float64_batched"])
def test_rehearsed_kernel_gradient_equals_the_plain_step(host_lib, name, marks):
    """Through the kernel (`kkt64._Step`), the gradient in every leaf the
    kernel reads is the plain step's, bit for bit, and the forward is one
    launch of the source."""
    def kernel(*a):
        return kkt64.kkt64_step(*a, lib=host_lib)

    got = _gradients(kernel, name, GRAD_CASES[marks])
    want = _gradients(refine._kkt64_plain, name, GRAD_CASES[marks])
    assert any(g is not None for g in want)
    assert _same_gradients(got, want) == []


def test_rehearsed_kernel_second_derivative_equals_the_plain_step(host_lib):
    """A gradient taken with ``create_graph`` is differentiable again, as
    the plain step's is, and gives its bits."""
    def kernel(*a):
        return kkt64.kkt64_step(*a, lib=host_lib)

    marks = {"st": ("liMi_R", "fis", "vis"), "problem": ("H_ref", "A")}
    got = _gradients(kernel, "solo12", marks, order=2)
    want = _gradients(refine._kkt64_plain, "solo12", marks, order=2)
    assert any(g is not None for g in want)
    assert _same_gradients(got, want) == []


def test_the_route_keeps_a_record_only_where_a_gradient_is_asked(host_lib):
    """Without a leaf that requires a gradient, or under no_grad, the
    launch keeps no autograd record."""
    tree, problem, st = case("panda_arm", B=16)
    prob32 = prepared32(tree, problem, 16)
    assert kkt64.kkt64_step(tree, problem, prob32, st, lib=host_lib)[2].grad_fn is None
    tree, problem, st, _ = _with_grad(tree, problem, st, {"problem": ("b",)})
    out = kkt64.kkt64_step(tree, problem, prob32, st, lib=host_lib)
    assert out[0].b.grad_fn is not None and out[0].b.requires_grad
    with torch.no_grad():
        assert kkt64.kkt64_step(tree, problem, prob32, st, lib=host_lib)[0].b.grad_fn is None


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python -m pytest tests/test_torch_kkt64_kernel.py -m cuda --noconftest`")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CELLS))
def test_kernel_matches_the_plain_step_on_card(name):
    """At the plan cells' robots, problems and batches, on the state their
    float32 stage 1 leaves: every output in every bit, one launch."""
    _need_card()
    tree, problem, prob32, st = stage1(name)
    n0 = kkt64.KKT64_LAUNCHES
    got = kkt64.kkt64_step(tree, problem, prob32, st)
    want = refine._kkt64_plain(tree, problem, prob32, st)
    torch.cuda.synchronize()
    assert kkt64.KKT64_LAUNCHES == n0 + 1
    assert differences(got, want) == []


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("B", [45, 4096])
def test_kernel_matches_the_plain_step_on_card_cases(name, B):
    _need_card()
    tree, problem, st = case(name, "cuda", B)
    prob32 = prepared32(tree, problem, B)
    got = kkt64.kkt64_step(tree, problem, prob32, st)
    assert differences(got, refine._kkt64_plain(tree, problem, prob32, st)) == []


def _graphed(name, plain_step, monkeypatch, B=None, fused="require", links=None):
    """The benchmark's plan call (`DiffIkSolver.solve_refined`, delta duals)
    captured anew, with the kernel's step or with the plain step; (result,
    the capture)."""
    import chip_smoke

    cfg, B_cell, K = CELLS[name]
    with monkeypatch.context() as m:
        if plain_step:
            m.setattr(kkt64, "on_kernel", lambda tree, problem, st: False)
        tree, cell_links, problem, params, q = chip_smoke.config(
            lt, torch, cfg, torch.float32, torch.device("cuda"), B or B_cell, K)
        if links is not None:
            problem = lt.make_problem(tree, links, lb=problem.lb, ub=problem.ub)
        graphs.clear_graphs()
        solver = lt.DiffIkSolver(tree, params, problem.constraint_links, problem=problem,
                                 fused=fused)
        solver.solve_refined(q)
        res = solver.solve_refined(q)
        torch.cuda.synchronize()
        return res, graphs.CAPTURES[-1]


def _kkt64_nodes(cap):
    return sum(end - first for phase, first, end in cap.phases if phase == "solver.kkt64")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CELLS))
def test_graphed_solve_with_the_kernel_matches_the_plain_step(name, monkeypatch):
    """Answers, flags, iterations and the returned state equal in every
    bit; the step's phase is one node of the graph."""
    _need_card()
    want, cap_plain = _graphed(name, True, monkeypatch)
    got, cap = _graphed(name, False, monkeypatch)
    assert same_result(got, want) == []
    assert _kkt64_nodes(cap) == 1 and cap.launches["kkt64"] == 1
    assert cap_plain.launches.get("kkt64", 0) == 0 and _kkt64_nodes(cap_plain) > 100
    assert cap.nodes < cap_plain.nodes


@pytest.mark.cuda
def test_more_constraints_than_the_fused_loop_takes_on_card(monkeypatch):
    """talos with 11 constraints, above the fused loop's cap, on the eager
    loop (fused=False, WHILE nodes): the kernel's route equals the plain
    route's."""
    _need_card()
    links = tuple(range(0, 33, 3))
    want, _ = _graphed("talos", True, monkeypatch, B=256, fused=False, links=links)
    got, cap = _graphed("talos", False, monkeypatch, B=256, fused=False, links=links)
    assert same_result(got, want) == [] and cap.launches["kkt64"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("marks", list(GRAD_CASES))
def test_kernel_gradient_matches_the_plain_step_on_card(marks):
    """On the card, through `kkt64._Step`: the gradient is the plain
    step's in every bit, and the forward is one launch."""
    _need_card()
    n0 = kkt64.KKT64_LAUNCHES
    got = _gradients(kkt64.kkt64_step, "solo12", GRAD_CASES[marks], "cuda", 4096)
    torch.cuda.synchronize()
    assert kkt64.KKT64_LAUNCHES == n0 + 1
    want = _gradients(refine._kkt64_plain, "solo12", GRAD_CASES[marks], "cuda", 4096)
    assert _same_gradients(got, want) == []


@pytest.mark.cuda
def test_kkt64_launches_rise_once_per_replay():
    _need_card()
    import chip_smoke

    tree, links, problem, params, q = chip_smoke.config(
        lt, torch, "flagship", torch.float32, torch.device("cuda"), 256, 8)
    graphs.clear_graphs()
    solver = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")
    n0 = kkt64.KKT64_LAUNCHES
    for _ in range(4):
        solver.solve_refined(q)
    torch.cuda.synchronize()
    # the first call's warm-up launches once, its capture records one
    # launch, and the next three calls replay it
    assert graphs.CAPTURES[-1].launches["kkt64"] == 1
    assert kkt64.KKT64_LAUNCHES == n0 + 4
