"""The entry points whose graphs hold the masked while loop as a WHILE node,
replayed on the CPU through the stand-in capture of
tests/test_torch_graphs.py (`fake_graphs`): each replayed call equals the
same call run eagerly (`disable_graphs()`) bit for bit on every tensor,
after exactly as many loop body executions (`graphs.body_executions`), and
its first call (the warm-up) does too; on panda_arm, the mixed chain and
mobile_ur5 (configuration-dependent motion subspaces: the kernel refuses
it, so every solve of it is the while loop).

The tests marked `cuda` hold the real WHILE nodes to the same on a card and
skip here:

    python -m pytest tests/test_torch_while_replay.py -m cuda --noconftest -q
"""

import dataclasses
import gc
import threading

import numpy as np
import pytest
import torch

from loik_tpu_torch.utils import graphs

import loik_tpu_torch as lt

from test_torch_graphs import _need_card, assert_bits
from test_torch_graphs import fake_graphs  # noqa: F401  (a fixture)
from test_torch_while_paths import MIXED_PATHS, PATHS, inputs, run_new


def graphed_and_eager(name, robot, device="cpu", B=6):
    """(first call, replayed call, its body executions, the eager calls in
    their place, the second one's body executions).  Multistart's calls
    draw from one generator, the eager ones from its twin."""
    gen, twin = (torch.Generator(device=device).manual_seed(5) for _ in range(2))
    n0 = len(graphs.CAPTURES)
    first = run_new(name, robot, B, gen=gen, device=device)
    assert len(graphs.CAPTURES) > n0
    n1 = len(graphs.CAPTURES)
    graphs.reset_body_executions()
    got = run_new(name, robot, B, gen=gen, device=device)
    trips = graphs.body_executions()
    assert len(graphs.CAPTURES) == n1, "a repeated call must replay"
    with graphs.disable_graphs():
        want_first = run_new(name, robot, B, gen=twin, device=device)
        graphs.reset_body_executions()
        want = run_new(name, robot, B, gen=twin, device=device)
    return first, got, trips, want_first, want, graphs.body_executions()


CASES = ([(name, "panda_arm") for name in PATHS]
         + [(name, "mixed") for name in MIXED_PATHS]
         + [(name, "mobile_ur5") for name in
            ("solve", "solve_two_stage", "solve_delta_refined", "reach")])


@pytest.mark.parametrize("name,robot", CASES)
def test_graphed_equals_eager_bit_for_bit(name, robot, fake_graphs):  # noqa: F811
    first, got, trips, want_first, want, eager_trips = graphed_and_eager(name, robot)
    assert_bits(got, want)
    assert_bits(first, want_first)
    assert trips == eager_trips
    assert trips > 0 or name == "pack_q_stacked"


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize("name,robot", CASES)
def test_card_graphed_equals_eager_bit_for_bit(name, robot):
    """The real WHILE nodes: the replay equals the eagerly launched call
    bit for bit after as many body executions, and launches no kernel (the
    two-stage solve of a tree the kernel takes: one, for stage 1)."""
    _need_card()
    first, got, trips, want_first, want, eager_trips = graphed_and_eager(
        name, robot, device="cuda", B=64)
    torch.cuda.synchronize()
    assert_bits(got, want)
    assert_bits(first, want_first)
    assert trips == eager_trips
    stage1 = name == "solve_two_stage" and robot != "mobile_ur5"
    assert graphs.CAPTURES[-1].launches == int(stage1)


@pytest.mark.cuda
def test_card_while_graph_replays_after_another_capture():
    """A graph with a WHILE node replays correctly after other graphs (with
    WHILE nodes of their own) were captured in between."""
    _need_card()
    first = run_new("solve", "panda_arm", 64, device="cuda")
    run_new("solve_two_stage", "panda_arm", 64, device="cuda")
    run_new("solve", "mobile_ur5", 64, device="cuda")
    got = run_new("solve", "panda_arm", 64, device="cuda")
    with graphs.disable_graphs():
        want = run_new("solve", "panda_arm", 64, device="cuda")
    torch.cuda.synchronize()
    assert_bits(got, want)
    assert_bits(first, want)


@pytest.mark.cuda
def test_card_body_copying_host_data_raises():
    """A loop body that copies host data to the card cannot be captured: the
    entry point raises under its name, and a later good capture works, also
    when the collector frees what the failed capture left inside it."""
    _need_card()
    tree = lt.robots.panda_arm("float32", device="cuda")
    x = torch.full((8,), 100.0, device="cuda")

    def bad(x):
        return graphs.while_loop(lambda c: c.amax() > 1.0,
                                 lambda c: c * torch.tensor([0.5], device="cuda"), x)

    with pytest.raises(RuntimeError, match="h2d body: capturing the CUDA graph failed"):
        graphs.run("h2d body", tree, (), bad, (x,))

    def good(x):
        if graphs.capturing():
            gc.collect()
        return graphs.while_loop(lambda c: c.amax() > 1.0, lambda c: c * 0.5, x)

    good = graphs.run("halving body", tree, (), good, (x,))
    torch.cuda.synchronize()
    assert torch.equal(good, torch.full((8,), 100.0 / 128, device="cuda"))


@pytest.mark.cuda
def test_card_multistart_graph_advances_its_generator():
    """Each graphed batch draws what an eager batch from the same generator
    state draws, and leaves the generator where the eager call does."""
    _need_card()
    tree, _, problem, _, _ = inputs("panda_arm", 64, "cuda")
    params = lt.SolverParams(max_iter=30, tol_abs=1e-4, tol_rel=1e-4)
    gen, twin = (torch.Generator(device="cuda").manual_seed(11) for _ in range(2))
    for _ in range(3):
        got = lt.parallel.solve_multistart(tree, params, problem, gen, 64, k=4)
        with graphs.disable_graphs():
            want = lt.parallel.solve_multistart(tree, params, problem, twin, 64, k=4)
        torch.cuda.synchronize()
        assert_bits(got, want)
        assert torch.equal(gen.get_state(), twin.get_state())
    assert not np.isnan(got.error.cpu().numpy()).any()


@pytest.mark.cuda
def test_card_multistart_with_fresh_generators_captures_once():
    """A planner that seeds a new generator every call: one capture, and
    the card's reserved memory does not grow with the calls."""
    _need_card()
    tree, _, problem, _, _ = inputs("panda_arm", 64, "cuda")
    params = lt.SolverParams(max_iter=30, tol_abs=1e-4, tol_rel=1e-4)

    def batch(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return lt.parallel.solve_multistart(tree, params, problem, g, 256, k=4)

    batch(0)
    batch(1)
    n, reserved = len(graphs.CAPTURES), torch.cuda.memory_reserved()
    for seed in range(2, 102):
        got = batch(seed)
    torch.cuda.synchronize()
    assert len(graphs.CAPTURES) == n
    assert torch.cuda.memory_reserved() == reserved
    twin = torch.Generator(device="cuda").manual_seed(101)
    with graphs.disable_graphs():
        want = lt.parallel.solve_multistart(tree, params, problem, twin, 256, k=4)
    assert_bits(got, want)


@pytest.mark.cuda
def test_card_tree_dropped_by_another_thread_during_a_capture():
    """Another thread drops the last reference to a tree with graphs while
    this one captures: its graphs (and their pools) go after the capture,
    which completes and replays correctly."""
    _need_card()
    tree, q, problem, _, _ = inputs("panda_arm", 64, "cuda")
    params = lt.SolverParams(max_iter=30, tol_abs=1e-4, tol_rel=1e-4)
    other = dataclasses.replace(tree)          # another tree: graphs of its own
    lt.solve(other, params, q, problem)
    holder, held = [other], graphs.cached_graphs()
    del other

    def body(q, problem):
        if graphs.capturing():
            t = threading.Thread(target=holder.clear)
            t.start()
            t.join()
        return lt.solve(tree, params, q, problem)

    first = graphs.run("solve while a tree dies", tree, (params,), body, (q, problem))
    assert not holder and graphs.cached_graphs() == held
    got = graphs.run("solve while a tree dies", tree, (params,), body, (q, problem))
    with graphs.disable_graphs():
        want = lt.solve(tree, params, q, problem)
    torch.cuda.synchronize()
    assert_bits(first, want)
    assert_bits(got, want)
