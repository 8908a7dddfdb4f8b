"""The masked while loop (`loik_tpu_torch.utils.graphs.while_loop`), the
port's counterpart of loik_tpu's `lax.while_loop`, on the CPU.

Inside an entry point's capture the loop is a CUDA graph WHILE node: the
carry is copied into buffers of the loop's own, the body is captured once,
writes its result back into them (the log rows in place) and exposes the
next condition as a device tensor.  The CPU has no such node: the stand-in
`standin_while` of tests/test_torch_graphs.py runs the body while the
condition tensor holds, reading it out of the sight of `HostReads`.  This
"capture mode" must equal the host loop (the loop of every eager call) bit
for bit on every field of the result, logs included, after exactly as many
body executions, on panda_arm, mobile_ur5 (configuration-dependent motion
subspaces), talos_like and the mixed super-batch's chain, over check
intervals 1, 4 and 8, loop bounds 0, 1, K - 1, K and 200 (max_iter below
check_interval runs K iterations in the first body call, as in loik_tpu)
and with the tail solve on and off.  The keys of the entry points that now
capture the loop, and the loop's own contract (zero trips, a swapped or a
changed carry), close the file.
"""

import contextlib
import dataclasses
import gc
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
import loik_tpu_torch.solver.solve  # noqa: F401  (the module; the package exports a function)
from loik_tpu_torch.utils import graphs

from test_torch_graphs import HostReads, assert_bits, leaves_of, standin_while
from test_torch_graphs import fake_graphs  # noqa: F401  (a fixture)

tsm = sys.modules["loik_tpu_torch.solver.solve"]

TREES = ["panda_arm", "mobile_ur5", "talos_like", "mixed"]
B = 4


def setup(robot, dtype=torch.float32, B=B, seed=0):
    """(tree, q, problem) of ``robot`` at batch B: a heave of the end
    effector (mobile_ur5: of its arm's last joint) in a box of +-4; the
    mixed chain packs B/2 UR5 and B/2 panda_arm configurations."""
    rng = np.random.default_rng(seed)
    heave = np.array([[0, 0, 0.2, 0, 0, 0]])
    name = str(dtype).removeprefix("torch.")
    if robot == "mixed":
        groups = []
        for g in ("ur5", "panda_arm"):
            t = lt.robots.get(g, name, device="cpu")
            qg = torch.as_tensor(rng.uniform(-np.pi, np.pi, (B // 2, t.nq)), dtype=dtype)
            groups.append((t, qg, lt.make_problem(t, (t.njoints - 1,), b=heave,
                                                  lb=-4 * np.ones(t.nv), ub=4 * np.ones(t.nv))))
        mp = lt.parallel.prepare_mixed_padded([(t, B // 2, p) for t, _, p in groups])
        return mp.chain, mp.pack_q([g[1] for g in groups]), mp.problem
    tree = lt.robots.get(robot, name, device="cpu")
    link = tree.joint_names.index("wrist_3_joint") if robot == "mobile_ur5" else tree.njoints - 1
    q = torch.as_tensor(rng.uniform(-np.pi, np.pi, (B, tree.nq)), dtype=dtype)
    problem = lt.make_problem(tree, (link,), b=heave, lb=-4 * np.ones(tree.nv),
                              ub=4 * np.ones(tree.nv))
    return tree, q, problem


@contextlib.contextmanager
def capture_mode(monkeypatch):
    """This thread as inside an entry point's capture, the WHILE node
    replaced by the CPU stand-in; yields the loops the capture records."""
    monkeypatch.setattr(graphs, "_while_node", standin_while)
    graphs._INSIDE.capturing, graphs._INSIDE.loops = True, []
    try:
        yield graphs._INSIDE.loops
    finally:
        graphs._INSIDE.capturing, graphs._INSIDE.loops = False, []


def both_loops(monkeypatch, tree, params, q, problem):
    """The solve through the host loop and through the capture-mode loop:
    (host result, its body executions, captured result, its body
    executions, the capture's host reads, its loops)."""
    graphs.reset_body_executions()
    want = tsm._solve_impl(tree, params, q, problem, None)
    host_trips = graphs.body_executions()
    graphs.reset_body_executions()
    with capture_mode(monkeypatch) as loops, HostReads() as reads:
        got = tsm._solve_impl(tree, params, q, problem, None)
    return want, host_trips, got, graphs.body_executions(), reads.calls, list(loops)


def grid():
    for K in (1, 4, 8):
        for max_iter in sorted({0, 1, K - 1, K, 200}):
            yield K, max_iter


@pytest.mark.parametrize("tail", [False, True], ids=["no_tail", "tail"])
@pytest.mark.parametrize("K,max_iter", list(grid()))
@pytest.mark.parametrize("robot", TREES)
def test_capture_mode_loop_equals_host_loop(robot, K, max_iter, tail, monkeypatch):
    """Bit for bit on every field, the same body executions, no host read
    and no host data copied to the device in the captured call, one WHILE
    node recorded."""
    tree, q, problem = setup(robot)
    params = lt.SolverParams(max_iter=max_iter, tol_abs=1e-4, tol_rel=1e-4, mu=0.1,
                             mu_equality_scale_factor=1e5, check_interval=K,
                             tail_solve=tail)
    want, host_trips, got, trips, reads, loops = both_loops(monkeypatch, tree, params, q,
                                                            problem)
    assert_bits(got, want)
    assert trips == host_trips >= 1
    assert reads == []
    assert len(loops) == 1
    # the loop bound: it stops where the host loop stops, K iterations a call
    assert int(want.state.it) == K * host_trips


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("robot", TREES)
def test_capture_mode_loop_logs_rows_in_place(robot, K, monkeypatch):
    """With ``params.logging`` the body writes each log row into the
    carry's own (max_iter, B) arrays: the captured loop copies no log back,
    and its logs equal the host loop's (NaN where a problem did not run)."""
    tree, q, problem = setup(robot)
    params = lt.SolverParams(max_iter=12, tol_abs=1e-5, tol_rel=1e-5, mu=0.1,
                             mu_equality_scale_factor=1e5, check_interval=K, logging=True)
    want, host_trips, got, trips, reads, loops = both_loops(monkeypatch, tree, params, q,
                                                            problem)
    assert_bits(got, want)
    assert trips == host_trips and reads == []
    state = leaves_of(want.state)
    logs = [i for i, t in enumerate(state) if t.ndim == 2 and t.shape[0] == 12]
    assert len(logs) >= 4, "no log arrays in the state"
    copies = loops[0].copies
    assert len(copies) == len(state)
    assert all(copies[i] == 0 for i in logs)
    assert sum(copies) > 0


def test_capture_mode_loop_writes_no_input(monkeypatch):
    """The loop's buffers are its own: the state it was given is unchanged."""
    tree, q, problem = setup("panda_arm")
    params = lt.SolverParams(max_iter=40, tol_abs=1e-4, tol_rel=1e-4, check_interval=4,
                             logging=True)
    seen = {}

    def loop(tree, prob, params, st):
        seen["st"], seen["kept"] = st, [t.clone() for t in leaves_of(st)]
        return tsm._solve_loop(tree, prob, params, st)

    with capture_mode(monkeypatch):
        out = tsm._solve_impl(tree, params, q, problem, None, loop=loop)
    for a, b in zip(leaves_of(seen["st"]), seen["kept"]):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert not torch.equal(out.state.it, seen["st"].it)


def halve(x, n0=0):
    """A toy loop: halve x until its largest entry is at most 1."""
    def body(c):
        y, n = c
        return (y * 0.5, n + 1)

    return graphs.while_loop(lambda c: c[0].amax() > 1.0, body,
                             (x, torch.full((), n0, dtype=torch.int32)))


@pytest.mark.parametrize("scale,trips", [(0.5, 0), (1.0, 0), (7.0, 3), (3000.0, 12)])
def test_loop_runs_zero_or_more_trips(scale, trips, monkeypatch):
    """The condition is set before the node, so a loop whose condition is
    false at the start runs no body; otherwise as many as the host loop."""
    x = torch.full((5,), scale)
    graphs.reset_body_executions()
    want = halve(x)
    assert graphs.body_executions() == trips
    graphs.reset_body_executions()
    with capture_mode(monkeypatch):
        got = halve(x)
    assert graphs.body_executions() == trips
    assert_bits(got, want)
    assert int(got[1]) == trips


def test_loop_carry_that_swaps_buffers(monkeypatch):
    """A body that hands back one carry buffer in another's place (a swap)
    reads it before it is overwritten."""
    def run():
        def body(c):
            a, b, n = c
            return (b, a + 1.0, n + 1)

        return graphs.while_loop(lambda c: c[2] < 5, body,
                                 (torch.zeros(3), torch.ones(3), torch.zeros((), dtype=torch.int64)))

    want = run()
    with capture_mode(monkeypatch):
        got = run()
    assert_bits(got, want)


def test_loop_refuses_a_carry_that_changes(monkeypatch):
    with capture_mode(monkeypatch), pytest.raises(ValueError, match="another structure"):
        graphs.while_loop(lambda c: c.sum() < 10, lambda c: torch.cat([c, c]), torch.ones(2))


def flagship(B=6, dtype=torch.float32):
    return setup("panda_arm", dtype, B)


PLAIN = dict(max_iter=30, tol_abs=1e-4, tol_rel=1e-4, mu=0.1, mu_equality_scale_factor=1e5)


@pytest.mark.parametrize("change", ["K", "B", "max_iter"])
def test_solve_key_misses_on_what_the_loop_bakes_in(change, fake_graphs):  # noqa: F811
    """`solve`'s graph holds its WHILE node: the same shapes and statics
    replay it; a new check interval, batch or loop bound captures."""
    tree, q, problem = flagship()
    params = lt.SolverParams(**PLAIN)
    lt.solve(tree, params, q, problem)
    n = len(graphs.CAPTURES)
    lt.solve(tree, params, q.flip(0), problem.replace(b=problem.b * 2))
    assert len(graphs.CAPTURES) == n
    if change == "K":
        params = params.replace(check_interval=4)
    elif change == "B":
        q = flagship(B=8)[1]
    else:
        params = params.replace(max_iter=31)
    lt.solve(tree, params, q, problem)
    assert len(graphs.CAPTURES) == n + 1
    assert graphs.CAPTURES[-1].loops
    lt.solve(tree, params, q, problem)
    assert len(graphs.CAPTURES) == n + 1


def test_delta_refined_key_misses_on_the_input_dtype(fake_graphs):  # noqa: F811
    """`solve_delta_refined` casts its input to float32 inside the graph:
    a float64 q is another key, and its graph replays too."""
    tree, q, problem = flagship()
    params = lt.SolverParams(**PLAIN)
    n = len(graphs.CAPTURES)
    for qq in (q, q.flip(0), q.double(), q.double().flip(0)):
        lt.solve_delta_refined(tree, params, qq, problem)
    assert [c.tag for c in graphs.CAPTURES[n:]] == ["solve_delta_refined"] * 2
    assert all(len(c.loops) == 2 for c in graphs.CAPTURES[n:])


def test_multistart_key_holds_the_generator(fake_graphs):  # noqa: F811
    """A multistart graph draws from a generator of its own that takes the
    caller's generator's state before a call and hands it back after: the
    key holds whether a generator was given, not which one.  Two graphed
    calls draw the seeds of two eager calls from the same state and leave
    the generator where they do; another generator object replays too."""
    tree, _, problem = flagship()
    params = lt.SolverParams(**PLAIN)
    gen, twin = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)

    def batch(g):
        return lt.parallel.solve_multistart(tree, params, problem, g, 8, k=3)

    n = len(graphs.CAPTURES)
    got = [batch(gen), batch(gen)]
    assert len(graphs.CAPTURES) == n + 1
    with graphs.disable_graphs():
        want = [batch(twin), batch(twin)]
    assert_bits(got, want)
    assert torch.equal(gen.get_state(), twin.get_state())
    assert not torch.equal(got[0].q, got[1].q)
    assert_bits(batch(torch.Generator().manual_seed(5)), want[0])
    assert len(graphs.CAPTURES) == n + 1
    batch(None)                     # torch's default generator: another key
    assert len(graphs.CAPTURES) == n + 2


def test_multistart_with_fresh_generators_captures_once(fake_graphs):  # noqa: F811
    """A planner that seeds a new generator every call makes one capture,
    and the graph holds none of its generators."""
    tree, _, problem = flagship()
    params = lt.SolverParams(**dict(PLAIN, max_iter=4))
    n = len(graphs.CAPTURES)
    refs = []
    for seed in range(100):
        g = torch.Generator().manual_seed(seed)
        refs.append(weakref.ref(g))
        lt.parallel.solve_multistart(tree, params, problem, g, 4, k=1)
        del g
    assert len(graphs.CAPTURES) == n + 1
    gc.collect()
    assert all(r() is None for r in refs)


def test_a_tree_dropped_during_a_capture_waits_for_its_end(fake_graphs):  # noqa: F811
    """A graph is not destroyed while another is being captured (that
    releases its memory pool mid-capture): a tree whose last reference
    another thread drops inside a capture leaves its graphs waiting, and
    they go once the capture has ended."""
    q = torch.ones(4)
    old = dataclasses.replace(flagship()[0])
    graphs.run("twice", old, (), lambda x: x * 2, (q,))
    [call] = graphs._CACHE[id(old)][1].values()
    dead = weakref.ref(call.replay)             # what holds the graph
    holder, seen = [old], []
    del old, call

    def body(x):
        if graphs.capturing():
            t = threading.Thread(target=holder.clear)
            t.start()
            t.join()
            seen.append(dead() is not None)
        return x + 1

    tree = dataclasses.replace(flagship()[0])
    graphs.run("plus one", tree, (), body, (q,))
    assert seen == [True], "the dead tree's graph was destroyed during the capture"
    assert not holder and dead() is None
    assert graphs.cached_graphs() == 1
