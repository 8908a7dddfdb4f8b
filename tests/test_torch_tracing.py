"""Spans, phase labels and graph copy counters of `loik_tpu_torch`
(`utils.observability.span`, `phase`, `phase_device_us`;
`utils.graphs.copy_stats`), on the CPU.

Eager calls under `torch.profiler` (CPU activity) carry the request span
of their `DiffIkSolver` entry point, the graph layer's key span and the
solver's phases, nested and in order; with no profiler on no
`record_function` is entered.  Through the stand-in capture of
tests/test_torch_graphs.py, whose node count is here the count of aten
operators the recorded call ran, a capture's phases are contiguous,
cover every node and add none, and no graph's nodes are listed.
`phase_device_us` is held to hand-written traces over captures whose
graphs a stand-in of `graphs._list_nodes` lists, and the copy counters to
the bytes a call moves and the calls they time.
"""

import contextlib
import dataclasses
import json
import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import loik_tpu_torch as lt
import loik_tpu_torch.solver.solve  # noqa: F401  (the module; the package exports a function)
from loik_tpu_torch.utils import graphs
from loik_tpu_torch.utils import observability as obs

from tests.test_torch_graphs import (FLAGSHIP, TRACK, FakeCapture, fake_graphs,  # noqa: F401
                                     flagship, standin_loop)

tsm = sys.modules["loik_tpu_torch.solver.solve"]
refine = sys.modules["loik_tpu_torch.solver.refine"]
api = sys.modules["loik_tpu_torch.api"]

FLAGSHIP_SMALL = {**FLAGSHIP, "max_iter": 8}
TRACK_SMALL = {**TRACK, "max_iter": 8}

# the phases of each call, in order, outside one another
PHASES = {
    "solve_refined": ["solver.cast", "solver.fk", "solver.prepare", "solver.reset",
                      "solver.loop", "solver.result", "solver.kkt64", "solver.loop",
                      "solver.result"],
    "solve_tracking": ["solver.update", "solver.fk", "solver.prepare", "solver.reset",
                       "solver.loop", "solver.result"],
}
TAGS = {"solve_refined": "solve_delta_duals", "solve_tracking": "solve_tracking"}


def call(entry, tree, q, problem):
    """One call of the `DiffIkSolver` entry point ``entry``."""
    if entry == "solve_refined":
        solver = lt.DiffIkSolver(tree, lt.SolverParams(**FLAGSHIP_SMALL), (6,),
                                 problem=problem, fused=True)
        return solver.solve_refined(q, method="delta")
    solver = lt.DiffIkSolver(tree, lt.SolverParams(**TRACK_SMALL), (6,), problem=problem,
                             fused=True)
    b = torch.tensor([0.0, 0.0, 0.1, 0.0, 0.0, 0.0])
    return solver.solve_tracking(q, 6, b=b)


def user_spans(prof, tmp_path):
    """The trace's record_function events, (name, start, end), by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") == "user_annotation"]
    return sorted(out, key=lambda s: s[1])


@pytest.mark.parametrize("entry", ["solve_refined", "solve_tracking"])
def test_eager_call_emits_nested_spans_in_order(entry, tmp_path):
    tree, q, problem = flagship(B=4)
    with graphs.disable_graphs(), profile(activities=[ProfilerActivity.CPU]) as prof:
        call(entry, tree, q, problem)
    spans = user_spans(prof, tmp_path)
    requests = [s for s in spans if s[0] == f"api.{entry}"]
    assert len(requests) == 1
    _, a, b = requests[0]
    inner = [s for s in spans if s is not requests[0]]
    assert inner and all(a <= s[1] and s[2] <= b for s in inner)
    assert f"graphs.key:{TAGS[entry]}" in {s[0] for s in inner}
    phases = [s for s in inner if s[0].startswith("solver.")]
    # the phases that lie in no other phase, in time order; repeats merged
    # (the refine body's casts are two spans)
    outer = [s[0] for s in phases
             if not any(o is not s and o[1] <= s[1] and s[2] <= o[2] for o in phases)]
    merged = [n for i, n in enumerate(outer) if i == 0 or n != outer[i - 1]]
    assert merged == PHASES[entry]


def test_no_record_function_without_a_profiler(monkeypatch, fake_graphs, standin_loop):
    """Eagerly and through the graph path, with no profiler on, no span
    enters `record_function`; `span` hands back one shared null context."""
    entered = []
    real = torch.autograd.profiler.record_function.__enter__

    def counted(self):
        entered.append(self.name)
        return real(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counted)
    tree, q, problem = flagship(B=4)
    for entry in PHASES:
        with graphs.disable_graphs():
            call(entry, tree, q, problem)
        for _ in range(2):          # the capture, then a replay
            call(entry, tree, q, problem)
    assert entered == []
    assert obs.span("graphs.replay", "x") is obs.span("api.solve")
    assert isinstance(obs.span("api.solve"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("graphs.replay", "x"):
            pass
    assert entered == ["graphs.replay:x"]


class OpCount(TorchDispatchMode):
    """Counts the aten operators run inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


class CountingCapture(FakeCapture):
    """`FakeCapture` whose recorded call's nodes are its aten operators,
    counted as `graphs._capture_nodes` counts a capture's nodes."""

    def __init__(self):
        super().__init__()
        self.ops = None

    def nodes(self, stream):
        return self.ops.n if self.ops is not None else 0

    def __call__(self, device, fn, generators=()):
        self.ops = OpCount()
        try:
            with self.ops:
                replay, out, pool, _, inst, graph = super().__call__(device, fn, generators)
            return replay, out, pool, self.ops.n, inst, graph
        finally:
            self.ops = None


@pytest.mark.parametrize("entry", ["solve_refined", "solve_tracking"])
def test_capture_phases_cover_the_nodes_and_add_none(entry, monkeypatch, fake_graphs,
                                                      standin_loop):
    counting = CountingCapture()
    monkeypatch.setattr(graphs, "_capture", counting)
    monkeypatch.setattr(graphs, "_capture_nodes", counting.nodes)
    listed = []
    monkeypatch.setattr(graphs, "_list_nodes", listed.append)
    tree, q, problem = flagship(B=4)
    call(entry, tree, q, problem)
    call(entry, tree, q, problem)                   # a replay
    assert listed == []                             # a capture lists no node
    cap = graphs.CAPTURES[-1]
    assert cap.tag == TAGS[entry] and cap.nodes > 0
    names = [p[0] for p in cap.phases]
    assert cap.phases[0][1] == 0 and cap.phases[-1][2] == cap.nodes
    assert all(a[2] == b[1] and a[1] < a[2] for a, b in zip(cap.phases, cap.phases[1:]))
    assert None not in names
    # a float32 call's casts are no-ops: its cast phase records no node (the
    # float64 casts of the refined solve's plain KKT step are that phase's)
    assert set(names) == set(PHASES[entry]) - {"solver.cast"}

    # the same capture with every phase a plain null context
    graphs.clear_graphs()
    plain = lambda name: contextlib.nullcontext()       # noqa: E731
    for mod in (obs, tsm, refine, api):
        monkeypatch.setattr(mod, "phase", plain)
    call(entry, tree, q, problem)
    assert graphs.CAPTURES[-1].nodes == cap.nodes
    assert graphs.CAPTURES[-1].phases == ((None, 0, cap.nodes),)


# --------------------------------------------------------------------------- #
# phase_device_us on hand-written traces
# --------------------------------------------------------------------------- #

K, COPY, SET, WHILE = (graphs.NODE_KERNEL, graphs.NODE_MEMCPY, graphs.NODE_MEMSET,
                       graphs.NODE_CONDITIONAL)


def capture(kinds, phases, loops=(), tag="t"):
    """A capture whose kept graph `graphs._list_nodes` lists as ``kinds``
    (the `listing` fixture: a graph's handle is its kinds, each WHILE
    body's, `Loop.body`, too)."""
    kept = types.SimpleNamespace(raw_cuda_graph=lambda: kinds)
    return graphs.Capture(tag, 0.0, 0, 0, 0, len(kinds), loops, phases=phases,
                          graph=lambda: kept)


@pytest.fixture
def listing(monkeypatch):
    """Graphs listed by a stand-in, one chain each; the captures of the
    test's traces go into `graphs.CAPTURES` (yields that list)."""
    monkeypatch.setattr(graphs, "_list_nodes", lambda handle: (handle, True))
    captures = []
    monkeypatch.setattr(graphs, "CAPTURES", captures)
    yield captures


def kernel(name):
    return (K, f"void {name}()")


# fk: a kernel and a copy; loop: the fused kernel; result: a set and a kernel
CAP = capture((kernel("fk"), (COPY, ""), (5, ""), kernel("fused_admm_kernel"), (SET, ""),
               kernel("res")),
              (("solver.fk", 0, 3), ("solver.loop", 3, 4), ("solver.result", 4, 6)))


def replay(corr, t0, ops, tag="t"):
    """A launch, its replay span, and its device ops ((cat, name, dur))."""
    ev = [{"cat": "user_annotation", "name": f"graphs.replay:{tag}", "ts": t0, "dur": 5,
           "tid": 1},
          {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": t0 + 1, "dur": 3, "tid": 1,
           "args": {"correlation": corr}}]
    t = t0 + 10
    for cat, name, dur in ops:
        ev.append({"cat": cat, "name": name, "ts": t, "dur": dur,
                   "args": {"correlation": corr}})
        t += dur + 1
    return ev


GOOD = [("kernel", "void fk()", 2.0), ("gpu_memcpy", "Memcpy DtoD", 1.0),
        ("kernel", "void fused_admm_kernel()", 10.0), ("gpu_memset", "Memset", 0.5),
        ("kernel", "void res()", 3.0)]


def test_two_replays_give_the_sum(listing):
    listing.append(CAP)
    # the CUDA driver may run a copy node as a copy kernel
    as_kernel = [GOOD[0], ("kernel", "memcpy32_post", 1.0)] + GOOD[2:]
    events = replay(7, 0, GOOD) + replay(9, 100, as_kernel)
    split = obs.phase_device_us(events[::-1])
    assert split.replays == 2 and split.unattributed == 0
    assert split.us == {"solver.fk": 6.0, "solver.loop": 20.0, "solver.result": 7.0}


@pytest.mark.parametrize("ops", [
    [GOOD[0], GOOD[1], ("kernel", "void other()", 10.0)] + GOOD[3:],   # a name differs
    GOOD[:2] + GOOD[3:],                                              # an op missing
    GOOD + [("kernel", "void res()", 3.0)],                           # one too many
    [GOOD[1], GOOD[0]] + GOOD[2:],                                    # another order
    [GOOD[0], ("kernel", "void fk()", 1.0)] + GOOD[2:],               # a kernel for a copy
], ids=["name", "missing", "extra", "order", "copy"])
def test_a_replay_that_does_not_match_is_unattributed(ops, listing):
    listing.append(CAP)
    split = obs.phase_device_us(replay(7, 0, GOOD) + replay(8, 100, ops))
    assert (split.replays, split.unattributed) == (1, 1)
    assert split.us == {"solver.fk": 3.0, "solver.loop": 10.0, "solver.result": 3.5}


def test_captures_of_other_phases_that_match_alike_are_unattributed(listing):
    kinds = CAP.graph().raw_cuda_graph()
    listing[:] = [CAP, capture(kinds, (("solver.prepare", 0, 6),))]
    split = obs.phase_device_us(replay(7, 0, GOOD))
    assert (split.replays, split.unattributed) == (0, 1)
    # the replay span's tag picks the capture
    listing[:] = [CAP, capture(kinds, (("solver.prepare", 0, 6),), tag="u")]
    split = obs.phase_device_us(replay(7, 0, GOOD, tag="u"))
    assert split.replays == 1 and split.us == {"solver.prepare": 16.5}


def test_a_graph_is_listed_once_and_not_once_gone(listing, monkeypatch):
    """`graphs.node_kinds` lists a live graph on the first ask and keeps
    the answer; a graph gone before any ask, or one whose listing fails
    (a warning), leaves its replays unattributed."""
    asked = []
    monkeypatch.setattr(graphs, "_list_nodes", lambda h: asked.append(h) or (h, True))
    kinds = CAP.graph().raw_cuda_graph()
    live = capture(kinds, CAP.phases)
    gone = graphs.Capture("t", 0.0, 0, 0, 0, len(kinds), (), phases=CAP.phases,
                          graph=lambda: None)
    listing[:] = [live, gone]
    for _ in range(2):
        split = obs.phase_device_us(replay(7, 0, GOOD))
        assert (split.replays, split.unattributed) == (1, 0)
    assert asked == [kinds]
    assert graphs.node_kinds(gone) is None

    def broken(handle):
        raise RuntimeError("no listing")

    monkeypatch.setattr(graphs, "_list_nodes", broken)
    listing[:] = [capture(kinds, CAP.phases)]
    with pytest.warns(UserWarning, match="not split by phase"):
        split = obs.phase_device_us(replay(7, 0, GOOD))
    assert (split.replays, split.unattributed) == (0, 1)


@pytest.mark.parametrize("trips", [0, 1, 3])
def test_a_while_body_goes_to_the_phase_of_its_node(trips, listing):
    body = graphs.Loop(2, (), body=(kernel("step"), kernel("loik_set_condition")))
    cap = capture((kernel("fk"), kernel("loik_set_condition"), (WHILE, ""), kernel("res")),
                  (("solver.fk", 0, 1), ("solver.loop", 1, 3), ("solver.result", 3, 4)),
                  loops=(body,))
    listing.append(cap)
    ops = ([("kernel", "void fk()", 1.0), ("kernel", "void loik_set_condition()", 0.5)]
           + [("kernel", "void step()", 2.0), ("kernel", "void loik_set_condition()", 0.5)]
           * trips + [("kernel", "void res()", 1.0)])
    split = obs.phase_device_us(replay(3, 0, ops))
    assert split.replays == 1
    assert split.us == {"solver.fk": 1.0, "solver.loop": 0.5 + 2.5 * trips,
                        "solver.result": 1.0}


def test_copy_stats_count_a_held_tree_once(fake_graphs):
    tree, q, _ = flagship(B=4)
    x = torch.ones(5, 3)

    def body(tree_, x_):
        return x_ * 2.0 + tree_.joint_S(0).sum()

    def stats():
        return graphs.copy_stats().get("copy_stats_test", dict.fromkeys(graphs._STATS, 0))

    leaves = []
    graphs._flatten(tree, leaves)
    tree_bytes = graphs._bytes(leaves)
    x_bytes = out_bytes = x.numel() * x.element_size()
    graphs.run("copy_stats_test", tree, (), body, (x,))            # the capture
    s0 = stats()
    copy = dataclasses.replace(tree, placement_p=tree.placement_p + 0.01)  # the topology
    for t in (tree, copy, copy, tree):
        graphs.run("copy_stats_test", t, (), body, (x,))
    s = stats()
    assert s["replays"] - s0["replays"] == 4
    assert s["bytes_in"] - s0["bytes_in"] == 4 * x_bytes + 2 * tree_bytes
    assert s["bytes_out"] - s0["bytes_out"] == 4 * out_bytes


@pytest.mark.parametrize("entry", ["run", "scan"])
def test_copy_stats_time_the_calls_made_off_the_profiler(entry, fake_graphs):
    """Each step of a replaying call is timed on the host clock, unless a
    profiler runs or the call captured the graph."""
    tree, _, _ = flagship(B=4)
    x = torch.ones(4, 3)
    tag = f"copy_stats_{entry}"

    def one_call():
        if entry == "run":
            return graphs.run(tag, tree, (), lambda tree_, x_: x_ * 2.0, (x,))
        return graphs.scan(tag, tree, (), lambda tree_, c, x_t, consts: (c + x_t, c * 2.0),
                           torch.zeros(3), x, None, 4)

    def stats():
        return graphs.copy_stats().get(tag, dict.fromkeys(graphs._STATS, 0))

    one_call()                                      # the capture
    s0 = stats()
    assert s0["timed"] == 0 and s0["calls"] == (entry == "scan")
    for _ in range(3):
        one_call()
    with profile(activities=[ProfilerActivity.CPU]):
        one_call()
    s = stats()
    assert s["calls"] - s0["calls"] == 4
    assert s["replays"] - s0["replays"] == 4 * (4 if entry == "scan" else 1)
    assert s["timed"] == 3
    assert all(s[k] > 0 for k in ("key_ns", "copy_in_ns", "replay_ns", "clone_out_ns"))
