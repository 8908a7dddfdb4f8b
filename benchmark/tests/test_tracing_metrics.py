"""The readers of the program's spans, phase labels and copy counters
(`spans.py`, `metrics/fk_ms.py` ... `graph_copy_mb.py`) on a synthetic
Kineto trace of two calls, with a stand-in of the program's captures (a
kept graph that a stand-in of `graphs._list_nodes` lists) and counters:
their values, and None where a replay is not attributed or the program has
no such span, label or counter (an older checkout)."""

import types

import pytest

import devtrace
import run
import spans
from loik_tpu_torch.utils import graphs
from loik_tpu_torch.utils import observability

K, COPY = graphs.NODE_KERNEL, graphs.NODE_MEMCPY

KINDS = ((K, "void cast()"), (K, "void fk()"), (K, "void fused_admm_kernel()"), (COPY, ""),
         (K, "void res()"))
KEPT = types.SimpleNamespace(raw_cuda_graph=lambda: KINDS)
CAPTURE = graphs.Capture(
    "solve_delta_duals", 0.0, 0, 0, 2, 5,
    phases=(("solver.cast", 0, 1), ("solver.fk", 1, 2), ("solver.loop", 2, 3),
            ("solver.kkt64", 3, 4), ("solver.result", 4, 5)),
    graph=lambda: KEPT)
OPS = [("kernel", "void cast()", 1.0), ("kernel", "void fk()", 20.0),
       ("kernel", "void fused_admm_kernel()", 100.0), ("kernel", "memcpy32_post", 2.0),
       ("kernel", "void res()", 4.0)]


def call(t0, corr, ops, tid=1):
    """One request: its span, the graph layer's spans with runtime calls in
    them, the replay's launch and its device ops, and one eager kernel."""
    host = [
        dict(cat="user_annotation", name="api.solve_refined", ts=t0, dur=100, tid=tid),
        dict(cat="user_annotation", name="graphs.key:solve_delta_duals", ts=t0 + 1, dur=10,
             tid=tid),
        dict(cat="user_annotation", name="graphs.copy_in:solve_delta_duals", ts=t0 + 12,
             dur=30, tid=tid),
        dict(cat="cuda_runtime", name="cudaMemcpyAsync", ts=t0 + 13, dur=4, tid=tid,
             args=dict(correlation=corr - 1)),
        dict(cat="cuda_runtime", name="cudaMemcpyAsync", ts=t0 + 20, dur=6, tid=tid,
             args=dict(correlation=corr - 2)),
        dict(cat="user_annotation", name="graphs.replay:solve_delta_duals", ts=t0 + 43,
             dur=20, tid=tid),
        dict(cat="cuda_runtime", name="cudaGraphLaunch", ts=t0 + 44, dur=15, tid=tid,
             args=dict(correlation=corr)),
        dict(cat="user_annotation", name="graphs.clone_out:solve_delta_duals", ts=t0 + 64,
             dur=30, tid=tid),
        dict(cat="cuda_runtime", name="cudaStreamIsCapturing", ts=t0 + 65, dur=1, tid=tid),
        dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=t0 + 70, dur=5, tid=tid,
             args=dict(correlation=corr + 1)),
    ]
    dev = [dict(cat="gpu_memcpy", name="Memcpy DtoD", ts=t0 + 30, dur=1,
                args=dict(correlation=corr - 1))]
    t = t0 + 50
    for cat, name, dur in ops:
        dev.append(dict(cat=cat, name=name, ts=t, dur=dur, args=dict(correlation=corr)))
        t += dur
    dev.append(dict(cat="kernel", name="void clone()", ts=t + 5, dur=3,
                    args=dict(correlation=corr + 1)))
    return host + dev


def context(events, calls=2):
    window = types.SimpleNamespace(calls=100, seconds=1.0, host_ms=[1.0])
    return run.Context(setup_s=1.0, window=window, shape=None, launches_per_call=2,
                       trace=devtrace.Trace.from_events(events), calls=calls)


@pytest.fixture
def program(monkeypatch):
    """The program's captures and copy counters, as after a run's stretch:
    of 10 calls of the stretch's tag, 8 made off the profiler timed."""
    monkeypatch.setattr(graphs, "CAPTURES", [CAPTURE])
    monkeypatch.setattr(graphs, "_list_nodes", lambda handle: (handle, True))
    monkeypatch.setattr(graphs, "copy_stats", lambda: {
        "solve_delta_duals": dict(calls=10, replays=10, bytes_in=3_000_000,
                                  bytes_out=2_000_000, timed=8, key_ns=400_000,
                                  copy_in_ns=1_600_000, replay_ns=8_000_000,
                                  clone_out_ns=3_200_000),
        "fwd_pass_init": dict(calls=5, replays=5, bytes_in=9_000_000, bytes_out=0, timed=5,
                              key_ns=1, copy_in_ns=1, replay_ns=1, clone_out_ns=1)})


def read(name, ctx):
    return run.metric_reader(name)(ctx)


def test_values_per_call(program):
    ctx = context(call(0, 100, OPS) + call(1000, 200, OPS))
    assert read("fk_ms.plan", ctx) == pytest.approx(0.020)
    assert read("prepare_ms.plan", ctx) == pytest.approx(0.001)       # the cast
    assert read("kkt64_ms.plan", ctx) == pytest.approx(0.002)         # the copy node
    assert read("result_ms.track", ctx) == pytest.approx(0.004)
    # a graph call a call, at the timed calls' mean
    assert read("key_host_ms.plan", ctx) == pytest.approx(0.050)
    assert read("copy_in_host_ms.plan", ctx) == pytest.approx(0.200)
    assert read("clone_host_ms.track", ctx) == pytest.approx(0.400)
    # two graph calls in one request
    assert read("key_host_ms.plan", context(call(0, 100, OPS) + call(1000, 200, OPS),
                                            calls=1)) == pytest.approx(0.100)
    assert read("host_launches.plan", ctx) == 4                       # two copies, graph, kernel
    assert read("graph_copy_mb.plan", ctx) == pytest.approx(0.5)      # 5 MB over 10 replays
    split = spans.phase_split(ctx)
    # the phases account for every op of the replays and no other
    assert sum(split.us.values()) == pytest.approx(2 * sum(d for _, _, d in OPS))
    assert split.us["solver.loop"] == pytest.approx(200.0)


def test_phase_readers_give_none_unless_every_replay_is_attributed(program):
    wrong = OPS[:1] + [("kernel", "void other()", 20.0)] + OPS[2:]
    ctx = context(call(0, 100, OPS) + call(1000, 200, wrong))
    for name in ("fk_ms.plan", "prepare_ms.track", "kkt64_ms.plan", "result_ms.plan"):
        assert read(name, ctx) is None
    assert read("key_host_ms.plan", ctx) == pytest.approx(0.050)     # the counters stay
    ctx = context(call(0, 100, OPS[:-1]))                            # an op missing
    assert read("fk_ms.track", ctx) is None


def test_a_program_without_spans_labels_or_counters_gives_none(monkeypatch):
    monkeypatch.delattr(observability, "phase_device_us")
    monkeypatch.delattr(graphs, "copy_stats")
    ctx = context(call(0, 100, OPS) + call(1000, 200, OPS))
    for name in ("fk_ms.plan", "prepare_ms.plan", "kkt64_ms.plan", "result_ms.track",
                 "graph_copy_mb.plan", "key_host_ms.plan", "copy_in_host_ms.track",
                 "clone_host_ms.plan"):
        assert read(name, ctx) is None
    bare = [e for e in call(0, 100, OPS) if e["cat"] != "user_annotation"]
    ctx = context(bare, calls=1)
    for name in ("key_host_ms.plan", "copy_in_host_ms.track", "clone_host_ms.plan",
                 "host_launches.track", "graph_copy_mb.track"):
        assert read(name, ctx) is None
