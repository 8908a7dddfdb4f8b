import types

import pytest

import devtrace
import run


def _events():
    # two calls: each a kernel of the loop, a small op and a copy; host spans
    k = "void fused_admm_kernel<float, 1>(...)"
    dev = [
        dict(cat="gpu_memcpy", name="Memcpy HtoD", ts=0, dur=10),
        dict(cat="kernel", name="fk", ts=10, dur=20),
        dict(cat="kernel", name=k, ts=30, dur=100),
        dict(cat="gpu_memset", name="Memset", ts=130, dur=5),
        # the host's gap between the calls: 135 .. 235
        dict(cat="gpu_memcpy", name="Memcpy HtoD", ts=235, dur=10),
        dict(cat="kernel", name="fk", ts=245, dur=20),
        dict(cat="kernel", name=k, ts=260, dur=100),        # overlaps fk by 5
    ]
    host = [
        dict(cat="user_annotation", name="bench.call", ts=0, dur=120),
        dict(cat="cpu_op", name="cudaDeviceSynchronize", ts=120, dur=100),
        dict(cat="user_annotation", name="bench.call", ts=225, dur=40),
        dict(cat="cpu_op", name="aten::copy_", ts=226, dur=5),
        dict(cat="python_function", name="other", ph="X"),   # no time: ignored
    ]
    return dev + host


def test_split_busy_span_and_launches():
    tr = devtrace.Trace.from_events(_events())
    assert tr.launches() == 2
    assert tr.split_us() == dict(kernel=200.0, small_ops=40.0, copy=25.0)
    busy, span = tr.busy_span_us()
    assert busy == pytest.approx(135 + 125)          # 0..135 and 235..360 merged
    assert span == pytest.approx(360)
    assert tr.top_ops(2)[0] == ["void fused_admm_kernel<float, 1>(...)", pytest.approx(2e-4)]


def test_idle_gaps_are_named_by_the_host():
    tr = devtrace.Trace.from_events(_events())
    gaps = tr.idle_gaps()
    assert gaps == [["cudaDeviceSynchronize", pytest.approx(100e-6)]]


def test_layer_readers_on_the_trace():
    tr = devtrace.Trace.from_events(_events())
    shape = run.Shape(nvs=[1] * 7, parents=list(range(-1, 6)), NC=1, B=16384)
    window = types.SimpleNamespace(calls=1000, seconds=1.0, host_ms=[0.5, 0.7])  # 1 ms a call
    ctx = run.Context(setup_s=1.0, window=window, shape=shape, launches_per_call=1,
                      trace=tr, calls=2,
                      iterations=[types.SimpleNamespace(max=30, total=300000, checks=40000)] * 2)
    r = {n: run.metric_reader(n + ".plan")(ctx) for n in
         ("host_ms", "copy_ms", "small_ops_ms", "kernel_ms", "iters_max", "idle_share",
          "kernel_roofline")}
    assert r["host_ms"] == pytest.approx(0.6)
    assert r["copy_ms"] == pytest.approx(0.0125)
    assert r["small_ops_ms"] == pytest.approx(0.020)
    assert r["kernel_ms"] == pytest.approx(0.100)
    assert r["iters_max"] == 30
    assert r["idle_share"] == pytest.approx(100 * (1 - 130e-6 / 1e-3))   # 130 us busy a call
    assert 0 < r["kernel_roofline"] <= 100


def test_readers_return_nothing_without_a_launch():
    tr = devtrace.Trace.from_events([dict(cat="kernel", name="fk", ts=0, dur=5)])
    ctx = run.Context(setup_s=1.0,
                      window=types.SimpleNamespace(calls=0, seconds=1.0, host_ms=[]),
                      shape=None, launches_per_call=1,
                      trace=tr, calls=1, iterations=[])
    assert run.metric_reader("kernel_ms.track")(ctx) is None
    assert run.metric_reader("kernel_roofline.track")(ctx) is None
    assert run.metric_reader("iters_max.track")(ctx) is None
    assert run.metric_reader("host_ms.track")(ctx) is None
