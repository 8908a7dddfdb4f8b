"""The program's own spans, phase labels and counters in a traced stretch.

`loik_tpu_torch.utils.observability` names the steps of a call with host
spans (``api.<method>``, ``graphs.key:<tag>``, ``graphs.copy_in:<tag>``,
``graphs.replay:<tag>``, ``graphs.clone_out:<tag>``) and labels the nodes
of a captured graph by solver phase; `phase_device_us` tells a trace's
replays apart by them, and `utils.graphs.copy_stats` counts the graph
layer's copies and times its steps on the host clock in the calls made
while no profiler ran.  The readers in `metrics/` read them through this
module, per call of the profiled stretch (``ctx.trace``, ``ctx.calls``):
the host times are the untimed stretch's entry points, weighted by their
calls there, at the mean the counters give.  A program without them (an
older checkout) gives None everywhere, and so does a stretch whose
replays are not all attributed.
"""

from __future__ import annotations

import bisect
import collections
from typing import List, Optional

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# the runtime calls that launch work or copy: kernels, graphs, copies, sets
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")

# the last trace read and its split: the phase readers of one run share it
_LAST: list = [None, None]


def _observability():
    try:
        from loik_tpu_torch.utils import observability
    except ImportError:
        return None
    return observability


def phase_split(ctx):
    """`phase_device_us` of the stretch's events, or None (no such function
    in the program, no call, no replay, or a replay not attributed)."""
    if not ctx.calls or ctx.trace is None:
        return None
    if _LAST[0] is not ctx.trace:
        fn = getattr(_observability(), "phase_device_us", None)
        split = None if fn is None else fn(ctx.trace.device + ctx.trace.host)
        ok = split is not None and split.replays > 0 and split.unattributed == 0
        _LAST[:] = [ctx.trace, split if ok else None]
    return _LAST[1]


def phase_ms(ctx, *names) -> Optional[float]:
    """Device ms per call of the phases ``names`` in the stretch's replays."""
    split = phase_split(ctx)
    if split is None:
        return None
    return sum(split.us.get(n, 0.0) for n in names) / 1e3 / ctx.calls


def _spans(ctx, prefix) -> List[dict]:
    return [e for e in ctx.trace.host
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith(prefix)]


def _runtime(ctx) -> List[dict]:
    return sorted((e for e in ctx.trace.host if e.get("cat") in RUNTIME_CATS),
                  key=lambda e: float(e["ts"]))


def _inside(span, events) -> List[dict]:
    """``events`` (sorted by start) of ``span``'s thread that lie within it."""
    a = float(span["ts"])
    b = a + float(span["dur"])
    first = bisect.bisect_left(events, a, key=lambda e: float(e["ts"]))
    last = bisect.bisect_right(events, b, key=lambda e: float(e["ts"]))
    return [e for e in events[first:last] if e.get("tid") == span.get("tid")
            and float(e["ts"]) + float(e["dur"]) <= b]


def _copy_stats():
    """The program's `utils.graphs.copy_stats()`, or None without it."""
    try:
        from loik_tpu_torch.utils import graphs
    except ImportError:
        return None
    stats = getattr(graphs, "copy_stats", None)
    return None if stats is None else stats()


def _replayed(ctx) -> collections.Counter:
    """The stretch's graph calls by tag (its ``graphs.replay:<tag>`` spans)."""
    return collections.Counter(s["name"].split(":", 1)[1]
                               for s in _spans(ctx, "graphs.replay:"))


def step_host_ms(ctx, step) -> Optional[float]:
    """Host ms per call of the graph layer's ``step`` (``key``, ``copy_in``
    or ``clone_out``), read on the host clock by the program's counters in
    the calls made while no profiler ran (`copy_stats`' ``<step>_ns`` over
    ``timed``, per tag), for the graph calls of each tag that the stretch
    made.  None without such counters, a timed call of each tag or a graph
    call in the stretch."""
    if not ctx.calls or ctx.trace is None:
        return None
    stats = _copy_stats()
    calls = _replayed(ctx)
    if stats is None or not calls:
        return None
    ns = 0.0
    for tag, n in calls.items():
        v = stats.get(tag) or {}
        if not v.get("timed") or f"{step}_ns" not in v:
            return None
        ns += v[f"{step}_ns"] / v["timed"] * n
    return ns / 1e6 / ctx.calls


def host_launches(ctx) -> Optional[float]:
    """CUDA runtime (and CUDA driver) calls that launch a kernel or a graph or
    copy or set memory, inside the request spans (``api.<method>``), per
    call; a call inside another counted one is not counted again.  None
    without a request span."""
    if not ctx.calls or ctx.trace is None:
        return None
    spans = _spans(ctx, "api.")
    if not spans:
        return None
    calls = [e for e in _runtime(ctx) if any(w in e.get("name", "") for w in LAUNCH_WORDS)]
    n = 0
    for s in spans:
        end = -1.0
        for e in _inside(s, calls):
            if float(e["ts"]) >= end:
                n += 1
                end = float(e["ts"]) + float(e["dur"])
    return n / ctx.calls


def graph_copy_mb(ctx) -> Optional[float]:
    """MB copied into and cloned out of the graphs per replay, of the tags
    replayed in the stretch (``graphs.replay:<tag>``), from the program's
    counters (`utils.graphs.copy_stats`, since the process started)."""
    if ctx.trace is None:
        return None
    stats = _copy_stats()
    tags = _replayed(ctx)
    if stats is None or not tags:
        return None
    counts = [v for tag, v in stats.items() if tag in tags]
    replays = sum(v["replays"] for v in counts)
    if not replays:
        return None
    return sum(v["bytes_in"] + v["bytes_out"] for v in counts) / 1e6 / replays
