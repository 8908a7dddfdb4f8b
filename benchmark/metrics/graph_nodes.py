"""Nodes per call of the graphs replayed in the profiled stretch, the
WHILE nodes' bodies included (the program's counters,
`utils.graphs.copy_stats`, taken at capture): the graph layer's work a
call, which the constraints' unrolled loops multiply."""

from typing import Optional

import spans


def per_call(ctx, phase: Optional[str] = None) -> Optional[float]:
    """Nodes per call of the graphs replayed in the stretch (its
    ``graphs.replay:<tag>`` spans, each tag weighted by its replays there),
    all of them, or with ``phase`` those of that solver phase (`copy_stats`'
    ``nodes`` and ``phase_nodes``).  None without the counters (an older
    program), a replay in the stretch, or a count for each tag replayed."""
    if not ctx.calls or ctx.trace is None:
        return None
    stats = spans._copy_stats()
    calls = spans._replayed(ctx)
    if stats is None or not calls:
        return None
    total = 0
    for tag, n in calls.items():
        v = stats.get(tag) or {}
        if "nodes" not in v:
            return None
        total += n * (v["nodes"] if phase is None else v["phase_nodes"].get(phase, 0))
    return total / ctx.calls


def read(ctx):
    return per_call(ctx)
