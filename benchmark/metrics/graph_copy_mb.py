"""MB per graph replay copied into the graph's static buffers and cloned
out of it, of the entry points replayed in the profiled stretch (the
program's counters, `utils.graphs.copy_stats`)."""

import spans


def read(ctx):
    return spans.graph_copy_mb(ctx)
