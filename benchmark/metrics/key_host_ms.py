"""Host time per call of the graph layer's key (span ``graphs.key:<tag>``:
the inputs flattened, the key built and looked up), on the host clock in
the calls made while no profiler ran (the program's counters,
`utils.graphs.copy_stats`)."""

import spans


def read(ctx):
    return spans.step_host_ms(ctx, "key")
