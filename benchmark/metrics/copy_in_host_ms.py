"""Host time per call of the graph layer's copy-in (span
``graphs.copy_in:<tag>``: the copies into the static buffers, a new tree's
derived values, traced numbers, generator state), on the host clock in the
calls made while no profiler ran (the program's counters,
`utils.graphs.copy_stats`)."""

import spans


def read(ctx):
    return spans.step_host_ms(ctx, "copy_in")
