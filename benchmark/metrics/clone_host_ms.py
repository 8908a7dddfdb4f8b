"""Host time per call of the graph layer's clone-out (span
``graphs.clone_out:<tag>``: the fresh results cloned and rebuilt), on the
host clock in the calls made while no profiler ran (the program's
counters, `utils.graphs.copy_stats`)."""

import spans


def read(ctx):
    return spans.step_host_ms(ctx, "clone_out")
