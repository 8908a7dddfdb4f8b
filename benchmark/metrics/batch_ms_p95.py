"""95th percentile of every batch's latency in the window, from the call to
the answer ready on the device (CUDA events around each call on the idle
stream)."""

import stats


def read(ctx):
    return stats.percentile(ctx.window.latency_ms, 95)
