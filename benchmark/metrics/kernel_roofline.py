"""The fused loop's share of its roofline: the least time for the bytes and
operations the calls' iterations need at the published peaks (`roofline`),
over the device time of the launches, in percent."""

import roofline


def read(ctx):
    us = ctx.trace.split_us()["kernel"]
    if not (ctx.calls and ctx.iterations and ctx.trace.launches() and us > 0):
        return None
    s = ctx.shape
    least = sum(roofline.least_ms(s.nvs, s.parents, s.NC, s.B, ctx.launches_per_call,
                                  c.total, c.checks)[0] for c in ctx.iterations)
    return 100.0 * least / (us / 1e3)
