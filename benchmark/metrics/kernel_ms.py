"""Device time per call of the fused ADMM loop's launches."""


def read(ctx):
    us = ctx.trace.split_us()["kernel"]
    return us / 1e3 / ctx.calls if ctx.calls and ctx.trace.launches() else None
