"""Device time per call of copies and sets (memcpy and memset events of the
trace): mostly the graph layer's copies of the inputs in and the outputs
out."""


def read(ctx):
    return ctx.trace.split_us()["copy"] / 1e3 / ctx.calls if ctx.calls else None
