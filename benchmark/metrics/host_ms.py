"""Host time of a call, from the call until it returns, without waiting for
the device: mean over the traced run's window outside the profiled stretch."""


def read(ctx):
    host = ctx.window.host_ms
    return sum(host) / len(host) if host else None
