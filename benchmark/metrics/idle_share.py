"""The device's idle share while the window's calls ran, in percent:
1 - (device busy per call x calls) / the window's length.  Busy per call is
the profiled stretch's device operations, their intervals merged, over its
calls; the calls and the length are the window's own, timed without the
profiler, whose CUPTI tracing lengthens each graph launch on the host
(1.9 ms a call of panda_arm.plan on an H100) and so would count as idle
time that no user sees.  The host's gaps between calls count as idle."""


def read(ctx):
    busy_us, _ = ctx.trace.busy_span_us()
    if not (ctx.calls and busy_us > 0 and ctx.window.calls):
        return None
    busy_s = busy_us * 1e-6 / ctx.calls * ctx.window.calls
    return 100.0 * (1.0 - busy_s / ctx.window.seconds)
