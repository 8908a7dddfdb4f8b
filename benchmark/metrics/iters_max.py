"""The largest iteration count among a call's problems (both stages summed
where a call has two), mean over the profiled calls: a launch lasts as long
as its slowest problem."""


def read(ctx):
    return sum(c.max for c in ctx.iterations) / len(ctx.iterations) if ctx.iterations else None
