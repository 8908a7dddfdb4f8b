"""Device time per call of every kernel that is not the fused ADMM loop:
forward kinematics, problem preparation, state reset, the float64 KKT
evaluation and the delta problem, the result's assembly."""


def read(ctx):
    return ctx.trace.split_us()["small_ops"] / 1e3 / ctx.calls if ctx.calls else None
