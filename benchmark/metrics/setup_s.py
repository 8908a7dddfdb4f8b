"""Seconds from the process's start until the measured window opens:
importing, loading the robot, building or loading the kernel library,
making the inputs and warming up (the graphs' captures)."""


def read(ctx):
    return ctx.setup_s
