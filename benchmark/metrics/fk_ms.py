"""Device time per call of the forward kinematics (the program's phase
``solver.fk``) in the profiled stretch's graph replays."""

import spans


def read(ctx):
    return spans.phase_ms(ctx, "solver.fk")
