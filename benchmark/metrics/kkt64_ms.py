"""Device time per call of the refined solve's float64 KKT evaluation, its
scales, the delta problem and the delta state (the program's phase
``solver.kkt64``) in the profiled stretch's graph replays."""

import spans


def read(ctx):
    return spans.phase_ms(ctx, "solver.kkt64")
