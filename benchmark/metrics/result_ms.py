"""Device time per call of the result's assembly and the refined solve's
recombination (the program's phase ``solver.result``) in the profiled
stretch's graph replays."""

import spans


def read(ctx):
    return spans.phase_ms(ctx, "solver.result")
