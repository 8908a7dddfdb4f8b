"""Device time per call of the work before the loop that is not forward
kinematics (the program's phases ``solver.cast``, ``solver.update``,
``solver.prepare`` and ``solver.reset``: casts, the tracking tick's
constraint update, the prepared problem, the state's reset and the
kernel's working copy of it) in the profiled stretch's graph replays."""

import spans


def read(ctx):
    return spans.phase_ms(ctx, "solver.cast", "solver.update", "solver.prepare",
                          "solver.reset")
