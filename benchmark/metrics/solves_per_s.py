"""Problems flagged converged in every batch answered in the window, over
the window's length (host clock, from the first call to the last answer)."""


def read(ctx):
    return ctx.window.units / ctx.window.seconds
