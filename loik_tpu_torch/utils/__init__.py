from .checkpoint import load_state, save_state
from .graphs import clear_graphs, disable_graphs
from .observability import (MirrorMismatch, Timer, debug_mirror,
                            debug_nans, no_recompile_guard, trace)

__all__ = [
    "trace",
    "debug_nans",
    "no_recompile_guard",
    "Timer",
    "debug_mirror",
    "MirrorMismatch",
    "save_state",
    "load_state",
    "disable_graphs",
    "clear_graphs",
]
