from .mixed import (MixedPadded, prepare_mixed_padded, solve_mixed,
                    solve_mixed_padded)
from .multistart import (MultistartResult, multistart_from_configs,
                         solve_multistart, task_error)

__all__ = [
    "MultistartResult",
    "solve_multistart",
    "multistart_from_configs",
    "task_error",
    "solve_mixed",
    "solve_mixed_padded",
    "prepare_mixed_padded",
    "MixedPadded",
]
