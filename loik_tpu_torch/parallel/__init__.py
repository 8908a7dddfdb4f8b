from .mixed import (MixedPadded, prepare_mixed_padded, solve_mixed,
                    solve_mixed_padded)

__all__ = [
    "solve_mixed",
    "solve_mixed_padded",
    "prepare_mixed_padded",
    "MixedPadded",
]
