from . import distributed
from .mixed import (MixedPadded, prepare_mixed_padded, solve_mixed,
                    solve_mixed_padded)
from .multistart import (MultistartResult, multistart_from_configs,
                         solve_multistart, task_error)
from .sharding import (Mesh, convergence_metrics, make_mesh, shard_problem_batch,
                       solve_sharded)

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_problem_batch",
    "solve_sharded",
    "convergence_metrics",
    "MultistartResult",
    "solve_multistart",
    "multistart_from_configs",
    "task_error",
    "solve_mixed",
    "solve_mixed_padded",
    "prepare_mixed_padded",
    "MixedPadded",
    "distributed",
]
