from .refine import solve_delta_duals
from .solve import fwd_pass_init, prepare_problem, solve
from .state import PreparedProblem, SolverState, SolveResult, init_state

__all__ = [
    "solve",
    "solve_delta_duals",
    "prepare_problem",
    "fwd_pass_init",
    "SolverState",
    "SolveResult",
    "PreparedProblem",
    "init_state",
]
