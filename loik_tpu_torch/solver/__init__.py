from .clik import ClikResult, solve_clik
from .diff import solve_unrolled
from .refine import solve_delta_duals, solve_delta_refined, solve_two_stage
from .solve import fwd_pass_init, prepare_problem, solve, solve_from_fk
from .state import PreparedProblem, SolverState, SolveResult, init_state
from .stream import StreamResult, solve_stream

__all__ = [
    "solve",
    "solve_delta_duals",
    "solve_delta_refined",
    "solve_two_stage",
    "solve_clik",
    "solve_unrolled",
    "ClikResult",
    "solve_from_fk",
    "solve_stream",
    "StreamResult",
    "prepare_problem",
    "fwd_pass_init",
    "SolverState",
    "SolveResult",
    "PreparedProblem",
    "init_state",
]
