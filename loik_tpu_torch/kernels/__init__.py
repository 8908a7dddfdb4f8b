from .fused import fused_solve_loop, solve_fused

__all__ = ["fused_solve_loop", "solve_fused"]
