"""Static solver hyper-parameters.

The reference configures via 16 constructor args + setters
(loik-loid-optimized.hpp:129-162, task-solver-base.hpp:105-141).  Here they
are a frozen, hashable dataclass; per-problem dynamic state (mu adaptation)
lives in SolverState instead.  Field for field the same as
`loik_tpu.params`, which this package cannot import (that package imports
jax at import time).
"""

from __future__ import annotations

import dataclasses
import enum


class MuUpdateStrat(enum.IntEnum):
    """ADMM penalty update strategies (task-solver-base.hpp:13-18).

    Only DEFAULT is implemented — matching the reference, where OSQP and
    MAXEIGENVALUE are declared but throw (loik-loid.hxx:393-398)."""

    DEFAULT = 0
    OSQP = 1
    MAXEIGENVALUE = 3


@dataclasses.dataclass(frozen=True)
class SolverParams:
    max_iter: int = 100
    tol_abs: float = 1e-3
    tol_rel: float = 1e-3
    tol_primal_inf: float = 1e-2
    tol_dual_inf: float = 1e-2
    rho: float = 1e-5
    mu: float = 1e-2                      # initial ADMM penalty (mu0)
    mu_equality_scale_factor: float = 1e4
    mu_update_strat: MuUpdateStrat = MuUpdateStrat.DEFAULT
    tol_tail_solve: float = 1e-1
    warm_start: bool = False
    keep_mu_on_warm_start: bool = False  # carry adapted mu across warm solves
                                         # (reference always resets to mu0,
                                         # task-solver-base.hpp:82)
    logging: bool = False                 # return per-iteration SolveInfo arrays
    verbose: bool = False                # host-visible console mode: print an
                                         # iteration banner + convergence /
                                         # infeasibility warnings (the
                                         # reference's verbose_ stream,
                                         # loik-loid.hpp:501-506, loik-loid.hxx:
                                         # 320,345,362; batched here, so the
                                         # banner reports batch aggregates).
                                         # Each banner reads the device, so it
                                         # synchronises.  Eager loop only —
                                         # like logging, refused by the fused
                                         # kernel.
    check_feasibility: bool = True       # run infeasibility certificates; the
                                         # delta-refinement stage disables them
                                         # (degenerate in delta space)
    freeze_infeasible_on_warm_start: bool = False  # keep already-infeasible
                                         # problems frozen instead of re-solving
    tail_solve: bool = True              # run InfeasibilityTailSolve after an
                                         # infeasibility certificate (converge
                                         # to the closest-feasible solution,
                                         # loik-loid-optimized.hpp:266-319);
                                         # off = freeze at detection
    check_interval: int = 1              # run convergence/infeasibility checks
                                         # every K-th ADMM iteration (OSQP's
                                         # check_termination knob).  K=1 is the
                                         # reference's per-iteration semantics.
                                         # K>1: iteration counts round up to
                                         # multiples of K, mu adapts once per
                                         # K, and the effective iteration
                                         # budget rounds max_iter down to a
                                         # multiple of K.  With logging,
                                         # skipped iterations' log slots stay
                                         # NaN (the same convention as frozen
                                         # problems).

    def __post_init__(self):
        if self.mu_update_strat != MuUpdateStrat.DEFAULT:
            raise NotImplementedError(
                "mu update strategy not yet implemented (parity with "
                "loik-loid.hxx:393-398)"
            )
        if self.check_interval < 1:
            raise ValueError(
                f"check_interval must be >= 1; got {self.check_interval}"
            )

    def replace(self, **kw) -> "SolverParams":
        return dataclasses.replace(self, **kw)
