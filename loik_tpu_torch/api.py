"""Object-style solver API mirroring the reference's surface.

Port of `loik_tpu.api.DiffIkSolver`: construct once per (model, params,
constraint topology), then call `solve` or the tight-tolerance
`solve_refined`.  The split `solve_init`/`resolve` pair, `solve_tracking`,
`track_scan` and `reach` are not ported yet (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .params import SolverParams
from .problem import IkProblem, make_problem
from .solver import solve
from .solver.refine import solve_delta_duals
from .solver.state import SolveResult, SolverState


class DiffIkSolver:
    def __init__(self, tree, params: SolverParams,
                 constraint_links: Sequence[int],
                 problem: Optional[IkProblem] = None,
                 fused=None):
        """fused: kernel policy for `solve_refined` — None (auto: fuse when
        eligible, warn once naming the blocker otherwise), True/False to
        force, or "require" to raise when the fused kernel cannot run
        (`kernels.fused.resolve_fused`)."""
        if fused not in (None, True, False, "require"):
            raise ValueError(
                f"fused must be None, True, False, or 'require'; got {fused!r}"
            )
        self.fused = fused
        self.tree = tree
        self.params = params
        self.constraint_links = tuple(int(c) for c in constraint_links)
        self.problem = problem if problem is not None else make_problem(
            tree, self.constraint_links
        )
        self._state: Optional[SolverState] = None
        self.last_result: Optional[SolveResult] = None

    def _tensor(self, x, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)

    # ------------------------------------------------------------------ #
    def update_references(self, H_ref=None, v_ref=None):
        """UpdateReference(s) (ik-id-description.hpp:76-100)."""
        if H_ref is not None:
            self.problem = self.problem.replace(
                H_ref=self._tensor(H_ref, self.problem.H_ref))
        if v_ref is not None:
            self.problem = self.problem.replace(
                v_ref=self._tensor(v_ref, self.problem.v_ref))

    def update_eq_constraints(self, A, b):
        """UpdateEqConstraints — constraint count/links fixed at construction
        (AddEqConstraint/RemoveEqConstraint are deactivated in the reference
        too, ik-id-description.hpp:197-253)."""
        A, b = self._tensor(A, self.problem.A), self._tensor(b, self.problem.b)
        if A.shape[-3] != len(self.constraint_links):
            raise ValueError("number of equality constraints cannot change")
        self.problem = self.problem.replace(A=A, b=b)

    def update_eq_constraint(self, link: int, A=None, b=None):
        """Single-constraint update by link id (UpdateEqConstraint,
        ik-id-description-optimized.hpp:178-238)."""
        if link not in self.constraint_links:
            raise ValueError(f"no constraint at link {link}")
        slot = self.constraint_links.index(link)
        self.problem = self.problem.update_constraint(slot, A=A, b=b)

    def update_ineq_constraints(self, lb, ub):
        lb = self._tensor(lb, self.problem.lb)
        ub = self._tensor(ub, self.problem.ub)
        if lb.shape != ub.shape:
            raise ValueError("lb/ub shape mismatch")
        self.problem = self.problem.replace(lb=lb, ub=ub)

    # ------------------------------------------------------------------ #
    def solve(self, q, problem: Optional[IkProblem] = None) -> SolveResult:
        """Stand-alone solve (cold unless params.warm_start)."""
        if problem is not None:
            self.problem = problem
        res = solve(self.tree, self.params, q, self.problem,
                    self._state if self.params.warm_start else None)
        self._state = res.state
        self.last_result = res
        return res

    def solve_refined(self, q, problem: Optional[IkProblem] = None,
                      method: str = "delta", **refine_kw) -> SolveResult:
        """Tight-tolerance solve below the ~1e-5 f32 floor: the float32
        delta-duals correction with one float64 KKT evaluation
        (`solver.refine.solve_delta_duals`); on the GPU both float32 stages
        run the fused kernel under this solver's ``fused`` policy.  Keyword
        args forward to `solve_delta_duals`.  method="two-stage" is not
        ported yet (ROADMAP queue 1 item 12)."""
        if method != "delta":
            raise ValueError(
                f"method {method!r} is not ported yet; loik_tpu_torch has "
                "method='delta' (ROADMAP queue 1 item 12 has 'two-stage')"
            )
        if problem is not None:
            self.problem = problem
        refine_kw.setdefault("fused", self.fused)
        res = solve_delta_duals(
            self.tree, self.params, q, self.problem,
            warm_state=self._state if self.params.warm_start else None,
            **refine_kw,
        )
        self._state = res.state
        self.last_result = res
        return res

    # ------------------------------------------------------------------ #
    # getter parity (task-solver-base.hpp:87-141)
    # ------------------------------------------------------------------ #
    @property
    def state(self) -> Optional[SolverState]:
        return self._state

    def get_iter(self):
        return self.last_result.iterations

    def get_primal_residual(self):
        return self.last_result.primal_residual

    def get_dual_residual(self):
        return self.last_result.dual_residual

    def get_convergence_status(self):
        return self.last_result.converged

    def get_primal_infeasibility_status(self):
        return self.last_result.primal_infeasible

    def get_dual_infeasibility_status(self):
        return self.last_result.dual_infeasible

    def reset(self):
        """Drop warm-start state (Reset, task-solver-base.hpp:73-84)."""
        self._state = None
        self.last_result = None
