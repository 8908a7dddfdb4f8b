"""Object-style solver API mirroring the reference's surface.

Port of `loik_tpu.api.DiffIkSolver`, the role of
`FirstOrderLoikOptimizedTpl` (loik-loid-optimized.hpp:22): construct once
per (model, params, constraint topology), then call `solve`, the
tight-tolerance `solve_refined`, the split `solve_init` / `resolve` pair,
the tailored per-tick `solve_tracking` that updates a single constraint —
the 1 kHz control-loop path (`Solve(q, c_id, Ai, bi)`,
loik-loid-optimized.hpp:596-695) — its staged form `track_scan`, or `reach`,
closed-loop position IK built on that tick.  All methods are batched.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .params import SolverParams
from .problem import IkProblem, make_problem
from .solver import solve
from .solver.clik import ClikResult, solve_clik
from .solver.refine import default_batch_tile, solve_delta_duals, solve_two_stage
from .solver.solve import _as_batch, _solve_impl, fwd_pass_init, solve_from_fk
from .solver.state import SolveResult, SolverState
from .solver.stream import StreamResult, solve_stream


class DiffIkSolver:
    def __init__(self, tree, params: SolverParams,
                 constraint_links: Sequence[int],
                 problem: Optional[IkProblem] = None,
                 fused=None):
        """fused: kernel policy for `solve_refined`, `solve_tracking`,
        `track_scan` and `reach` — None (auto: fuse when eligible, warn once
        naming the blocker otherwise), True/False to force, or "require" to
        raise when the fused kernel cannot run
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
        self._liMi = None
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
        """Stand-alone solve (cold unless params.warm_start); on CUDA
        tensors one captured CUDA graph per key, as `solver.solve`."""
        if problem is not None:
            self.problem = problem
        res = solve(self.tree, self.params, q, self.problem,
                    self._state if self.params.warm_start else None)
        self._state = res.state
        self.last_result = res
        return res

    def solve_refined(self, q, problem: Optional[IkProblem] = None,
                      method: str = "delta", **refine_kw) -> SolveResult:
        """Tight-tolerance solve below the ~1e-5 float32 floor.

        method="delta" (default): the float32 delta-duals correction with
        one float64 KKT evaluation (`solver.refine.solve_delta_duals`); on
        the GPU both float32 stages run the fused kernel.  method=
        "two-stage": float32 bulk + warm float64 tail
        (`solve_two_stage`), whose float32 stage runs the kernel where the
        tree allows it; a tree with configuration-dependent subspaces
        (universal, spherical-ZYX, mimic-pair joints) takes it for "delta"
        too, as in loik_tpu.  The solver's ``fused`` policy applies to the
        float32 stages: for two-stage None stays None (the kernel where
        eligible, silently), False stays False, True and "require" require
        the kernel.  Keyword args forward to the chosen backend."""
        if method not in ("delta", "two-stage"):
            raise ValueError(
                f"method must be 'delta' or 'two-stage'; got {method!r}")
        if problem is not None:
            self.problem = problem
        if method == "delta" and self.tree.has_q_dependent_S:
            method = "two-stage"
        if method == "delta":
            refine_kw.setdefault("fused", self.fused)
            backend = solve_delta_duals
        else:
            refine_kw.setdefault(
                "fused_stage1", None if self.fused is None else bool(self.fused))
            backend = solve_two_stage
        res = backend(
            self.tree, self.params, q, self.problem,
            warm_state=self._state if self.params.warm_start else None,
            **refine_kw,
        )
        self._state = res.state
        self.last_result = res
        return res

    def solve_init(self, q, problem: Optional[IkProblem] = None):
        """SolveInit/Solve split: freeze FK at q, then `resolve()` re-runs
        only the main loop (timing harness pattern, loik-loid-optimized.hpp:
        335-361).  FK runs ONCE here; `resolve()` reuses the cached liMi —
        like the reference, whose split exists precisely to avoid re-running
        FK.  On CUDA tensors the FK is a captured CUDA graph of its own (the
        counterpart of loik_tpu's `fwd_pass_init_jit`)."""
        from .utils import graphs

        if problem is not None:
            self.problem = problem
        tree = self.tree
        self._liMi = graphs.run("fwd_pass_init", tree, (), fwd_pass_init,
                                (_as_batch(tree, q),))

    def resolve(self) -> SolveResult:
        """Re-run only the main loop on the FK frozen by `solve_init`.

        Honors `params.warm_start` exactly like the reference's `Solve()`
        after `SolveInit()`, which runs `ik_id_data_.Reset(warm_start_)` —
        duals/primal persist across re-solves when the flag is set
        (loik-loid-optimized.hpp:368-455, loik-loid-data-optimized.hxx:
        114-127) — and threads the result state so later warm calls
        (`solve_tracking`, another `resolve`) start from it.  On CUDA
        tensors one captured CUDA graph per key (`solve_from_fk`)."""
        if self._liMi is None:
            raise RuntimeError("call solve_init first")
        res = solve_from_fk(self.tree, self.params, self._liMi[0],
                            self._liMi[1], self.problem,
                            self._state if self.params.warm_start else None)
        self._state = res.state
        self.last_result = res
        return res

    def _slot(self, link: Optional[int]) -> int:
        if link is None:
            if len(self.constraint_links) != 1:
                raise ValueError(
                    "multiple constraints; pass link= explicitly")
            link = self.constraint_links[0]
        if link not in self.constraint_links:
            raise ValueError(f"no constraint at link {link}")
        return self.constraint_links.index(link)

    def solve_tracking(self, q, link: int, A=None, b=None) -> SolveResult:
        """Per-tick tracking solve: update ONE constraint target and re-solve,
        warm-starting duals from the previous tick when params.warm_start
        (the 1 kHz path, loik-loid-optimized.hpp:596-695).  On CUDA tensors
        the tick is one launch of the fused kernel when it is eligible and
        the masked while loop (a WHILE node) otherwise; the constraint
        update, FK, prepare, reset, the launch or loop and the result run
        as one captured CUDA graph per key (`utils.graphs`, the counterpart
        of loik_tpu's `_tracking_jit`), and the call returns without
        waiting for the device (eagerly as `solver.solve` is, e.g. with
        ``params.verbose``)."""
        from .kernels.fused import _fused_body, resolve_fused
        from .utils import graphs

        slot = self._slot(link)
        q = _as_batch(self.tree, q)
        batch_tile = default_batch_tile(self.tree.njoints)
        fused = resolve_fused(
            self.fused, self.tree, self.params, q.shape[0], batch_tile,
            dtype=q.dtype, where="solve_tracking",
            num_constraints=len(self.constraint_links),
        )
        warm = self._state if self.params.warm_start else None
        A = None if A is None else self._tensor(A, self.problem.A)
        b = None if b is None else self._tensor(b, self.problem.b)

        def tick(tree, q, problem, A, b, warm):
            prob = problem.update_constraint(slot, A=A, b=b)
            if fused:
                res = _fused_body(self.params, batch_tile, tree, q, prob, warm)
            else:
                res = _solve_impl(tree, self.params, q, prob, warm)
            return res, None if A is None else prob.A, None if b is None else prob.b

        res, A_new, b_new = graphs.run(
            "solve_tracking", self.tree, (self.params, slot, bool(fused), batch_tile), tick,
            (q, self.problem, A, b, warm), capture=not self.params.verbose)
        # the bound tensors stay the problem's own (problem._check_bounds)
        self.problem = self.problem.replace(
            A=self.problem.A if A_new is None else A_new,
            b=self.problem.b if b_new is None else b_new)
        self._state = res.state
        self.last_result = res
        return res

    def track_scan(self, q, b_seq, link: Optional[int] = None, A_seq=None,
                   refine: Optional[str] = None) -> StreamResult:
        """Run a horizon of tracking ticks as one call (`solve_stream`).

        The staged form of `solve_tracking`: `b_seq[t]` (and optionally
        `A_seq[t]`) retargets the constraint at `link` each tick and the
        re-solve warm-starts from the previous tick's duals; on the kernel
        path the ticks are enqueued without a host synchronisation between
        them.  `q` is (B, nq) held fixed or (T, B, nq) per tick.  Returns a
        `StreamResult` with per-tick (T, B, ...) outputs; the final tick's
        state/targets become the solver's warm state and constraint values,
        so per-tick `solve_tracking` calls and further streams continue
        seamlessly."""
        slot = self._slot(link)
        q = torch.as_tensor(q, device=self.tree.device)
        if q.ndim == 1:
            q = q[None]
        stream = solve_stream(
            self.tree, self.params, q, self.problem, slot,
            b_seq, A_seq=A_seq,
            warm_state=self._state if self.params.warm_start else None,
            refine=refine, fused=self.fused,
        )
        self._state = stream.state
        self.problem = self.problem.update_constraint(
            slot, A=None if A_seq is None else A_seq[-1], b=b_seq[-1])
        return stream

    def reach(self, q0, target_R, target_p, link: Optional[int] = None,
              **kw) -> ClikResult:
        """Closed-loop position IK to target SE(3) poses (`solve_clik`): the
        tailored tick (loik-loid-optimized.hpp:596-695) wrapped in the FK ->
        pose error -> solve -> integrate loop.  Uses this solver's problem
        (weights, bounds) with its constraint at ``link`` retargeted every
        tick, and its ``fused`` policy; keyword args (dt, steps, gain,
        max_task_velocity, ...) pass through to `solve_clik`.  Does NOT
        thread the solver's warm state: the loop keeps its own per-tick warm
        starts and self-heal."""
        link = self.constraint_links[self._slot(link)]
        if self.constraint_links != (link,):
            raise ValueError(
                "reach() needs this solver to have exactly one constraint "
                f"at link {link}; got links {self.constraint_links}"
            )
        return solve_clik(self.tree, self.params, q0, target_R, target_p,
                          link, problem=self.problem, fused=self.fused, **kw)

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
