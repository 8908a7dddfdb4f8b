"""Multi-start global IK: BASELINE.json configs[4], "100k random seeds
feeding sampling-based motion planning".

Port of `loik_tpu.parallel.multistart`.  Differential IK is local; global IK
restarts it from many random configurations and keeps the best converged
solutions.  One diff-IK solve per seed scores how well the commanded
end-effector velocity can be realized from that configuration; downstream
planners integrate `q + dt nu`.  With a ``mesh`` the seed axis is split
over its devices (`sharding.run_sharded`) and the solutions gathered on the
first before the ranking.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..params import SolverParams
from ..problem import IkProblem, validate_problem
from ..solver.solve import solve
from .sharding import Mesh, run_sharded


def task_error(res, problem: IkProblem) -> torch.Tensor:
    """Pure task-constraint violation per problem, max_c ||A_c v_c - b_c||_inf
    at the solution, in the wider of the result's and the problem's dtypes
    (unlike `primal_residual`, which also folds in the box slack block).
    A and b may be shared (NC, 6, 6) / (NC, 6) or per problem with a
    leading batch axis; each problem is scored on its own A."""
    vis = res.vis                                                   # (B, N, 6)
    v_c = torch.stack([vis[:, c] for c in problem.constraint_links], dim=1)
    dtype = torch.promote_types(vis.dtype, problem.A.dtype)
    A = problem.A.to(vis.device, dtype)
    b = problem.b.to(vis.device, dtype)
    r = (A @ v_c.to(dtype)[..., None])[..., 0] - b                 # (B, NC, 6)
    return r.abs().amax(dim=(1, 2))


@dataclasses.dataclass(frozen=True)
class MultistartResult:
    """Ranked multi-start outcome (best seed first).

    ``error[i] == inf`` marks a slot NOT backed by a converged seed: either
    fewer than k seeds converged, or none did.  Check ``num_converged``
    (host-side: ``found``) before consuming ``q``/``nu``; with no winner
    they are arbitrary seed data."""

    q: torch.Tensor              # (k, nq) ranked seed configurations
    nu: torch.Tensor             # (k, nv) their solutions
    error: torch.Tensor          # (k,) task errors; inf = slot not converged
    num_converged: torch.Tensor  # () int32, converged seeds of the batch
    result: object               # the per-seed SolveResult

    @property
    def found(self) -> bool:
        """Host-side check (reads the device): did ANY seed converge?"""
        return bool(self.num_converged > 0)


def multistart_from_configs(tree, params: SolverParams, problem: IkProblem,
                            qs: torch.Tensor, k: int = 1,
                            solve_fn=None, mesh: Optional[Mesh] = None) -> MultistartResult:
    """Solve from the seed configurations ``qs`` (S, nq) and rank them:
    task error per converged seed, inf for the rest, the k smallest first
    (`torch.topk`).  With a ``mesh`` the seeds are split over its devices
    (S divisible by its size) and the ranking runs on the first.  Nothing
    is read back to the host."""
    if not 1 <= k <= qs.shape[0]:
        raise ValueError(f"k must be in [1, num_seeds]; got k={k}")
    if mesh is None:
        res = (solve_fn or solve)(tree, params, qs, problem)
    else:
        res = run_sharded(tree, params, qs, problem, mesh, solve_fn=solve_fn)
        qs = qs.to(mesh.devices[0])
    err = torch.where(res.converged, task_error(res, problem), float("inf"))
    neg_top, idx = torch.topk(-err, k)
    return MultistartResult(
        q=qs[idx], nu=res.nu[idx], error=-neg_top,
        num_converged=res.converged.sum(dtype=torch.int32), result=res,
    )


def solve_multistart(tree, params: SolverParams, problem: IkProblem,
                     generator, num_seeds: int, mesh: Optional[Mesh] = None,
                     solve_fn=None, k: int = 1) -> MultistartResult:
    """Solve from ``num_seeds`` random configurations drawn from
    ``generator`` (a `torch.Generator` on the tree's device, or None for
    torch's default one) by `tree.random_configuration`; return the k best.

    solve_fn(tree, params, qs, problem) replaces the solver (e.g. the
    delta-duals refinement for tol-1e-6 scoring, which runs the fused
    kernel on the GPU); the default is the batched `solve`.  A restart loop
    calls this once per batch of seeds with the same generator.  With a
    ``mesh`` (num_seeds divisible by its size) the seeds, all drawn from
    the one generator as without it, are split over its devices, solved per
    shard and gathered for the ranking: the same generator state gives the
    same seeds with or without a mesh.

    Ranking considers ONLY converged seeds: slots beyond ``num_converged``
    carry ``error == inf`` and arbitrary q/nu; when no seed converges,
    ``found`` is False and the caller should resample.

    Without a mesh, on CUDA tensors the sampler, the solve (the default
    one's masked while loop a WHILE node), the scoring and the top k run as
    ONE captured CUDA graph per key (loik_tpu's `_multistart_jit`).  The
    graph draws from a generator of its own that takes ``generator``'s
    state before each call and hands it back after (`utils.graphs.run`):
    each call advances ``generator`` as an eager call does and draws the
    same seeds, and a new generator object is no new capture.  A
    ``solve_fn`` runs after an eager draw, as its own graph where it is
    one (a new function object would be a new key every call)."""
    if not 1 <= k <= num_seeds:
        raise ValueError(f"k must be in [1, num_seeds]; got k={k}")
    if mesh is not None and num_seeds % mesh.size:
        raise ValueError(
            f"num_seeds {num_seeds} not divisible by mesh size {mesh.size}")
    from ..utils import graphs

    validate_problem(tree, problem)
    num_seeds = int(num_seeds)

    def body(problem, gen=None):
        qs = tree.random_configuration((num_seeds,), generator=gen)
        return multistart_from_configs(tree, params, problem, qs, k, solve_fn, mesh)

    return graphs.run("solve_multistart", tree, (params, num_seeds, k), body, (problem,),
                      capture=solve_fn is None and mesh is None and not params.verbose,
                      generator=generator)
