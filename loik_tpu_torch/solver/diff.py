"""Differentiable solves: gradients THROUGH the diff-IK optimization.

Port of `loik_tpu.solver.diff`.  Policy learning, trajectory optimization
and model identification want d(solution)/d(inputs): d nu*/dq through the
forward kinematics, d nu*/d(b, A, H_ref, v_ref, bounds) through the QP
data.  The production `solve` is a loop whose condition the host reads
after every body call; `solve_unrolled` runs the SAME body
(`make_loop_body`: identical math, flags, penalty adaptation, masked
freezing) a FIXED number of times, with nothing read back, so autograd
records it end to end.  Each body call is checkpointed
(`torch.utils.checkpoint`, non-reentrant): the forward keeps one state per
call, and the backward recomputes each call once instead of storing every
intermediate.

Converged problems freeze under the masked merge exactly as in the loop
driver, so past the convergence point the output (and the gradient of the
FROZEN fixed point) stops changing: unrolled-ADMM gradients approach the
implicit-function-theorem gradient as the number of calls grows.

The fused CUDA kernel has no backward, as loik_tpu's Pallas kernel has no
VJP: this path runs the eager loop on whatever device its inputs are on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from torch.utils.checkpoint import checkpoint

from ..params import SolverParams
from ..problem import IkProblem
from .solve import (_as_batch, _reset_state, _result, fwd_pass_init,
                    full_f32_matmul, make_loop_body, prepare_problem,
                    q_dependent_S_list)
from .state import SolveResult, SolverState, init_state


def solve_unrolled(tree, params: SolverParams, q, problem: IkProblem,
                   num_iters: int = 32,
                   warm_state: Optional[SolverState] = None) -> SolveResult:
    """Batched solve of ``num_iters`` body calls, differentiable with
    respect to ``q`` and every ``problem`` leaf (b, A, H_ref, v_ref, lb, ub).

    Use inside a loss: ``loss(solve_unrolled(...)).backward()`` or
    ``torch.autograd.grad``, second derivatives included
    (``create_graph=True``).  ``num_iters`` should comfortably exceed the
    typical converged iteration count of the problem class (converged
    problems freeze, so extra calls cost forward/backward work but do not
    change the answer); check ``res.converged`` as usual.  With
    ``params.check_interval`` K > 1 a call is K iterations, and the budget
    ``max_iter = num_iters + 2`` (as in loik_tpu) freezes problems after
    about ``num_iters`` iterations.

    No host synchronisation: nothing is read back from the device, in the
    forward or the backward, so a training step built on it can be
    captured whole as one CUDA graph with `loik_tpu_torch.utils.jit`."""
    if params.logging or params.verbose:
        raise ValueError("solve_unrolled supports neither logging nor "
                         "verbose (use solve)")
    q = _as_batch(tree, q)  # results stay batched, like `solve`
    dtype, B, dev = q.dtype, q.shape[0], q.device
    # the body's iteration-budget logic reads params.max_iter: it must not
    # freeze problems before the unroll ends
    params = params.replace(max_iter=num_iters + 2)
    with full_f32_matmul():
        prob = prepare_problem(tree, problem, B, dtype)
        if tree.has_q_dependent_S:
            prob = dataclasses.replace(
                prob, S_list=q_dependent_S_list(tree, q, dtype))
        st = warm_state if warm_state is not None else init_state(
            tree, B, problem.num_constraints, dtype, dev)
        st = _reset_state(tree, params, st, dtype)
        liMi_R, liMi_p = fwd_pass_init(tree, q)
        st = dataclasses.replace(st, liMi_R=liMi_R, liMi_p=liMi_p)
        body = make_loop_body(tree, prob, params)
        for _ in range(num_iters):
            # non-reentrant: takes the state dataclass and supports
            # torch.autograd.grad and double backward.  The body draws no
            # random numbers, so no generator state is saved or restored:
            # a CUDA graph capture (`utils.jit`) allows neither
            st = checkpoint(body, st, use_reentrant=False, preserve_rng_state=False)
    return _result(tree, st)
