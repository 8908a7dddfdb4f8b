"""Closed-loop inverse kinematics (position-level IK) on top of the
differential solver.

Port of `loik_tpu.solver.clik`.  The reference is a *differential* IK
solver; its tailored per-tick overload `Solve(q, c_id, Ai, bi)`
(loik-loid-optimized.hpp:596-695) is the building block callers wrap in this
loop: measure the end-effector pose, command a velocity toward the target,
solve, integrate.  Per tick, for each problem of the batch:

  1. FK: world placement M_ee of the constrained joint at the current q.
  2. Local-frame pose error twist  err = log6(M_ee^-1 * M_target)
     (spatial velocities live in the joint's LOCAL frame,
     ik-id-description.hpp:106-135, so the command is simply gain * err).
  3. One constrained diff-IK solve with A = I6, b = gain * err and the
     problem's box bounds: saturation and secondary objectives (H_ref,
     v_ref) are handled BY the solver.
  4. q <- integrate(q, dt * nu) on the configuration manifold.

`loik_tpu` runs the ticks as one `lax.scan` program (`_clik_jit`); here,
as in `solver.stream.solve_stream`, the counterpart is `utils.graphs.scan`:
on CUDA tensors one tick (the pose error, the velocity command and its
clamp, the constraint update, the solve (a kernel launch, or the masked
while loop as a WHILE node), the self-heal, the integration and the
history row) is captured as a CUDA graph and replayed once per tick, q and
the solver state carried in the graph's own buffers; elsewhere (the CPU,
`utils.disable_graphs()`, ``params.verbose``) the same tick runs as a host
loop.  No value is read
back inside the loop, so the host runs ahead of the card by the whole
horizon.  `reached`, `pos_err` and `rot_err` come from the final pose
error after the loop.  Each tick warm-starts from
the previous tick's duals, except problems whose tick did not converge,
which restart cold (the self-heal: a tick whose QP was infeasible leaves
diverged duals that would poison every later warm solve).

A fixed tick count: problems reach their targets at different times, and
finished problems keep solving a ~zero-error problem, which costs ~2
warm iterations a tick.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import spatial
from ..params import SolverParams
from ..problem import IkProblem, make_problem, validate_problem
from .refine import default_batch_tile
from .solve import _as_batch, _solve_impl, full_f32_matmul
from .state import SolverState, init_state


@dataclasses.dataclass(frozen=True)
class ClikResult:
    """Outcome of a closed-loop IK run (leading batch axis B)."""

    q: torch.Tensor            # (B, nq) final configurations
    reached: torch.Tensor      # (B,) bool: final pose error within tolerances
    pos_err: torch.Tensor      # (B,) |translation error| at the end [m]
    rot_err: torch.Tensor      # (B,) |rotation error| at the end [rad]
    err_history: torch.Tensor  # (T, B) inf-norm of the 6-D error twist per tick
    nu: torch.Tensor           # (B, nv) last commanded joint velocities
    state: SolverState         # final solver state (warm start for more ticks)
    converged: torch.Tensor    # (B,) last tick's diff-IK convergence flags
    iterations: torch.Tensor   # (B,) last tick's diff-IK iteration counts


def _heal(conv: torch.Tensor, st: SolverState, cold: SolverState) -> SolverState:
    """The state with every per-problem field of the problems that did not
    converge replaced by the cold state's.  Every such field has the batch
    as its LAST axis, so the (B,) mask broadcasts over the rest; the scalar
    `it` and any logs a warm state brought (the cold state has none) stay."""
    upd = {}
    for f in dataclasses.fields(st):
        x, c = getattr(st, f.name), getattr(cold, f.name)
        if isinstance(x, torch.Tensor) and x.ndim and c is not None:
            upd[f.name] = torch.where(conv, x, c)
    return dataclasses.replace(st, **upd)


def solve_clik(tree, params: SolverParams, q0, target_R, target_p,
               link: int, *, dt: float = 0.05, steps: int = 64,
               gain: float = 1.0,
               max_task_velocity: Optional[float] = None,
               problem: Optional[IkProblem] = None,
               warm_state: Optional[SolverState] = None,
               pos_tol: float = 1e-4, rot_tol: float = 1e-3,
               fused=None, batch_tile: Optional[int] = None) -> ClikResult:
    """Drive joint ``link`` of a batch of configurations to target SE(3)
    poses by closed-loop IK (see the module docstring).

    Args:
      q0: (B, nq) or (nq,) start configurations, on the tree's device.
      target_R / target_p: target world placements, (B, 3, 3) / (B, 3) per
        problem, or one (3, 3) / (3,) pose for the whole batch.
      link: the constrained joint (its world placement is driven).
      dt: integration step per tick [s]; gain: error-to-velocity feedback
        gain [1/s].  The per-tick contraction is ~dt*gain while the
        velocity bounds are inactive.
      max_task_velocity: optional inf-norm cap on the commanded twist
        (direction-preserving saturation).  With tight joint-velocity bounds
        an uncapped gain*err during the approach makes the per-tick QP
        infeasible; the loop still self-heals, but capped commands converge
        faster.
      problem: optional IkProblem with ONE constraint at ``link``, giving
        the weights H_ref/v_ref and the box bounds; its ``b`` is overwritten
        every tick.  Default: `make_problem`'s (reference-fixture weights,
        the model's velocity limits).
      steps: the tick count (fixed: no data-dependent early exit).
      fused / batch_tile: kernel routing per tick, decided once by
        `kernels.fused.resolve_fused` (None: the kernel when eligible,
        warning once naming the blocker otherwise; "require" raises
        instead).  Float32 on the kernel path; in float32 a tick certifies
        down to ~1e-5, so tol 1e-4 suits it.

    The solve of every tick runs with ``warm_start=True`` and
    ``check_feasibility=False``: as the loop converges b -> 0, which makes
    the infeasibility certificate's b'dy condition trivially true and its
    ratio test noise, so ticks would be frozen as "infeasible"; failure is
    reported by ``reached`` instead (an unreachable pose stalls at its
    closest approach).

    ``params.logging`` raises ValueError; ``params.verbose`` prints each
    eager tick's banners and, as the kernel cannot print, is refused on the
    kernel path like logging (`kernels.fused.resolve_fused`).

    Returns a ClikResult; ``reached`` = final |pos err| < pos_tol and
    |rot err| < rot_tol.
    """
    if params.logging:
        raise ValueError(
            "solve_clik keeps no per-tick logs (a closed loop would carry one "
            "(max_iter, B) log per field and tick); log a tick with "
            "DiffIkSolver.solve_tracking or utils.debug_mirror instead")
    if steps < 1:
        raise ValueError(f"steps must be at least 1; got {steps}")
    q0 = _as_batch(tree, q0)
    B, dtype, dev = q0.shape[0], q0.dtype, q0.device
    target_R = torch.as_tensor(target_R, dtype=dtype, device=dev).expand(B, 3, 3)
    target_p = torch.as_tensor(target_p, dtype=dtype, device=dev).expand(B, 3)
    if problem is None:
        problem = make_problem(tree, (link,), dtype=dtype)
    elif problem.constraint_links != (link,):
        raise ValueError(
            f"problem must have exactly one constraint at link {link}; got "
            f"links {problem.constraint_links}"
        )
    validate_problem(tree, problem)
    # per-problem b slots: the error twist differs across the batch
    problem = problem.replace(
        A=torch.as_tensor(problem.A, dtype=dtype, device=dev).expand(B, 1, 6, 6),
        b=torch.zeros((B, 1, 6), dtype=dtype, device=dev))
    params = params.replace(warm_start=True, check_feasibility=False)
    if batch_tile is None:
        batch_tile = default_batch_tile(tree.njoints)
    from ..kernels.fused import _fused_body, resolve_fused

    fused = resolve_fused(fused, tree, params, B, batch_tile, dtype=dtype,
                          where="solve_clik", num_constraints=1)
    # the self-heal's target is a cold state, NOT warm_state (which may
    # carry the caller's duals)
    cold = init_state(tree, B, 1, dtype, dev)
    st = cold if warm_state is None else warm_state

    def pose_error(tree, q, target_R, target_p):
        _, _, oR, op = tree.fwd_kinematics(q)
        Ri, pi = spatial.se3_inverse(oR[..., link, :, :], op[..., link, :])
        Rd, pd = spatial.se3_compose(Ri, pi, target_R, target_p)
        return spatial.se3_log(Rd, pd)                 # (B, 6) local frame

    def tick(tree, carry, _, consts):
        q, st = carry[:2]
        target_R_, target_p_, problem_, cold_ = consts
        with full_f32_matmul():
            err = pose_error(tree, q, target_R_, target_p_)
            v_cmd = gain * err
            if max_task_velocity is not None:
                mag = v_cmd.abs().amax(-1, keepdim=True)
                v_cmd = v_cmd * torch.clamp(
                    float(max_task_velocity) / torch.clamp(mag, min=1e-30), max=1.0)
            prob = problem_.update_constraint(0, b=v_cmd)
            if fused:
                res = _fused_body(params, batch_tile, tree, q, prob, st)
            else:
                res = _solve_impl(tree, params, q, prob, st)
            st = _heal(res.converged, res.state, cold_)
            q = tree.integrate(q, dt * res.nu)
        return (q, st, res.nu, res.converged, res.iterations), err.abs().amax(-1)

    from ..utils import graphs

    # the last tick's solve outputs travel in the carry; their first values
    # are never read (steps >= 1)
    carry = (q0, st, q0.new_zeros((B, tree.nv)),
             torch.zeros(B, dtype=torch.bool, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev))
    (q, st, nu, conv, iters), hist = graphs.scan(
        "solve_clik", tree,
        (params, link, dt, gain, max_task_velocity, bool(fused), batch_tile),
        tick, carry, None, (target_R, target_p, problem, cold), steps,
        capture=not params.verbose)
    with full_f32_matmul():
        err_final = pose_error(tree, q, target_R, target_p)
    pos_err = torch.linalg.norm(err_final[..., :3], dim=-1)
    rot_err = torch.linalg.norm(err_final[..., 3:], dim=-1)
    return ClikResult(
        q=q, reached=(pos_err < pos_tol) & (rot_err < rot_tol),
        pos_err=pos_err, rot_err=rot_err, err_history=hist,
        nu=nu, state=st, converged=conv, iterations=iters,
    )
