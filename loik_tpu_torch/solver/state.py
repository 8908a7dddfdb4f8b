"""SolverState / PreparedProblem / SolveResult for the fast solver.

Plain frozen dataclasses of tensors with the same field names and shapes as
`loik_tpu.solver.state`: structure-of-arrays with the problem batch as the
TRAILING axis (see batched_spatial.py for why).

Shape legend: N = moving joints, K = nv_max, NC = constraints, B = batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PreparedProblem:
    """Problem quantities precomputed once per solve — the analog of
    `IkProblemFormulationOptimized`'s cached AtA/Atb/Hv and norms
    (ik-id-description-optimized.hpp:78-171)."""

    H_ref: torch.Tensor   # (N, 6, 6, B)
    Hv: torch.Tensor      # (N, 6, B)   = H_ref^T v_ref
    A: torch.Tensor       # (NC, 6, 6, B)
    b: torch.Tensor       # (NC, 6, B)
    AtA: torch.Tensor     # (NC, 6, 6, B)
    Atb: torch.Tensor     # (NC, 6, B)
    lb: torch.Tensor      # (N, K, B) padded with 0
    ub: torch.Tensor      # (N, K, B) padded with 0
    b_inf: torch.Tensor   # (B,)
    Hv_inf: torch.Tensor  # (B,)
    constraint_links: Tuple[int, ...] = ()
    # optional (B,) floors folded into the OSQP adaptive tolerances — the
    # delta-duals refinement certifies the SHIFTED problem against the
    # ORIGINAL problem's scales (loik-loid-optimized.hxx:540-565)
    tol_scale_primal: Optional[torch.Tensor] = None
    tol_scale_dual: Optional[torch.Tensor] = None
    # optional (N, K, B) additive linear term on the nu-block (c'nu in the QP
    # objective): the nu-block of the stage-1 KKT residual in the delta-duals
    # refinement.  It enters FwdPass1's r AND the dual-residual nu-block.
    r_offset: Optional[torch.Tensor] = None
    # optional per-joint exact-size (6, nv_i, B) motion subspaces for trees
    # with configuration-dependent S (universal / spherical-ZYX / mimic-pair
    # joints): computed once per solve from q, like liMi
    S_list: Optional[Tuple[torch.Tensor, ...]] = None
    # optional precomputed per-problem motion subspaces (N, 6, K, B), K
    # uniform across joints, for trees with batched geometry leaves (the
    # mixed super-batch): S is iteration-constant, so the fused kernel and
    # the eager loop read it as data (`kernels.fused.with_S_all`)
    S_all: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class SolverState:
    """Full per-problem ADMM state, warm-startable by passing it back into
    solve (`Reset(warm_start)`, loik-loid-data-optimized.hxx:114-127)."""

    # kinematics (frozen during iterations)
    liMi_R: torch.Tensor  # (N, 3, 3, B)
    liMi_p: torch.Tensor  # (N, 3, B)

    # primal / dual variables
    vis: torch.Tensor     # (N, 6, B) link spatial velocities (local frames)
    fis: torch.Tensor     # (N, 6, B) kinematics-constraint duals ("forces")
    nu: torch.Tensor      # (N, K, B) joint velocities, padded per-joint layout
    z: torch.Tensor       # (N, K, B) box-projected slack
    w: torch.Tensor       # (N, K, B) box-constraint duals
    yis: torch.Tensor     # (NC, 6, B) task-constraint duals
    Aty: torch.Tensor     # (NC, 6, B) cached A^T y

    # residual recursion caches (previous iteration values, for deltas)
    fdpa: torch.Tensor    # (N, 6, B) fis_diff_plus_Aty = A^T y|_v-block
    stfw: torch.Tensor    # (N, K, B) S^T f + w       = A^T y|_nu-block

    # per-problem scalars
    mu: torch.Tensor              # (B,)
    mu_eq: torch.Tensor           # (B,)
    mu_ineq: torch.Tensor         # (B,)
    iterations: torch.Tensor      # (B,) int32: iteration at which the problem stopped
    tail_iterations: torch.Tensor # (B,) int32
    converged: torch.Tensor       # (B,) bool
    primal_infeasible: torch.Tensor  # (B,) bool
    dual_infeasible: torch.Tensor    # (B,) bool (never set, as in loik_tpu)
    in_tail: torch.Tensor         # (B,) bool: in infeasibility tail solve
    running: torch.Tensor         # (B,) bool
    primal_residual: torch.Tensor # (B,)
    dual_residual: torch.Tensor   # (B,)
    delta_x_inf: torch.Tensor     # (B,) max(|dvis|, |dnu|) for tail-solve check
    delta_z_inf: torch.Tensor     # (B,)

    it: torch.Tensor              # () int32 loop iteration counter

    # optional per-iteration logs (max_iter, B), allocated only when
    # params.logging — the batched analog of LoikSolverInfo's per-iteration
    # lists (loik-loid.hpp:40-121); NaN marks iterations a problem did not
    # run, and with check_interval K > 1 the iterations between checks.
    # Tail-solve lists are these logs masked by log_in_tail (1.0 = a tail
    # iteration).  log_dx / log_dz are |delta x|_inf / |delta z|_inf.
    log_rp: Optional[torch.Tensor] = None
    log_rd: Optional[torch.Tensor] = None
    log_mu: Optional[torch.Tensor] = None
    log_rp_task: Optional[torch.Tensor] = None
    log_rp_slack: Optional[torch.Tensor] = None
    log_rd_v: Optional[torch.Tensor] = None
    log_rd_nu: Optional[torch.Tensor] = None
    log_mu_eq: Optional[torch.Tensor] = None
    log_mu_ineq: Optional[torch.Tensor] = None
    log_in_tail: Optional[torch.Tensor] = None
    log_dx: Optional[torch.Tensor] = None
    log_dz: Optional[torch.Tensor] = None


LOG_FIELDS = (
    "log_rp", "log_rd", "log_mu", "log_rp_task", "log_rp_slack",
    "log_rd_v", "log_rd_nu", "log_mu_eq", "log_mu_ineq", "log_in_tail",
    "log_dx", "log_dz",
)


def nan_logs(max_iter: int, B: int, dtype: torch.dtype, device) -> dict:
    """Every log field as a fresh (max_iter, B) NaN tensor."""
    return {name: torch.full((max_iter, B), float("nan"), dtype=dtype, device=device)
            for name in LOG_FIELDS}


def init_state(tree, B: int, num_constraints: int, dtype: torch.dtype,
               device=None, max_iter: int = 0, logging: bool = False) -> SolverState:
    """A zero state; with ``logging`` also the (max_iter, B) NaN logs."""
    N, K = tree.njoints, tree.nv_max
    dev = torch.device(device) if device is not None else tree.device

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def inf():
        return torch.full((B,), float("inf"), dtype=dtype, device=dev)

    return SolverState(
        liMi_R=zeros(N, 3, 3, B), liMi_p=zeros(N, 3, B),
        vis=zeros(N, 6, B), fis=zeros(N, 6, B),
        nu=zeros(N, K, B), z=zeros(N, K, B), w=zeros(N, K, B),
        yis=zeros(num_constraints, 6, B), Aty=zeros(num_constraints, 6, B),
        fdpa=zeros(N, 6, B), stfw=zeros(N, K, B),
        mu=zeros(B), mu_eq=zeros(B), mu_ineq=zeros(B),
        iterations=zeros(B, dt=torch.int32),
        tail_iterations=zeros(B, dt=torch.int32),
        converged=zeros(B, dt=torch.bool),
        primal_infeasible=zeros(B, dt=torch.bool),
        dual_infeasible=zeros(B, dt=torch.bool),
        in_tail=zeros(B, dt=torch.bool), running=zeros(B, dt=torch.bool),
        primal_residual=inf(), dual_residual=inf(),
        delta_x_inf=zeros(B), delta_z_inf=zeros(B),
        it=zeros(dt=torch.int32),
        **(nan_logs(max_iter, B, dtype, dev) if logging else {}),
    )


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Batch-leading user-facing result (converted from internal layout)."""

    nu: torch.Tensor                 # (B, nv) joint velocities
    z: torch.Tensor                  # (B, nv) box-projected joint velocities
    vis: torch.Tensor                # (B, N, 6) link spatial velocities
    converged: torch.Tensor          # (B,) bool
    primal_infeasible: torch.Tensor  # (B,) bool
    dual_infeasible: torch.Tensor    # (B,) bool
    iterations: torch.Tensor         # (B,) int32
    tail_iterations: torch.Tensor    # (B,) int32
    primal_residual: torch.Tensor    # (B,)
    dual_residual: torch.Tensor      # (B,)
    state: SolverState               # full final state (warm start / inspection)
    # per-iteration logs (max_iter, B) when params.logging, else None
    log_rp: Optional[torch.Tensor] = None
    log_rd: Optional[torch.Tensor] = None
    log_mu: Optional[torch.Tensor] = None
    log_rp_task: Optional[torch.Tensor] = None
    log_rp_slack: Optional[torch.Tensor] = None
    log_rd_v: Optional[torch.Tensor] = None
    log_rd_nu: Optional[torch.Tensor] = None
    log_mu_eq: Optional[torch.Tensor] = None
    log_mu_ineq: Optional[torch.Tensor] = None
    log_in_tail: Optional[torch.Tensor] = None
    log_dx: Optional[torch.Tensor] = None
    log_dz: Optional[torch.Tensor] = None
