"""Tight-tolerance solves below the float32 floor.

Port of `loik_tpu.solver.refine`.  Single precision cannot certify tol 1e-6
on this problem class: the augmented-Lagrangian penalty mu_eq amplifies the
Riccati operands to ||H|| ~ 1e2, so float32 iterates stall at
~eps_f32 * ||H|| ~ 1e-5.  Three ways past that floor, each starting with a
float32 stage 1 at a tolerance above it:

  - `solve_delta_duals` (the flagship): one float64 KKT evaluation, then
    the SAME float32 solver on the shifted (delta) problem, whose in-loop
    quantities are O(stage-1 error).  Both float32 stages run the fused
    kernel on the GPU, and the float64 step between them one launch of
    `kernels.kkt64` (`_kkt64_plain` elsewhere).  Constant motion subspaces
    only.
  - `solve_two_stage`: the float32 stage 1 (the fused kernel on the GPU
    where the tree allows it), then a short warm float64 stage 2 on the
    masked while loop.  The tight-tolerance path of every tree, including
    those with configuration-dependent subspaces (universal, spherical-ZYX
    and mimic-pair joints).
  - `solve_delta_refined`: the delta problem in primal form with the
    stage-1 duals kept, both float32 stages on the masked while loop (as in
    loik_tpu, where it calls the plain solve).

On CUDA tensors each runs as ONE captured CUDA graph per key
(`utils.graphs`), the masked while loop a WHILE node inside it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..params import SolverParams
from ..problem import IkProblem, validate_problem
from ..utils.observability import phase
from . import batched_spatial as bsp
from .solve import (_as_batch, _flat_nu, _reset_state, _solve_impl,
                    _solve_loop, full_f32_matmul, kkt_residual,
                    prepare_problem)
from .state import PreparedProblem, SolveResult, SolverState


def default_batch_tile(njoints: int) -> int:
    """Problems per block of the fused kernel (8 lanes each).  A block's
    problems share its shared memory and it ends with its slowest problem,
    so a tall tree, whose frame is large and whose iterations are long,
    wants few problems per block and an arm more.  Measured on an H100
    (tools/flagship_kernel_time.py --batch-tile, PERF.md): panda_arm is
    fastest at 16 (2 to 32 tried; 2 and 32 are 20-50% slower), solo12 at 8,
    talos at 4 (1 to 12 tried, within 15%).  `kernels.fused.
    problems_per_block` lowers the value to what a block's shared memory
    holds (12 talos problems in float32, 4 in float64)."""
    if njoints <= 8:
        return 16
    return 8 if njoints <= 16 else 4


def _cast_state(st: SolverState, dtype) -> SolverState:
    """The state with every floating tensor cast to ``dtype``."""
    upd = {}
    for f in dataclasses.fields(st):
        x = getattr(st, f.name)
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            upd[f.name] = x.to(dtype)
    return dataclasses.replace(st, **upd)


def _cast_problem(p: IkProblem, dtype) -> IkProblem:
    return IkProblem(
        H_ref=p.H_ref.to(dtype), v_ref=p.v_ref.to(dtype), A=p.A.to(dtype),
        b=p.b.to(dtype), lb=p.lb.to(dtype), ub=p.ub.to(dtype),
        constraint_links=p.constraint_links,
    )


def solve_delta_duals(
    tree,
    params: SolverParams,
    q,
    problem: IkProblem,
    stage1_tol: float = 2e-5,
    stage1_max_iter: int = 32,
    stage2_max_iter: int = 24,
    stage2_mu: float = 1e-2,
    stage2_mu_eq_scale: float = 1e5,
    warm_state: Optional[SolverState] = None,
    fused=None,
    batch_tile: Optional[int] = None,
) -> SolveResult:
    """Tight-tolerance solve with NO float64 loop: float32 stage 1 + float32
    delta-duals correction stage.

    Substituting x = x_hat + dx, y = y_hat + dy into the QP's KKT system
    turns the refinement into the SAME solver run on a shifted problem whose
    linear terms are the stage-1 KKT residuals, with duals starting at ZERO:

      - nu-block linear term  c = d0_nu = (S'f + w)|_hat   (r_offset)
      - v-block linear term       d0_v  = (H_ref v - Hv + fdpa)|_hat
        (folded in as Hv := -d0_v)
      - task rhs   b_delta  = b - A v_hat
      - box bounds shifted by nu_hat; z warm-started at z_hat - nu_hat

    d0 is computed ONCE in float64; the delta stage certifies against the
    ORIGINAL problem's adaptive-tolerance scales (tol_scale floors), with
    infeasibility certificates off (they are degenerate in delta space).

    fused: kernel policy for both float32 stages (None | True | False |
    'require', `kernels.fused.resolve_fused`).  Returns results in the
    original space with a full-space state (warm-startable).

    On CUDA tensors everything after the validation (the casts, both
    stages with their FK, prepare, reset and launch or masked while loop,
    the float64 KKT evaluation, the delta problem and the recombination)
    runs as ONE captured CUDA graph per key (`utils.graphs`, the
    counterpart of loik_tpu's `_delta_duals_jit`), the float64 step one
    launch of `kernels.kkt64` unless an input requires a gradient; eagerly
    under `utils.disable_graphs()` or `utils.debug_nans()`, on the CPU, and
    with ``params.verbose`` (the loop prints from the host every body call).

    Constant-subspace trees only, as in loik_tpu (whose answer for
    universal / spherical-ZYX / mimic-pair joints is `solve_two_stage`)."""
    if tree.has_q_dependent_S:
        raise ValueError(
            "solve_delta_duals supports constant motion subspaces only; "
            "this tree has universal, spherical-ZYX or mimic-pair joints "
            "(use solver.solve)"
        )
    q = _as_batch(tree, q)
    validate_problem(tree, problem)
    if batch_tile is None:
        batch_tile = default_batch_tile(tree.njoints)
    from ..kernels.fused import resolve_fused

    fused = bool(resolve_fused(fused, tree, params, q.shape[0], batch_tile,
                               dtype=None, where="solve_delta_duals",
                               num_constraints=problem.num_constraints))
    p1 = params.replace(
        tol_abs=max(stage1_tol, params.tol_abs),
        tol_rel=max(stage1_tol, params.tol_rel),
        max_iter=min(params.max_iter, stage1_max_iter),
    )
    p2 = params.replace(
        warm_start=True,
        max_iter=stage2_max_iter,
        mu=stage2_mu,
        mu_equality_scale_factor=stage2_mu_eq_scale,
        check_feasibility=False,
        freeze_infeasible_on_warm_start=True,
    )
    f32 = torch.float32

    def body(tree, q, problem, warm_state):
        with phase("solver.cast"):
            args = (tree, tree.astype(f32), p1, p2, q, problem,
                    _cast_problem(problem, f32),
                    _cast_state(warm_state, f32) if warm_state is not None else None)
        return _delta_duals(*args, fused=fused, batch_tile=batch_tile)

    from ..utils import graphs

    return graphs.run("solve_delta_duals", tree, (p1, p2, fused, batch_tile), body,
                      (q, problem, warm_state), capture=not params.verbose)


def _delta_duals(tree, tree32, p1, p2, q, problem, prob32, warm_state,
                 fused=False, batch_tile=128) -> SolveResult:
    """The body of loik_tpu's `_delta_duals_jit`.  ``tree`` and ``problem``
    as the caller gave them (the float64 step reads them in their own
    dtype), ``tree32`` and ``prob32`` their float32 casts."""
    f32 = torch.float32
    if fused:
        from ..kernels.fused import fused_loop

        loop = fused_loop(batch_tile)
    else:
        loop = _solve_loop

    # ---- stage 1: plain f32 solve at the f32-floor tolerance -------------
    with phase("solver.cast"):
        q32 = q.to(f32)
    res1, pp32 = _solve_impl(tree32, p1, q32, prob32, warm_state, loop=loop,
                             with_problem=True)
    st1 = res1.state

    with full_f32_matmul(), phase("solver.kkt64"):
        if tree32.has_batched_geometry and pp32.S_all is None:
            # batched geometry (mixed super-batch): precompute per-problem
            # subspaces once; both the fused stage-2 kernel and the eager
            # loop consume them as data
            from ..kernels.fused import with_S_all

            pp32 = with_S_all(tree32, pp32, f32)
        # ---- one f64 KKT-residual evaluation at the stage-1 point, the f32
        # delta problem and the delta state: one launch on the card --------
        from ..kernels import kkt64

        step = kkt64.kkt64_step if kkt64.on_kernel(tree, problem, st1) else _kkt64_plain
        prob_d, st_d, fdpa_hat = step(tree, problem, pp32, st1)
        with phase("solver.reset"):
            st_d = _reset_state(tree32, p2, st_d, f32)

    with phase("solver.loop"):
        st2 = loop(tree32, prob_d, p2, st_d)

    # ---- recombine in the original space --------------------------------
    with phase("solver.result"):
        nu_hat = _flat_nu(tree32, st1.nu)
        vis_hat = st1.vis.movedim(-1, 0)
        # the returned state is FULL-space (x = x_hat + dx, duals y_hat + dy), so
        # warm-starting the next solve from it is meaningful; st2.stfw is already
        # full-space (the delta iteration adds r_offset = (S'f + w)|_hat), fdpa
        # needs the stage-boundary f64 evaluation added back
        st_full = dataclasses.replace(
            st2,
            vis=st2.vis + st1.vis,
            fis=st2.fis + st1.fis,
            nu=st2.nu + st1.nu,
            z=st2.z + st1.nu,
            w=st1.w + st2.w,
            yis=st1.yis + st2.yis,
            Aty=st1.Aty + st2.Aty,
            fdpa=st2.fdpa + fdpa_hat,
        )
        return SolveResult(
            nu=_flat_nu(tree32, st2.nu) + nu_hat,
            z=_flat_nu(tree32, st2.z) + nu_hat,
            vis=st2.vis.movedim(-1, 0) + vis_hat,
            converged=st2.converged,
            primal_infeasible=st2.primal_infeasible,
            dual_infeasible=st2.dual_infeasible,
            iterations=res1.iterations + st2.iterations,
            tail_iterations=st2.tail_iterations,
            primal_residual=st2.primal_residual,
            dual_residual=st2.dual_residual,
            state=st_full,
        )


def _kkt64_plain(tree, problem: IkProblem, prob32: PreparedProblem, st1: SolverState):
    """The float64 KKT step of `_delta_duals` in plain PyTorch: the KKT
    residual at the stage-1 point ``st1`` in float64, the original
    problem's adaptive-tolerance scales, the float32 delta problem (the
    rest of ``prob32``, stage 1's prepared problem, kept) and the delta
    state.  Returns ``(prob_d, st_d, fdpa_hat)``.  The CPU runs it; on the
    card one launch of `kernels.kkt64.kkt64_step` takes its place, equal to
    it in every bit, whose backward runs it again for the gradient."""
    f32, f64 = torch.float32, torch.float64
    tree64, prob64 = tree.astype(f64), _cast_problem(problem, f64)
    B = st1.vis.shape[-1]
    st64 = _cast_state(st1, f64)
    pp64 = prepare_problem(tree64, prob64, B, f64)
    d0_v, d0_nu, fdpa_hat = kkt_residual(tree64, pp64, st64)

    Av_hat = torch.stack(
        [bsp.mv(pp64.A[k], st64.vis[c])
         for k, c in enumerate(prob64.constraint_links)]
    )                                                         # (NC,6,B)
    b_d = pp64.b - Av_hat
    lb_d = pp64.lb - st64.nu                                  # padded slots: 0-0
    ub_d = pp64.ub - st64.nu

    # original-problem adaptive-tolerance scales (CheckConvergence,
    # loik-loid-optimized.hxx:540-565) as (B,) floors for the delta stage
    Href_vhat = bsp.mv(pp64.H_ref, st64.vis)
    scale_p = torch.maximum(
        torch.maximum(bsp.inf_norm_b(Av_hat), bsp.inf_norm_b(st64.nu)),
        pp64.b_inf,
    )
    scale_d = torch.maximum(
        torch.maximum(bsp.inf_norm_b(Href_vhat), pp64.Hv_inf),
        torch.maximum(bsp.inf_norm_b(fdpa_hat), bsp.inf_norm_b(d0_nu)),
    )

    # ---- the f32 delta problem -------------------------------------------
    prob_d = dataclasses.replace(
        prob32,
        Hv=(-d0_v).to(f32),
        Hv_inf=bsp.inf_norm_b(d0_v).to(f32),
        b=b_d.to(f32),
        Atb=bsp.mtv(pp64.A, b_d).to(f32),
        b_inf=bsp.inf_norm_b(b_d).to(f32),
        lb=lb_d.to(f32),
        ub=ub_d.to(f32),
        r_offset=d0_nu.to(f32),
        tol_scale_primal=scale_p.to(f32),
        tol_scale_dual=scale_d.to(f32),
    )

    # ---- delta state: dx = 0, duals dy = 0, z = z_hat - nu_hat -----------
    zero = {n: torch.zeros_like(getattr(st1, n)) for n in
            ("vis", "fis", "nu", "w", "yis", "Aty", "fdpa", "stfw")}
    st_d = dataclasses.replace(st1, z=st1.z - st1.nu, **zero)
    return prob_d, st_d, fdpa_hat.to(f32)


def solve_two_stage(
    tree,
    params: SolverParams,
    q,
    problem: IkProblem,
    stage1_tol: float = 2e-5,
    stage1_max_iter: int = 48,
    stage2_max_iter: Optional[int] = None,
    stage2_mu: float = 1e-3,
    stage2_mu_eq_scale: float = 1e6,
    warm_state: Optional[SolverState] = None,
    fused_stage1: Optional[bool] = None,
    batch_tile: Optional[int] = None,
) -> SolveResult:
    """Solve at params.tol_abs/tol_rel with a float32 bulk and a warm
    float64 tail.  ``tree``/``q``/``problem`` may be float32 or float64; the
    outputs are float64.

    Stage 1 runs float32 at ``stage1_tol`` (capped at ``stage1_max_iter``:
    past a few times the typical count the stragglers are problems stage 2
    refines or re-certifies anyway).  Stage 2 continues EVERY problem in
    float64 from the float32 state, with its own penalties: near-optimal
    warm duals let a large mu_eq close the task residual in 1-3 iterations
    while a small mu_ineq keeps the box duals stable.  Problems certified
    primal-infeasible in stage 1 keep that verdict and skip stage 2.
    Iteration counts are the sum of both stages.

    fused_stage1: None runs stage 1 through the fused kernel wherever
    `kernels.fused.fused_eligibility` allows it and through the masked while
    loop otherwise, silently: on a tree with configuration-dependent subspaces
    this is THE tight-tolerance path, so there is no fused path to fall
    back from.  True requires the kernel (raises with the blocker's name
    when it cannot run); False runs the masked while loop.  On CPU tensors
    the fused path is the eager loop.  Stage 2 is the float64 masked while
    loop.

    On CUDA tensors everything after the validation (the casts, stage 1's
    kernel launch or while loop, the float64 stage 2) runs as ONE captured
    CUDA graph per key (`utils.graphs`, the counterpart of loik_tpu's
    `_two_stage_jit`); eagerly as `solve` is (``params.verbose``,
    `utils.disable_graphs()`, `utils.debug_nans()`, the CPU)."""
    q = _as_batch(tree, q)
    validate_problem(tree, problem)
    p1 = params.replace(
        tol_abs=max(stage1_tol, params.tol_abs),
        tol_rel=max(stage1_tol, params.tol_rel),
        max_iter=min(params.max_iter, stage1_max_iter),
    )
    p2 = params.replace(
        warm_start=True,
        max_iter=stage2_max_iter or max(20, params.max_iter // 4),
        mu=stage2_mu,
        mu_equality_scale_factor=stage2_mu_eq_scale,
        freeze_infeasible_on_warm_start=True,
    )
    if batch_tile is None:
        batch_tile = default_batch_tile(tree.njoints)
    from ..kernels.fused import fused_eligibility

    ok, reason = fused_eligibility(tree, p1, q.shape[0], batch_tile, dtype=None,
                                   num_constraints=problem.num_constraints)
    if fused_stage1 is None:
        fused_stage1 = ok
    elif fused_stage1 and not ok:
        raise ValueError(
            f"solve_two_stage: fused_stage1=True but the fused kernel cannot "
            f"run here: {reason}")
    f32, f64 = torch.float32, torch.float64
    fused_stage1 = bool(fused_stage1)

    def body(tree, q, problem, warm_state):
        with phase("solver.cast"):
            args = (tree.astype(f32), tree.astype(f64), p1, p2, q,
                    _cast_problem(problem, f32), _cast_problem(problem, f64),
                    _cast_state(warm_state, f32) if warm_state is not None else None)
        return _two_stage(*args, fused_stage1=fused_stage1, batch_tile=batch_tile)

    from ..utils import graphs

    return graphs.run("solve_two_stage", tree, (p1, p2, fused_stage1, batch_tile), body,
                      (q, problem, warm_state), capture=not params.verbose)


def _two_stage(tree32, tree64, p1, p2, q, prob32, prob64, warm_state,
               fused_stage1=False, batch_tile=16) -> SolveResult:
    """The body of loik_tpu's `_two_stage_jit`."""
    if fused_stage1:
        from ..kernels.fused import fused_loop

        loop = fused_loop(batch_tile)
    else:
        loop = _solve_loop
    with phase("solver.cast"):
        q32 = q.to(torch.float32)
    res1 = _solve_impl(tree32, p1, q32, prob32, warm_state, loop=loop)
    with phase("solver.cast"):
        q64, warm64 = q.to(torch.float64), _cast_state(res1.state, torch.float64)
    res2 = _solve_impl(tree64, p2, q64, prob64, warm64)
    with phase("solver.result"):
        return dataclasses.replace(res2, iterations=res1.iterations + res2.iterations)


def solve_delta_refined(
    tree,
    params: SolverParams,
    q,
    problem: IkProblem,
    stage1_tol: float = 2e-5,
    stage2_max_iter: Optional[int] = None,
) -> SolveResult:
    """Pure-float32 tight-tolerance solve by delta-form refinement.

    Stage 1 solves cold in float32 down to the float32 floor.  Stage 2
    re-solves for the CORRECTION dx = x - x_hat: substituting v = v_hat + dv
    shifts the QP to
        min 1/2 dx' P dx + (q + P x_hat)' dx
        s.t. A_c dv = b - A v_hat,  lb - nu_hat <= dnu <= ub - nu_hat,
    the SAME solver on a shifted problem (v_ref - v_hat, b - A v_hat, bounds
    - nu_hat), warm-started at dx = 0 with the stage-1 duals and penalties
    (the delta problem's optimal duals equal the original ones), and
    certified against the ORIGINAL problem's adaptive-tolerance scales
    (delta-space magnitudes are ~0 and would shrink the tolerance to
    tol_abs).  Infeasibility certificates are off in delta space, where
    they are degenerate.

    Both stages run the masked while loop, as loik_tpu's runs its plain
    solve; on CUDA tensors the whole refinement is ONE captured CUDA graph
    per key (`utils.graphs`), eagerly as `solve` is.  Returns results in
    the ORIGINAL problem space (nu = nu_hat + dnu, vis = v_hat + dv); the
    state is the delta stage's, as in loik_tpu."""
    q = _as_batch(tree, q)
    validate_problem(tree, problem)
    p1 = params.replace(tol_abs=max(stage1_tol, params.tol_abs),
                        tol_rel=max(stage1_tol, params.tol_rel))
    p2 = params.replace(
        warm_start=True,
        keep_mu_on_warm_start=True,
        check_feasibility=False,
        freeze_infeasible_on_warm_start=True,
        max_iter=stage2_max_iter or max(60, params.max_iter // 2),
    )
    from ..utils import graphs

    return graphs.run(
        "solve_delta_refined", tree, (p1, p2),
        lambda tree, q, problem: _delta_refined(tree.astype(torch.float32), p1, p2, q,
                                                problem),
        (q, problem), capture=not params.verbose)


def _delta_refined(tree32, p1, p2, q, problem) -> SolveResult:
    """The body of `solve_delta_refined` (loik_tpu's two `_solve_jit_delta`
    calls and the arithmetic between them)."""
    f32 = torch.float32
    with phase("solver.cast"):
        q32 = q.to(f32)
        prob32 = _cast_problem(problem, f32)
    res1 = _solve_impl(tree32, p1, q32, prob32, None)
    st1 = res1.state

    with full_f32_matmul(), phase("solver.prepare"):
        # ---- the shifted (delta) problem, batch-leading ------------------
        v_hat = st1.vis.movedim(-1, 0)                   # (B,N,6)
        nu_hat = res1.nu                                 # (B,nv)
        B = v_hat.shape[0]

        def lead(x, core_ndim):
            return x.expand((B,) + x.shape) if x.ndim == core_ndim else x

        H_l, A_l = lead(prob32.H_ref, 3), lead(prob32.A, 3)
        v_ref_l, b_l = lead(prob32.v_ref, 2), lead(prob32.b, 2)
        cl = problem.constraint_links
        v_c = torch.stack([v_hat[:, c] for c in cl], dim=1)           # (B,NC,6)
        Av_hat = (A_l @ v_c[..., None])[..., 0]
        prob_d = IkProblem(
            H_ref=H_l, v_ref=v_ref_l - v_hat, A=A_l, b=b_l - Av_hat,
            lb=lead(prob32.lb, 1) - nu_hat, ub=lead(prob32.ub, 1) - nu_hat,
            constraint_links=cl,
        )

        # ---- warm start at dx = 0 with the stage-1 duals -----------------
        warm = dataclasses.replace(st1, vis=torch.zeros_like(st1.vis),
                                   nu=torch.zeros_like(st1.nu), z=st1.z - st1.nu)
        # the original problem's adaptive-tolerance scales
        # (CheckConvergence, loik-loid-optimized.hxx:540-565)
        Href_vhat = (H_l @ v_hat[..., None])[..., 0]
        Hv0 = (H_l.transpose(-1, -2) @ v_ref_l[..., None])[..., 0]
        scale_p = torch.maximum(
            torch.maximum(Av_hat.abs().amax((1, 2)), nu_hat.abs().amax(1)),
            b_l.abs().amax((1, 2)))
        scale_d = torch.maximum(
            torch.maximum(Href_vhat.abs().amax((1, 2)), Hv0.abs().amax((1, 2))),
            torch.maximum(st1.fdpa.abs().amax((0, 1)), st1.stfw.abs().amax((0, 1))))
    res2 = _solve_impl(tree32, p2, q32, prob_d, warm, tol_scales=(scale_p, scale_d))

    # ---- recombine in the original space --------------------------------
    with phase("solver.result"):
        return dataclasses.replace(
            res2,
            nu=res2.nu + nu_hat,
            z=res2.z + nu_hat,
            vis=res2.vis + v_hat,
            iterations=res1.iterations + res2.iterations,
        )
