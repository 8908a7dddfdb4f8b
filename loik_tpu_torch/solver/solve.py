"""The batched ADMM solver in eager PyTorch.

Port of `loik_tpu.solver.solve`: one full ADMM iteration over a BATCH of
independent problems —

  FwdPass1 -> BwdPass (Riccati, leaf->root) -> FwdPass2 (root->leaf)
  -> BoxProj -> DualUpdate -> residual recursion (BwdPass2) -> convergence
  / infeasibility checks -> per-problem mu update

with the tree sweeps unrolled in Python over the static topology, the batch
as the trailing axis, and masked early exit (finished problems freeze under
a `torch.where` merge while the rest keep iterating).

This eager loop is the plain PyTorch version of the fused CUDA kernel
(`kernels/fused.py`): the CPU runs it, and on the GPU it is the twin the
kernel is checked against.  Dual infeasibility is not detected, matching the
optimized reference (loik-loid-optimized.hxx:572-606).

Joints of any dof count are handled (k x k D blocks through
`batched_spatial.spd_inv`).  For trees with configuration-dependent motion
subspaces `_solve_impl` computes the per-problem subspaces once from q
(`PreparedProblem.S_list`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..params import SolverParams
from ..problem import IkProblem, validate_problem
from ..utils.observability import phase
from . import batched_spatial as bsp
from .state import (LOG_FIELDS, PreparedProblem, SolverState, SolveResult,
                    init_state, nan_logs)


@contextlib.contextmanager
def full_f32_matmul():
    """Full-f32 matmuls (TF32 off) for the enclosed work, restoring the
    caller's setting after.  TF32 keeps ~3 decimal digits, which stalls the
    ADMM recursion far above tolerance; the solver's own 6x6 products are
    elementwise (batched_spatial.py), so this guards the FK's `@` products
    — the analog of `jax.default_matmul_precision("highest")` in
    loik_tpu (solve.py:734-737)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


# --------------------------------------------------------------------------- #
# problem preparation (SolveInit phase)
# --------------------------------------------------------------------------- #


def _to_trailing(x, batch: int, core_ndim: int):
    """Broadcast a possibly-unbatched leaf to (core..., B) trailing layout."""
    if x.ndim == core_ndim:  # unbatched: share across batch
        return x.unsqueeze(-1).expand(x.shape + (batch,))
    return x.movedim(0, -1)  # leading batch -> trailing


def prepare_problem(tree, problem: IkProblem, B: int, dtype) -> PreparedProblem:
    """Precompute Hv, AtA, Atb and norms once per solve — the analog of
    `IkProblemFormulationOptimized::UpdateReference/UpdateEqConstraints`
    (ik-id-description-optimized.hpp:78-171)."""
    N, K = tree.njoints, tree.nv_max
    H_ref = _to_trailing(problem.H_ref, B, 3).to(dtype)   # (N,6,6,B)
    v_ref = _to_trailing(problem.v_ref, B, 2).to(dtype)   # (N,6,B)
    A = _to_trailing(problem.A, B, 3).to(dtype)           # (NC,6,6,B)
    b = _to_trailing(problem.b, B, 2).to(dtype)           # (NC,6,B)
    lb = _to_trailing(problem.lb, B, 1).to(dtype)         # (nv,B)
    ub = _to_trailing(problem.ub, B, 1).to(dtype)

    Hv = bsp.mtv(H_ref, v_ref)                            # H_ref^T v_ref

    def pad_dofs(flat):  # flat (nv,B) -> padded (N,K,B); padding slots stay 0
        out = torch.zeros((N, K, B), dtype=dtype, device=flat.device)
        for i in range(N):
            iv, k = tree.idx_v[i], tree.nvs[i]
            out[i, :k] = flat[iv: iv + k]
        return out

    return PreparedProblem(
        H_ref=H_ref, Hv=Hv, A=A, b=b,
        AtA=bsp.mtm(A, A), Atb=bsp.mtv(A, b),
        lb=pad_dofs(lb), ub=pad_dofs(ub),
        b_inf=bsp.inf_norm_b(b), Hv_inf=bsp.inf_norm_b(Hv),
        constraint_links=problem.constraint_links,
    )


def fwd_pass_init(tree, q):
    """FK: liMi per joint in trailing-batch layout.  q (B, nq).
    (FwdPassInit, loik-loid-optimized.hxx:253-283.)"""
    lR, lp, _, _ = tree.fwd_kinematics(q)  # (B,N,3,3), (B,N,3)
    return lR.movedim(0, -1), lp.movedim(0, -1)


# --------------------------------------------------------------------------- #
# one full ADMM iteration (all problems, unmasked)
# --------------------------------------------------------------------------- #


def _S_lists(tree, prob: PreparedProblem, dtype):
    """Per-joint motion subspaces, exact dof sizes: the prepared problem's
    per-problem (6, k, B) tiles when the tree has configuration-dependent
    subspaces (`S_list`) or batched geometry (`S_all`, uniform k), else the
    constant (6, k, 1), whose trailing axis of 1 broadcasts against the
    batch.  A batched-geometry tree without `S_all` gives its (B, 6, k)
    subspaces with the batch moved to the trailing axis: the same values."""
    if prob.S_list is not None:
        return list(prob.S_list)
    if prob.S_all is not None:
        return [prob.S_all[i] for i in range(tree.njoints)]

    def tile(i):
        Si = tree.joint_S(i).to(dtype)
        return Si.movedim(0, -1) if Si.ndim == 3 else Si[:, :, None]

    return [tile(i) for i in range(tree.njoints)]


def q_dependent_S_list(tree, q, dtype):
    """The per-problem subspaces of a tree with configuration-dependent S,
    from q (B, nq): one exact-size (6, nv_i, B) tile per joint (constant
    joints are shared across the batch).  Iteration-constant, like liMi."""
    B = q.shape[0]
    S_list = []
    for i in range(tree.njoints):
        Si = tree.joint_S(i, q).to(dtype)
        if Si.ndim == 2:  # constant joint: share across the batch
            Si = Si[:, :, None].expand(Si.shape + (B,))
        else:             # (B, 6, k) -> (6, k, B)
            Si = Si.movedim(0, -1)
        S_list.append(Si)
    return tuple(S_list)


def _h_sweep(tree, prob: PreparedProblem, params: SolverParams,
             st: SolverState, S):
    """The mu-dependent half of the backward Riccati sweep: accumulated His,
    U = H S, D^-1 and U D^-1 per joint (calc_aba quantities,
    loik-loid-optimized.hxx:21-83).  Depends only on (mu_eq, mu_ineq) and the
    iteration-constant geometry — not on the duals or p."""
    N = tree.njoints
    dtype, dev = st.vis.dtype, st.vis.device
    nvs, parents = tree.nvs, tree.parents
    mu_eq, mu_ineq = st.mu_eq, st.mu_ineq
    eye6 = torch.eye(6, dtype=dtype, device=dev)[:, :, None]

    H = params.rho * eye6 + prob.H_ref             # (N,6,6,B)
    H_list = [H[i] for i in range(N)]
    for k, c in enumerate(prob.constraint_links):
        H_list[c] = H_list[c] + mu_eq * prob.AtA[k]

    Dinv = [None] * N
    U = [None] * N
    UDinv = [None] * N
    for i in reversed(range(N)):
        Si = S[i]
        k = nvs[i]
        Hi = H_list[i]       # (6,6,B) accumulated (children already added)
        Ui = bsp.mm(Hi, Si)                                # H S    (6,k,B)
        Di = bsp.mtm(Si, Ui)                               # S^T H S (k,k,B)
        Di = Di + mu_ineq * torch.eye(k, dtype=dtype, device=dev)[:, :, None]
        Dinv_i = bsp.spd_inv(Di)
        Dinv[i], U[i] = Dinv_i, Ui
        par = parents[i]
        if par >= 0:
            UDinv[i] = bsp.mm(Ui, Dinv_i)                      # (6,k,B)
            Ha = Hi - bsp.mmt(UDinv[i], Ui)                    # H - U D^-1 U^T
            H_list[par] = H_list[par] + bsp.act_sym6(
                st.liMi_R[i], st.liMi_p[i], Ha
            )
    return H_list, U, Dinv, UDinv


def _pad_k(x, K):
    """(k, B) -> (K, B), zero-padded dof slots."""
    return F.pad(x, (0, 0, 0, K - x.shape[0]))


def _iteration(tree, prob: PreparedProblem, params: SolverParams, st: SolverState,
               debug: bool = False, compute_checks: bool = True,
               h_cache=None):
    """Compute one ADMM iteration for every problem in the batch; returns the
    pieces needed for flag/penalty updates.  Pure function of the state.

    debug=True additionally returns every per-pass intermediate in
    ``checks["debug"]`` (the keys of `loik_tpu`'s), for the pass-by-pass
    lockstep test.

    compute_checks=False runs only the iterate updates and returns
    ``(partial_new, None)`` with just {vis, fis, nu, z, w, yis, Aty} — the
    skipped-iteration form of ``params.check_interval > 1``.

    h_cache: optional precomputed ``(S, _h_sweep(...))`` tuple, shared by the
    micro-iterations of one check_interval body call."""
    N, K = tree.njoints, tree.nv_max
    dtype, dev = st.vis.dtype, st.vis.device
    B = st.vis.shape[-1]
    S = h_cache[0] if h_cache is not None else _S_lists(tree, prob, dtype)
    nvs, parents = tree.nvs, tree.parents
    c_links = prob.constraint_links
    mu_eq = st.mu_eq  # (B,)
    mu_ineq = st.mu_ineq
    rho = params.rho

    # ---------------- FwdPass1 (loik-loid-optimized.hxx:290-338) ----------
    r = st.w - mu_ineq * st.z                      # (N,K,B)
    if prob.r_offset is not None:  # delta-duals nu-block linear term
        r = r + prob.r_offset
    p = -rho * st.vis - prob.Hv                    # vis == vis_prev at entry
    p_list = [p[i] for i in range(N)]
    for k, c in enumerate(c_links):
        p_list[c] = p_list[c] + st.Aty[k] - mu_eq * prob.Atb[k]
    lR = [st.liMi_R[i] for i in range(N)]
    lp = [st.liMi_p[i] for i in range(N)]
    dbg = {}
    if debug:  # post-FwdPass1 snapshot (pre-accumulation H rebuilt)
        H0 = rho * torch.eye(6, dtype=dtype, device=dev)[:, :, None] + prob.H_ref
        H0_list = [H0[i] for i in range(N)]
        for k, c in enumerate(c_links):
            H0_list[c] = H0_list[c] + mu_eq * prob.AtA[k]
        dbg["H_fwd1"] = H0_list
        dbg["p_fwd1"] = list(p_list)
        dbg["r_fwd1"] = r

    # ---------------- BwdPass: backward Riccati sweep ---------------------
    if h_cache is not None:
        H_list, U, Dinv, UDinv = h_cache[1]
    else:
        H_list, U, Dinv, UDinv = _h_sweep(tree, prob, params, st, S)
    r_tot = [None] * N
    for i in reversed(range(N)):
        k = nvs[i]
        pi = p_list[i]       # (6,B) accumulated (children already added)
        ri = r[i, :k] + bsp.mtv(S[i], pi)                  # r + S^T p  (k,B)
        r_tot[i] = ri
        par = parents[i]
        if par >= 0:
            pa = pi - bsp.mv(UDinv[i], ri)                     # p - U D^-1 r
            p_list[par] = p_list[par] + bsp.act_force(lR[i], lp[i], pa)

    if debug:  # post-BwdPass: accumulated Riccati quantities
        dbg["H_bwd"] = list(H_list)
        dbg["p_bwd"] = list(p_list)
        dbg["Dinv"] = list(Dinv)
        dbg["r_tot"] = list(r_tot)

    # ---------------- FwdPass2 (loik-loid-optimized.hxx:91-165) -----------
    vis_new_list = [None] * N
    fis_new_list = [None] * N
    nu_new_list = [None] * N
    zero6 = torch.zeros((6, B), dtype=dtype, device=dev)
    for i in range(N):
        par = parents[i]
        v_par = vis_new_list[par] if par >= 0 else zero6
        v_par_loc = bsp.act_inv_motion(lR[i], lp[i], v_par)     # (6,B)
        rhs = bsp.mtv(U[i], v_par_loc) + r_tot[i]
        nui = -bsp.mv(Dinv[i], rhs)                             # (k,B)
        vi = v_par_loc + bsp.mv(S[i], nui)
        fi = bsp.mv(H_list[i], vi) + p_list[i]
        vis_new_list[i] = vi
        fis_new_list[i] = fi
        nu_new_list[i] = _pad_k(nui, K)
    vis_new = torch.stack(vis_new_list)
    fis_new = torch.stack(fis_new_list)
    nu_new = torch.stack(nu_new_list)                           # (N,K,B)

    # ---------------- BoxProj (loik-loid-optimized.hxx:384-397) -----------
    z_new = torch.clamp(nu_new + st.w / mu_ineq, prob.lb, prob.ub)

    # ---------------- DualUpdate (loik-loid-optimized.hxx:404-461) --------
    Av_minus_b = torch.stack(
        [bsp.mv(prob.A[k], vis_new[c]) - prob.b[k] for k, c in enumerate(c_links)]
    )  # (NC,6,B)
    delta_yis = mu_eq * Av_minus_b
    yis_new = st.yis + delta_yis
    Aty_new = bsp.mtv(prob.A, yis_new)
    delta_w = mu_ineq * (nu_new - z_new)
    w_new = st.w + delta_w

    if not compute_checks:  # skipped iteration of check_interval > 1
        return dict(vis=vis_new, fis=fis_new, nu=nu_new, z=z_new,
                    w=w_new, yis=yis_new, Aty=Aty_new), None

    delta_fis = fis_new - st.fis
    delta_vis_inf = bsp.inf_norm_b(vis_new - st.vis)
    delta_nu_inf = bsp.inf_norm_b(nu_new - st.nu)
    nu_inf = bsp.inf_norm_b(nu_new)
    delta_z_inf = bsp.inf_norm_b(z_new - st.z)
    Av_inf = torch.stack([bsp.inf_norm_b(bsp.mv(prob.A[k], vis_new[c]))
                          for k, c in enumerate(c_links)]).amax(0)
    bT_dy_plus = bsp.sum_lead(prob.b * delta_yis.clamp_min(0))
    bT_dy_minus = bsp.sum_lead(prob.b * delta_yis.clamp_max(0))
    ubT_dw_plus = bsp.sum_lead(prob.ub * delta_w.clamp_min(0))
    lbT_dw_minus = bsp.sum_lead(prob.lb * delta_w.clamp_max(0))

    # ---------------- primal residual ------------------------------------
    pr_slack = nu_new - z_new
    primal_residual_task = bsp.inf_norm_b(Av_minus_b)
    primal_residual_slack = bsp.inf_norm_b(pr_slack)
    primal_residual = torch.maximum(primal_residual_task, primal_residual_slack)

    # ---------------- dual residual: BwdPass2 recursion -------------------
    # fdpa[i] = (A^T y)_i - f_i + sum_children X* f_child ; stfw = S^T f + w
    # (loik-loid-optimized.hxx:173-243 + DualUpdate seeding :435-439)
    fdpa_list = [torch.zeros((6, B), dtype=dtype, device=dev) for _ in range(N)]
    for k, c in enumerate(c_links):
        fdpa_list[c] = Aty_new[k]
    for i in reversed(range(N)):
        fdpa_list[i] = fdpa_list[i] - fis_new[i]
        par = parents[i]
        if par >= 0:
            fdpa_list[par] = fdpa_list[par] + bsp.act_force(lR[i], lp[i], fis_new[i])
    fdpa_new = torch.stack(fdpa_list)
    stfw_new_list = []
    for i in range(N):
        k = nvs[i]
        stf = bsp.mtv(S[i], fis_new[i]) + w_new[i, :k]
        if prob.r_offset is not None:
            stf = stf + prob.r_offset[i, :k]
        stfw_new_list.append(_pad_k(stf, K))
    stfw_new = torch.stack(stfw_new_list)

    Href_v = bsp.mv(prob.H_ref, vis_new)                        # (N,6,B)
    dr_v = Href_v - prob.Hv + fdpa_new
    dual_residual_v = bsp.inf_norm_b(dr_v)
    dual_residual_nu = bsp.inf_norm_b(stfw_new)
    dual_residual = torch.maximum(dual_residual_v, dual_residual_nu)

    # ---------------- adaptive tolerances (loik-loid-optimized.hxx:540-565)
    scale_primal = torch.maximum(torch.maximum(Av_inf, nu_inf), prob.b_inf)
    scale_dual = torch.maximum(
        torch.maximum(bsp.inf_norm_b(Href_v), prob.Hv_inf),
        torch.maximum(bsp.inf_norm_b(fdpa_new), bsp.inf_norm_b(stfw_new)),
    )
    if prob.tol_scale_primal is not None:
        # delta-form refinement: certify against the ORIGINAL problem's
        # scales (delta magnitudes are ~0; see PreparedProblem)
        scale_primal = torch.maximum(scale_primal, prob.tol_scale_primal)
        scale_dual = torch.maximum(scale_dual, prob.tol_scale_dual)
    tol_primal = params.tol_abs + params.tol_rel * scale_primal
    tol_dual = params.tol_abs + params.tol_rel * scale_dual

    # ---------------- infeasibility certificate pieces --------------------
    # (loik-loid-optimized.hxx:572-606)
    delta_y_inf = torch.maximum(
        bsp.inf_norm_b(delta_fis),
        torch.maximum(bsp.inf_norm_b(delta_yis), bsp.inf_norm_b(delta_w)),
    )
    At_dy_inf = torch.maximum(
        bsp.inf_norm_b(fdpa_new - st.fdpa), bsp.inf_norm_b(stfw_new - st.stfw)
    )
    pinf_cond1 = At_dy_inf <= params.tol_primal_inf * delta_y_inf
    pinf_cond2 = (
        bT_dy_plus + ubT_dw_plus + bT_dy_minus + lbT_dw_minus
    ) <= params.tol_primal_inf * delta_y_inf
    primal_infeasible_now = pinf_cond1 & pinf_cond2

    delta_x_inf = torch.maximum(delta_vis_inf, delta_nu_inf)

    new = dict(
        vis=vis_new, fis=fis_new, nu=nu_new, z=z_new, w=w_new,
        yis=yis_new, Aty=Aty_new, fdpa=fdpa_new, stfw=stfw_new,
        primal_residual=primal_residual, dual_residual=dual_residual,
        delta_x_inf=delta_x_inf, delta_z_inf=delta_z_inf,
    )
    checks = dict(
        tol_primal=tol_primal, tol_dual=tol_dual,
        primal_infeasible_now=primal_infeasible_now,
        primal_residual_task=primal_residual_task,
        primal_residual_slack=primal_residual_slack,
        dual_residual_v=dual_residual_v,
        dual_residual_nu=dual_residual_nu,
    )
    if debug:
        dbg.update(
            delta_yis=delta_yis, delta_w=delta_w, Av_minus_b=Av_minus_b,
            primal_residual_task=primal_residual_task,
            primal_residual_slack=primal_residual_slack,
            dual_residual_v=dual_residual_v,
            dual_residual_nu=dual_residual_nu,
            dr_v=dr_v,
            pinf_cond1=pinf_cond1, pinf_cond2=pinf_cond2,
            delta_y_inf=delta_y_inf, At_dy_inf=At_dy_inf,
        )
        checks["debug"] = dbg
    return new, checks


def kkt_residual(tree, prob: PreparedProblem, st: SolverState):
    """Dual-side KKT residual d0 = P x + q + A' y at the state's point,
    per-block: ``(d0_v (N,6,B), d0_nu (N,K,B), fdpa (N,6,B))``, evaluated
    via the recursive fdpa/stfw identities (loik-loid-optimized.hxx:173-243).
    Run in f64 on a cast state, this is the one-shot linear term of the
    delta-duals refinement."""
    N, K = tree.njoints, tree.nv_max
    dtype, dev = st.vis.dtype, st.vis.device
    B = st.vis.shape[-1]
    S = _S_lists(tree, prob, dtype)

    fdpa_list = [torch.zeros((6, B), dtype=dtype, device=dev) for _ in range(N)]
    for k, c in enumerate(prob.constraint_links):
        fdpa_list[c] = st.Aty[k]
    for i in reversed(range(N)):
        fdpa_list[i] = fdpa_list[i] - st.fis[i]
        par = tree.parents[i]
        if par >= 0:
            fdpa_list[par] = fdpa_list[par] + bsp.act_force(
                st.liMi_R[i], st.liMi_p[i], st.fis[i]
            )
    fdpa = torch.stack(fdpa_list)
    d0_v = bsp.mv(prob.H_ref, st.vis) - prob.Hv + fdpa

    stfw_list = []
    for i in range(N):
        k = tree.nvs[i]
        stf = bsp.mtv(S[i], st.fis[i]) + st.w[i, :k]
        stfw_list.append(_pad_k(stf, K))
    d0_nu = torch.stack(stfw_list)
    return d0_v, d0_nu, fdpa


# --------------------------------------------------------------------------- #
# masked while-loop driver
# --------------------------------------------------------------------------- #


def make_loop_body(tree, prob: PreparedProblem, params: SolverParams):
    """One body call — K = check_interval ADMM iterations plus the
    flag/penalty transitions — as a pure SolverState -> SolverState
    function.  The CUDA kernel runs the same body per problem."""
    from ..utils.graphs import write_row

    max_iter = params.max_iter
    K = params.check_interval

    def body(st: SolverState) -> SolverState:
        i = st.it + K
        active = st.running                      # (B,)
        # check_interval > 1: K-1 check-free ADMM iterations, then one full
        # iteration with residuals/flags.  Frozen problems advance through
        # the micro-iterations too but are restored wholesale by the single
        # masked merge below (the mask is constant within the body).
        cur = st
        if K > 1:
            # hoist the Riccati matrix half: (mu_eq, mu_ineq, liMi) are
            # constant across the K micro-iterations, so S and the H-sweep
            # are computed once per body call and shared
            S_h = _S_lists(tree, prob, st.vis.dtype)
            hc = (S_h, _h_sweep(tree, prob, params, st, S_h))
        else:
            hc = None
        for _ in range(K - 1):
            partial, _ = _iteration(tree, prob, params, cur,
                                    compute_checks=False, h_cache=hc)
            cur = dataclasses.replace(cur, **partial)
        new, checks = _iteration(tree, prob, params, cur, h_cache=hc)

        # --- flag transitions -------------------------------------------
        # normal-mode problems: convergence first, then feasibility (iter>1),
        # then mu update (loik-loid-optimized.hpp:417-452)
        normal = active & ~st.in_tail
        conv_now = (
            normal
            & (new["primal_residual"] < checks["tol_primal"])
            & (new["dual_residual"] < checks["tol_dual"])
        )
        if params.check_feasibility:
            pinf_now = normal & ~conv_now & (i > 1) & checks["primal_infeasible_now"]
        else:
            pinf_now = torch.zeros_like(normal)
        if params.tail_solve:
            in_tail_next = st.in_tail | pinf_now
        else:
            in_tail_next = st.in_tail

        # tail-mode termination: iterates stopped moving
        # (while-condition of InfeasibilityTailSolve)
        tail_done = (
            active
            & in_tail_next
            & (new["delta_x_inf"] < params.tol_tail_solve)
            & (new["delta_z_inf"] < params.tol_tail_solve)
        )

        # mu update only for problems continuing in normal mode
        do_mu = normal & ~conv_now & ~pinf_now
        rp, rd = new["primal_residual"], new["dual_residual"]
        mu_next = torch.where(
            rp > 10.0 * rd, st.mu * 10.0,
            torch.where(rd > 10.0 * rp, st.mu * 0.1, st.mu),
        )
        # clamp: repeated x0.1 under a residual floor underflows f32 to zero
        # (then w / mu_ineq = inf); the reference never hits this in double
        mu_next = torch.clamp(mu_next, 1e-12, 1e12)
        mu_next = torch.where(do_mu, mu_next, st.mu)
        mu_eq_next = torch.where(
            do_mu, params.mu_equality_scale_factor * mu_next, st.mu_eq)
        mu_ineq_next = torch.where(do_mu, mu_next, st.mu_ineq)

        # iteration budget: main loop runs i <= max_iter-1; tail runs i <= max_iter
        budget_next = (in_tail_next & (i + K <= max_iter)) | (
            ~in_tail_next & (i + K <= max_iter - 1)
        )
        running_next = active & ~conv_now & ~tail_done & budget_next
        if not params.tail_solve:
            running_next = running_next & ~pinf_now

        # --- merge (freeze finished problems) ---------------------------
        merged = {k: torch.where(active, v, getattr(st, k)) for k, v in new.items()}
        updates = dict(
            merged,
            mu=mu_next,
            mu_eq=mu_eq_next,
            mu_ineq=mu_ineq_next,
            converged=st.converged | conv_now,
            primal_infeasible=st.primal_infeasible | pinf_now,
            in_tail=in_tail_next,
            running=running_next,
            iterations=torch.where(active, i, st.iterations),
            # tail iterations count only the passes AFTER detection
            tail_iterations=torch.where(
                active & st.in_tail, st.tail_iterations + K, st.tail_iterations
            ),
            it=i,
        )
        if params.logging and max_iter > 0:
            # row i-1 of each log, written at an index that stays on the
            # device (in place inside a WHILE node's body, `write_row`);
            # i > max_iter happens only on the first body call when
            # K > max_iter, where loik_tpu's scatter drops the write: here
            # NaN goes into a row that is still NaN
            row = (i - 1).clamp(max=max_iter - 1).reshape(1).long()
            logged = active & (i <= max_iter)

            def logset(arr, val):
                return write_row(arr, row, torch.where(logged, val, float("nan"))[None])

            for name, val in (
                ("log_rp", new["primal_residual"]),
                ("log_rd", new["dual_residual"]),
                ("log_mu", st.mu),
                # per-block components + penalty split + tail diagnostics
                # (LoikSolverInfo parity, loik-loid.hpp:98-121)
                ("log_rp_task", checks["primal_residual_task"]),
                ("log_rp_slack", checks["primal_residual_slack"]),
                ("log_rd_v", checks["dual_residual_v"]),
                ("log_rd_nu", checks["dual_residual_nu"]),
                ("log_mu_eq", st.mu_eq),
                ("log_mu_ineq", st.mu_ineq),
                ("log_in_tail", st.in_tail.to(st.mu.dtype)),
                ("log_dx", new["delta_x_inf"]),
                ("log_dz", new["delta_z_inf"]),
            ):
                updates[name] = logset(getattr(st, name), val)
        if params.verbose:
            # iteration banner (the reference's verbose_ stream prints one
            # per iteration, loik-loid.hpp:501-506; batched -> aggregates
            # over the problems still active).  Reads the device.
            rp_max = torch.where(active, new["primal_residual"], 0.0).max()
            rd_max = torch.where(active, new["dual_residual"], 0.0).max()
            print(f"[loik] iter {int(i)}: primal res {float(rp_max):.3e}, "
                  f"dual res {float(rd_max):.3e}, "
                  f"running {int(running_next.sum())}", flush=True)
        return dataclasses.replace(st, **updates)

    return body


def _any_running(st: SolverState) -> torch.Tensor:
    return st.running.any()


def _solve_loop(tree, prob: PreparedProblem, params: SolverParams, st: SolverState):
    """Run the ADMM main loop + per-problem infeasibility tail solves with
    masked termination (Solve, loik-loid-optimized.hpp:368-455 +
    InfeasibilityTailSolve :266-319) — one `utils.graphs.while_loop` over
    the shared `make_loop_body`, the counterpart of loik_tpu's
    `lax.while_loop`: inside an entry point's CUDA graph a WHILE node that
    reads nothing on the host, elsewhere a host loop that reads the running
    mask once per body call."""
    from ..utils import graphs

    return graphs.while_loop(_any_running, make_loop_body(tree, prob, params), st)


# --------------------------------------------------------------------------- #
# public API
# --------------------------------------------------------------------------- #


def _reset_state(tree, params: SolverParams, st: SolverState, dtype) -> SolverState:
    """ResetSolver + conditional warm-start wipe
    (loik-loid-optimized.hpp:168-186, loik-loid-data-optimized.hxx:114-127)."""
    B = st.mu.shape[0]
    dev = st.mu.device
    if params.warm_start and params.keep_mu_on_warm_start:
        mu0 = st.mu.to(dtype)
    else:
        mu0 = torch.full((B,), params.mu, dtype=dtype, device=dev)
    if params.warm_start and params.freeze_infeasible_on_warm_start:
        keep_pinf = st.primal_infeasible
        running0 = ~st.primal_infeasible
    else:
        keep_pinf = torch.zeros((B,), dtype=torch.bool, device=dev)
        running0 = torch.ones((B,), dtype=torch.bool, device=dev)
    zeros_b = torch.zeros((B,), dtype=dtype, device=dev)
    inf_b = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    upd = dict(
        mu=mu0,
        mu_eq=params.mu_equality_scale_factor * mu0,
        mu_ineq=mu0,
        iterations=torch.zeros((B,), dtype=torch.int32, device=dev),
        tail_iterations=torch.zeros((B,), dtype=torch.int32, device=dev),
        converged=torch.zeros((B,), dtype=torch.bool, device=dev),
        primal_infeasible=keep_pinf,
        dual_infeasible=torch.zeros((B,), dtype=torch.bool, device=dev),
        in_tail=torch.zeros((B,), dtype=torch.bool, device=dev),
        running=running0,
        primal_residual=inf_b,
        dual_residual=inf_b.clone(),
        delta_x_inf=zeros_b,
        delta_z_inf=zeros_b.clone(),
        it=torch.zeros((), dtype=torch.int32, device=dev),
    )
    if not params.warm_start:
        upd.update({name: torch.zeros_like(getattr(st, name)) for name in
                    ("vis", "fis", "nu", "z", "w", "yis", "Aty", "fdpa", "stfw")})
    if params.logging:
        upd.update(nan_logs(params.max_iter, B, dtype, dev))
    return dataclasses.replace(st, **upd)


def _flat_nu(tree, padded):
    """(N,K,B) padded dof array -> (B, nv) flat joint velocities.  Slices
    only: an index tensor would be a host-to-device copy, which blocks the
    host, in every solve and every tracking tick."""
    N, K = padded.shape[0], padded.shape[1]
    if tree.nv == N * K:  # every joint fills its slots (1-dof chains)
        return padded.reshape(N * K, -1).movedim(-1, 0)
    return torch.cat([padded[i, :k] for i, k in enumerate(tree.nvs)]).movedim(-1, 0)


def _result(tree, st: SolverState) -> SolveResult:
    """Batch-leading SolveResult of a final trailing-batch state."""
    return SolveResult(
        nu=_flat_nu(tree, st.nu),
        z=_flat_nu(tree, st.z),
        vis=st.vis.movedim(-1, 0),
        converged=st.converged,
        primal_infeasible=st.primal_infeasible,
        dual_infeasible=st.dual_infeasible,
        iterations=st.iterations,
        tail_iterations=st.tail_iterations,
        primal_residual=st.primal_residual,
        dual_residual=st.dual_residual,
        state=st,
        **{name: getattr(st, name) for name in LOG_FIELDS},
    )


def _announce(st: SolverState) -> None:
    """The verbose terminal notices (the reference's verbose_ convergence
    message and warnings, loik-loid.hxx:320 converged / :345 infeasible /
    :362 max-iter), batched: counts over the batch.  Reads the device."""
    n_conv = int(st.converged.sum())
    n_pinf = int(st.primal_infeasible.sum())
    n_unconv = int((~st.converged & ~st.primal_infeasible).sum())
    print(f"[loik] solve finished: {n_conv} converged, max iterations "
          f"{int(st.iterations.max())}", flush=True)
    if n_pinf > 0:
        print(f"[loik] WARNING: {n_pinf} problem(s) certified primal infeasible",
              flush=True)
    if n_unconv > 0:
        print(f"[loik] WARNING: {n_unconv} problem(s) hit max_iter without "
              "converging", flush=True)


def _as_batch(tree, q) -> torch.Tensor:
    """q as a (B, nq) tensor on the tree's device, checked against nq."""
    q = torch.as_tensor(q, device=tree.device)
    if q.ndim == 1:
        q = q[None]  # results stay batched (callers index [0])
    if q.shape[-1] != tree.nq:
        raise ValueError(
            f"q has {q.shape[-1]} configuration entries; model '{tree.name}' "
            f"has nq={tree.nq}"
        )
    return q


def _solve_impl(tree, params: SolverParams, q, problem: IkProblem,
                warm_state: Optional[SolverState], loop=_solve_loop,
                liMi=None, tol_scales=None) -> SolveResult:
    """FK, prepare, reset, then ``loop`` (the eager loop here; the fused
    kernel's wrapper in `kernels/fused.py`) on the trailing-batch state.

    liMi: ``(liMi_R, liMi_p)`` from `fwd_pass_init` when the caller froze FK
    (the SolveInit/Solve split, loik-loid-optimized.hpp:335-361); q may then
    be None, except for trees with configuration-dependent subspaces.

    tol_scales: ``(primal, dual)`` (B,) floors of the adaptive-tolerance
    scales, the ORIGINAL problem's, for a solve of a delta problem
    (`refine.solve_delta_refined`).

    Its phases (`utils.observability.phase`): ``solver.fk``,
    ``solver.prepare``, ``solver.reset``, ``solver.loop``,
    ``solver.result``."""
    with full_f32_matmul():
        if liMi is None:
            dtype, B, dev = q.dtype, q.shape[0], q.device
            with phase("solver.fk"):
                liMi_R, liMi_p = fwd_pass_init(tree, q)
        else:
            liMi_R, liMi_p = liMi
            dtype, B, dev = liMi_R.dtype, liMi_R.shape[-1], liMi_R.device
        with phase("solver.prepare"):
            prob = prepare_problem(tree, problem, B, dtype)
            if tree.has_q_dependent_S:
                if q is None:
                    raise ValueError(
                        "trees with configuration-dependent motion subspaces "
                        "(universal joints) need q: the SolveInit/Solve FK-frozen "
                        "split cannot reconstruct S from liMi — use solve()"
                    )
                prob = dataclasses.replace(
                    prob, S_list=q_dependent_S_list(tree, q, dtype))
            if tol_scales is not None:
                prob = dataclasses.replace(
                    prob,
                    tol_scale_primal=torch.as_tensor(tol_scales[0], dtype=dtype, device=dev),
                    tol_scale_dual=torch.as_tensor(tol_scales[1], dtype=dtype, device=dev))
            if warm_state is None:
                st = init_state(tree, B, problem.num_constraints, dtype, dev,
                                params.max_iter, params.logging)
            else:
                st = warm_state
        with phase("solver.reset"):
            st = _reset_state(tree, params, st, dtype)
            st = dataclasses.replace(st, liMi_R=liMi_R, liMi_p=liMi_p)
        with phase("solver.loop"):
            st = loop(tree, prob, params, st)
    if params.verbose:
        _announce(st)
    with phase("solver.result"):
        return _result(tree, st)


def solve_from_fk(tree, params: SolverParams, liMi_R, liMi_p,
                  problem: IkProblem,
                  warm_state: Optional[SolverState] = None) -> SolveResult:
    """Solve with FK frozen: takes (liMi_R, liMi_p) from `fwd_pass_init`
    instead of q, so repeated re-solves never redo the FK sweep — the
    `SolveInit()` + `Solve()` split of the reference
    (loik-loid-optimized.hpp:335-361).  Captured as `solve` is."""
    from ..utils import graphs

    def body(tree, liMi_R, liMi_p, problem, warm_state):
        return _solve_impl(tree, params, None, problem, warm_state, liMi=(liMi_R, liMi_p))

    return graphs.run("solve_from_fk", tree, (params,), body,
                      (liMi_R, liMi_p, problem, warm_state), capture=not params.verbose)


def solve(tree, params: SolverParams, q, problem: IkProblem,
          warm_state: Optional[SolverState] = None) -> SolveResult:
    """Solve a batch of constrained differential-IK problems.

    Args:
      tree: KinematicTree (its device and dtype set those of the solve's
        geometry; q must be on the same device).
      params: SolverParams.
      q: (B, nq) or (nq,) joint configurations.
      problem: IkProblem; leaves either unbatched (shared) or leading-batch.
      warm_state: previous SolverState to warm start from (pass
        `params.replace(warm_start=True)` for reference-exact behavior).

    Returns a SolveResult with leading-batch tensors.

    On CUDA tensors FK, prepare, reset, the masked while loop (a WHILE
    node, `utils.graphs.while_loop`) and the result run as ONE captured CUDA
    graph per key (`utils.graphs`, the counterpart of loik_tpu's
    `_solve_jit`), with no host read.  Eagerly, the loop reading the
    running mask on the host every body call: on the CPU, under
    `utils.disable_graphs()` or `utils.debug_nans()`, for inputs that
    require a gradient, and with ``params.verbose``, which prints from the
    host every body call (loik_tpu's `jax.debug.print` has no counterpart
    inside a graph).  ``params.logging`` is captured: its rows are written
    at an index that stays on the device.
    """
    validate_problem(tree, problem)
    from ..utils import graphs

    def body(tree, q, problem, warm_state):
        return _solve_impl(tree, params, q, problem, warm_state)

    return graphs.run("solve", tree, (params,), body,
                      (_as_batch(tree, q), problem, warm_state), capture=not params.verbose)
