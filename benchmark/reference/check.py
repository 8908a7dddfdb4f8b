"""The plain reference of a batch of IK problems, and the comparison that
decides `correct`.

Each problem is the solver's QP written out densely: with H_ref = I and
v_ref = 0 on every link, the objective is 1/2 sum_i |J_i nu|^2, the task
rows are A_k J_{c_k} nu = b_k, the box lb <= nu <= ub.  `reference.qp`
solves it in float64 (or, for a control, in a lower precision), and each
answer of the program is judged by what it says, in float64 on the
reference's own kinematics:

- ``residual``: over the problems the program flags converged, the largest
  task residual |A J_c nu - b|_inf or box violation: a converged answer
  claims to meet the task and the box;
- ``nu_err_p99``: over the same problems, the 99th percentile of
  |nu - nu*|_inf / max(1, |nu*|_inf) against the reference's optimum nu*
  (a flagged problem that the reference cannot solve counts as infinitely
  wrong): a converged answer claims to be the optimum.  A percentile and
  not the largest: on the few problems near a singular configuration the
  optimum moves far for a residual at the tolerance, and the largest error
  swings from seed to seed by orders of magnitude;
- ``missed``: the share of the problems the reference solves that the
  program does not answer: not flagged converged, or flagged with a
  residual over the cell's limit on ``residual``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from . import kinematics, qp

DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}
RES_STEPS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2)


def qp_matrices(robot: kinematics.Robot, links: List[str], q: torch.Tensor, A: torch.Tensor,
                b: torch.Tensor, lo: float, hi: float, dtype=torch.float64):
    """(M, g, C, d, l, u) of the batch q (B, nq); A (NC, 6, 6), b (B, NC, 6)
    or (NC, 6); in the reference's dof order, computed in ``dtype``."""
    J = kinematics.jacobians(robot, q, dtype)
    B, nv = q.shape[0], robot.nv
    M = sum(Ji.transpose(-1, -2) @ Ji for Ji in J)
    rows = [A[k].to(dtype) @ J[robot.names.index(name)] for k, name in enumerate(links)]
    C = torch.cat(rows, -2)
    d = b.to(dtype).expand(B, *b.shape[-2:]).reshape(B, -1)
    g = torch.zeros((B, nv), dtype=dtype, device=q.device)
    l = torch.full((B, nv), lo, dtype=dtype, device=q.device)
    u = torch.full((B, nv), hi, dtype=dtype, device=q.device)
    return M, g, C, d, l, u


def optimum(robot, links, q, A, b, lo, hi, precision: str = "float64"):
    """(nu* (B, nv) float64, solved (B,)) in the reference's dof order.
    precision "float64" is the reference; "float32" computes everything in
    float32; "bfloat16" forms the kinematics and the QP's matrices in
    bfloat16, solves on those in float32 (torch has no bfloat16 solver) and
    rounds the answer to bfloat16."""
    dt = DTYPES[precision]
    M, g, C, d, l, u = qp_matrices(robot, links, q, A, b, lo, hi, dt)
    if dt == torch.bfloat16:
        f32 = torch.float32
        res = qp.solve(M.to(f32), g.to(f32), C.to(f32), d.to(f32), l.to(f32), u.to(f32),
                       tol=1e-6)
        return res.x.to(dt).double(), res.solved
    res = qp.solve(M, g, C, d, l, u, tol=1e-10 if dt == torch.float64 else 1e-6)
    return res.x.double(), res.solved


@dataclasses.dataclass
class Judged:
    """Per problem: the answer's relative error against the optimum (inf
    where the reference has none), its residual, its flag, and whether the
    reference solved it."""
    err: torch.Tensor
    residual: torch.Tensor
    converged: torch.Tensor
    solved: torch.Tensor

    @staticmethod
    def cat(parts: List["Judged"]) -> "Judged":
        return Judged(*(torch.cat([getattr(p, f.name) for p in parts])
                        for f in dataclasses.fields(Judged)))


def judge(robot, links, q, A, b, lo, hi, nu, converged, nu_star, solved) -> Judged:
    """Judge the answers nu (B, nv, the reference's dof order) and flags of
    the problems (q, b) against the reference's optimum (nu_star, solved)."""
    _, _, C, d, l, u = qp_matrices(robot, links, q, A, b, lo, hi)
    nu = nu.double()
    task = ((C @ nu[..., None])[..., 0] - d).abs().amax(-1)
    box = torch.clamp(torch.maximum(l - nu, nu - u), min=0).amax(-1)
    residual = torch.maximum(task, box)
    err = (nu - nu_star).abs().amax(-1) / nu_star.abs().amax(-1).clamp_min(1.0)
    inf = torch.full_like(err, float("inf"))
    err = torch.where(solved, err, inf)
    finite = torch.isfinite(nu).all(-1)
    return Judged(torch.where(finite, err, inf), torch.where(finite, residual, inf),
                  converged.clone(), solved.clone())


def numbers(j: Judged, residual_limit: float) -> Dict[str, float]:
    """The compared numbers (see the module's docstring), and counts to
    reckon ``missed`` at other limits: the problems solved and not flagged,
    and the flagged ones with a residual over each of RES_STEPS."""
    flagged = j.converged
    n_solved = int(j.solved.sum())
    answered = flagged & j.solved & (j.residual <= residual_limit)
    out = dict(
        residual=float(j.residual[flagged].max()) if bool(flagged.any()) else 0.0,
        nu_err_p99=(float(torch.quantile(j.err[flagged], 0.99, interpolation="higher"))
                    if bool(flagged.any()) else 0.0),
        missed=float((j.solved & ~answered).sum()) / max(1, n_solved),
        nu_err_max=float(j.err[flagged].max()) if bool(flagged.any()) else 0.0,
        n=int(flagged.numel()), n_converged=int(flagged.sum()), n_solved=n_solved,
        n_unflagged=int((j.solved & ~flagged).sum()),
        n_flagged_unsolved=int((flagged & ~j.solved).sum()))
    for r in RES_STEPS:
        out[f"n_res_over_{r:g}"] = int((flagged & j.solved & (j.residual > r)).sum())
    return out
