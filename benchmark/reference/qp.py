"""A plain, batched primal-dual interior-point solver for the IK problem's QP.

    minimize    1/2 x' M x + g' x
    subject to  C x = d,   l <= x <= u

with M positive definite, one problem per leading batch index.  Mehrotra's
predictor-corrector, the iterate kept strictly inside the box, each Newton
step one dense solve of the (n + m) KKT system.  It has nothing in common
with the ADMM scheme of the solver under test but the problem it solves.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QpResult:
    x: torch.Tensor        # (B, n)
    solved: torch.Tensor   # (B,) bool: residuals and gap under the tolerance
    iters: int


def solve(M, g, C, d, l, u, tol: float = 1e-10, max_iter: int = 80,
          solve_dtype=None) -> QpResult:
    """Solve the batch.  M (B, n, n), g (B, n), C (B, m, n), d (B, m), l and u
    (B, n) finite with l < u.  The arithmetic runs in M's dtype, the Newton
    systems in ``solve_dtype`` (default the same)."""
    B, n = g.shape
    m = d.shape[1]
    dt = M.dtype
    sdt = solve_dtype or dt
    x = 0.5 * (l + u)
    y = torch.zeros((B, m), dtype=dt, device=g.device)
    zl = torch.ones_like(x)
    zu = torch.ones_like(x)
    eps = torch.finfo(dt).eps
    reg = torch.zeros((B, m, m), dtype=sdt, device=g.device)
    reg.diagonal(dim1=-2, dim2=-1).fill_(-1e3 * torch.finfo(sdt).eps)
    scale_d = 1 + d.abs().amax(-1)
    scale_g = 1 + g.abs().amax(-1) + M.abs().amax((-2, -1))
    solved = torch.zeros(B, dtype=torch.bool, device=g.device)
    ok = torch.ones(B, dtype=torch.bool, device=g.device)

    def newton(D, rhs_x, rhs_y):
        K = torch.cat([torch.cat([M + torch.diag_embed(D), C.transpose(-1, -2)], -1),
                       torch.cat([C, reg.to(dt)], -1)], -2).to(sdt)
        rhs = torch.cat([rhs_x, rhs_y], -1).to(sdt)[..., None]
        sol, info = torch.linalg.solve_ex(K, rhs)
        return sol[..., :n, 0].to(dt), -sol[..., n:, 0].to(dt), info == 0

    def step_len(v, dv):
        ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
        return torch.clamp(ratio.amin(-1), max=1.0)

    it = 0
    for it in range(1, max_iter + 1):
        sl, su = x - l, u - x
        rd = (M @ x[..., None])[..., 0] + g - (C.transpose(-1, -2) @ y[..., None])[..., 0] - zl + zu
        rp = (C @ x[..., None])[..., 0] - d
        mu = ((zl * sl).sum(-1) + (zu * su).sum(-1)) / (2 * n)
        solved = (ok & (rd.abs().amax(-1) <= tol * scale_g)
                  & (rp.abs().amax(-1) <= tol * scale_d) & (mu <= tol))
        if bool(solved.all()):
            break
        D = zl / sl + zu / su
        # predictor
        rl, ru = zl * sl, zu * su
        dx, dy, good = newton(D, -rd - rl / sl + ru / su, -rp)
        dzl = (-rl - zl * dx) / sl
        dzu = (-ru + zu * dx) / su
        ap = torch.minimum(step_len(sl, dx), step_len(su, -dx))
        ad = torch.minimum(step_len(zl, dzl), step_len(zu, dzu))
        mu_aff = (((zl + ad[:, None] * dzl) * (sl + ap[:, None] * dx)).sum(-1)
                  + ((zu + ad[:, None] * dzu) * (su - ap[:, None] * dx)).sum(-1)) / (2 * n)
        sigma = (mu_aff / mu.clamp_min(eps)).clamp(0, 1) ** 3
        # corrector
        rl = zl * sl + dx * dzl - (sigma * mu)[:, None]
        ru = zu * su - dx * dzu - (sigma * mu)[:, None]
        dx, dy, good2 = newton(D, -rd - rl / sl + ru / su, -rp)
        dzl = (-rl - zl * dx) / sl
        dzu = (-ru + zu * dx) / su
        ap = 0.99 * torch.minimum(step_len(sl, dx), step_len(su, -dx))
        ad = 0.99 * torch.minimum(step_len(zl, dzl), step_len(zu, dzu))
        ok = ok & good & good2 & torch.isfinite(dx).all(-1) & torch.isfinite(dzl).all(-1)
        live = (ok & ~solved)[:, None]
        x = torch.where(live, x + ap[:, None] * dx, x)
        y = torch.where(live, y + ad[:, None] * dy, y)
        zl = torch.where(live, zl + ad[:, None] * dzl, zl)
        zu = torch.where(live, zu + ad[:, None] * dzu, zu)
    return QpResult(x=x, solved=solved, iters=it)
