"""Spatial algebra in the solver's trailing-batch layout.

Every tensor carries the problem batch as its LAST axis, as in
`loik_tpu.solver.batched_spatial`.  On the GPU that makes element
``[..., b]`` of consecutive problems adjacent in memory, so one thread per
problem reads coalesced.  The contractions are elementwise products summed
term by term over the tiny spatial axis (3 or 6): no matmul, so TF32 never
enters.

Shapes: R (..., 3, 3, B), p (..., 3, B), motions/forces (..., 6, B),
6x6 operators (..., 6, 6, B).
"""

from __future__ import annotations

import torch

LIN = slice(0, 3)
ANG = slice(3, 6)

# Every contraction is a chain of elementwise products summed one term at a
# time in index order, exactly as `loik_tpu.solver.batched_spatial` does.
# The order is part of the contract: in float32 the solver's iteration
# counts change under a one-ulp change of the inputs, so the eager loop, the
# CUDA kernel (which sums in the same order, without FMA contraction) and
# the JAX reference round alike only if they add alike.  `.sum()` over an
# axis would pick its own order.


def mv(M, v):
    """Matrix @ vector over trailing batch: (..., i, j, B), (..., j, B) -> (..., i, B).

    `v` may also be broadcastable, e.g. (..., j, 1) for a shared vector."""
    acc = M[..., :, 0, :] * v[..., 0:1, :]
    for j in range(1, M.shape[-2]):
        acc = acc + M[..., :, j, :] * v[..., j:j + 1, :]
    return acc


def mtv(M, v):
    """Matrix^T @ vector: (..., j, i, B), (..., j, B) -> (..., i, B)."""
    acc = M[..., 0, :, :] * v[..., 0:1, :]
    for j in range(1, M.shape[-3]):
        acc = acc + M[..., j, :, :] * v[..., j:j + 1, :]
    return acc


def mm(A, B):
    """(..., i, j, B) @ (..., j, k, B) -> (..., i, k, B) as a sum of outer
    products of A columns with B rows."""
    acc = A[..., :, 0:1, :] * B[..., 0:1, :, :]
    for j in range(1, A.shape[-2]):
        acc = acc + A[..., :, j:j + 1, :] * B[..., j:j + 1, :, :]
    return acc


def mtm(A, B):
    """A^T @ B: (..., j, i, B), (..., j, k, B) -> (..., i, k, B)."""
    acc = A[..., 0, :, None, :] * B[..., 0:1, :, :]
    for j in range(1, A.shape[-3]):
        acc = acc + A[..., j, :, None, :] * B[..., j:j + 1, :, :]
    return acc


def mmt(A, B):
    """A @ B^T: (..., i, j, B), (..., k, j, B) -> (..., i, k, B)."""
    acc = A[..., :, 0:1, :] * B[..., None, :, 0, :]
    for j in range(1, A.shape[-2]):
        acc = acc + A[..., :, j:j + 1, :] * B[..., None, :, j, :]
    return acc


def sum_lead(x):
    """Sum over every axis but the trailing batch, term by term in row-major
    order -> (B,): the order of `jnp.sum` on the reference's CPU backend and
    of the kernel's running sums."""
    x = x.reshape(-1, x.shape[-1])
    acc = x[0]
    for j in range(1, x.shape[0]):
        acc = acc + x[j]
    return acc


def cross(a, b):
    """Cross product on (..., 3, B) tensors."""
    ax, ay, az = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    bx, by, bz = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-2
    )


def act_inv_motion(R, p, v):
    lin = mtv(R, v[..., LIN, :] - cross(p, v[..., ANG, :]))
    ang = mtv(R, v[..., ANG, :])
    return torch.cat([lin, ang], dim=-2)


def act_force(R, p, f):
    lin = mv(R, f[..., LIN, :])
    ang = mv(R, f[..., ANG, :]) + cross(p, lin)
    return torch.cat([lin, ang], dim=-2)


def skew(v):
    """(..., 3, B) -> (..., 3, 3, B)."""
    x, y, z = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-2),
            torch.stack([z, o, -x], dim=-2),
            torch.stack([-y, x, o], dim=-2),
        ],
        dim=-3,
    )


def dual_action_matrix(R, p):
    """X* = [[R, 0], [[p]x R, R]]: (..., 3, 3, B),(..., 3, B) -> (..., 6, 6, B)."""
    pxR = mm(skew(p), R)
    top = torch.cat([R, torch.zeros_like(R)], dim=-2)
    bot = torch.cat([pxR, R], dim=-2)
    return torch.cat([top, bot], dim=-3)


def skew_mm(p, M):
    """P(p) @ M for 3x3 M without materializing the skew matrix."""
    a, b, c = p[..., 0:1, :], p[..., 1:2, :], p[..., 2:3, :]
    M0, M1, M2 = M[..., 0, :, :], M[..., 1, :, :], M[..., 2, :, :]
    return torch.stack([b * M2 - c * M1, c * M0 - a * M2, a * M1 - b * M0], dim=-3)


def mm_skew(M, p):
    """M @ P(p) for 3x3 M: columns of MP are cross-product combinations."""
    a, b, c = p[..., 0:1, :], p[..., 1:2, :], p[..., 2:3, :]
    C0, C1, C2 = M[..., :, 0, :], M[..., :, 1, :], M[..., :, 2, :]
    return torch.stack([c * C1 - b * C2, a * C2 - c * C0, b * C0 - a * C1], dim=-2)


def act_sym6_dense(R, p, H):
    """X* H X*^T as two dense 6x6 products (the f32 form)."""
    Xd = dual_action_matrix(R, p)
    return mmt(mm(Xd, H), Xd)


def act_sym6_block(R, p, H):
    """X* H X*^T in block form, exploiting X* = [[R,0],[[p]x R, R]] and the
    symmetry of H: six 3x3 rotations plus skew products, the bottom-left
    block mirrored from the top-right (the f64 form)."""
    A = H[..., LIN, LIN, :]
    Bl = H[..., ANG, LIN, :]
    C = H[..., ANG, ANG, :]
    A1 = mmt(mm(R, A), R)      # R A R^T
    B1 = mmt(mm(R, Bl), R)     # R B R^T
    C1 = mmt(mm(R, C), R)      # R C R^T
    BL = skew_mm(p, A1) + B1                    # P A' + B'
    TR = BL.transpose(-3, -2)                   # = (P A' + B')^T
    BR = skew_mm(p, TR) - mm_skew(B1, p) + C1   # P A' P^T + P B'^T + B' P^T + C'
    top = torch.cat([A1, TR], dim=-2)
    bot = torch.cat([BL, BR], dim=-2)
    return torch.cat([top, bot], dim=-3)


def act_sym6(R, p, H):
    """X* H X*^T — congruence transform of a symmetric 6x6 recursion operator
    to the parent frame (`SE3actOn`, loik-loid-optimized.hxx:66).  f64 takes
    the block form, every other dtype the dense form, as in `loik_tpu`."""
    if H.dtype == torch.float64:
        return act_sym6_block(R, p, H)
    return act_sym6_dense(R, p, H)


def inf_norm_b(x):
    """Inf-norm over all axes except the trailing batch -> (B,)."""
    return x.abs().reshape(-1, x.shape[-1]).amax(0)


def spd_inv(D):
    """Inverse of a small SPD matrix (..., k, k, B) by fully unrolled
    Cholesky + triangular inverse, elementwise over the trailing batch.
    k is the joint dof count (1/3/6); D = S'HS + mu*I is SPD by construction."""
    k = D.shape[-2]
    if k == 1:
        return 1.0 / D
    d = [[D[..., i, j, :] for j in range(k)] for i in range(k)]
    # Cholesky: D = L L^T, L lower with positive diagonal
    L = [[None] * k for _ in range(k)]
    Ldi = [None] * k  # 1 / L[j][j]
    for j in range(k):
        s = d[j][j]
        for p in range(j):
            s = s - L[j][p] * L[j][p]
        Ldi[j] = torch.rsqrt(s)
        L[j][j] = s * Ldi[j]  # sqrt(s)
        for i in range(j + 1, k):
            s = d[i][j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            L[i][j] = s * Ldi[j]
    # M = L^{-1} (lower)
    M = [[None] * k for _ in range(k)]
    for i in range(k):
        M[i][i] = Ldi[i]
        for j in range(i):
            s = L[i][j] * M[j][j]
            for p in range(j + 1, i):
                s = s + L[i][p] * M[p][j]
            M[i][j] = -s * Ldi[i]
    # D^{-1} = M^T M; entry (i,j) sums over p >= max(i,j)
    rows = []
    for i in range(k):
        cols = []
        for j in range(k):
            lo = max(i, j)
            s = M[lo][i] * M[lo][j]
            for p in range(lo + 1, k):
                s = s + M[p][i] * M[p][j]
            cols.append(s)
        rows.append(torch.stack(cols, dim=-2))
    return torch.stack(rows, dim=-3)
