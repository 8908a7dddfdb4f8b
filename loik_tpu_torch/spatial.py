"""Batched spatial algebra on SE(3), motions (twists) and forces (wrenches).

The port of `loik_tpu.spatial`, on torch tensors with arbitrary LEADING
batch dims:

  - SE(3) transform:  pair ``(R, p)`` with ``R (..., 3, 3)`` rotation and
    ``p (..., 3)`` translation, mapping frame B -> frame A ("aMb").
  - Motion (twist):   ``(..., 6)`` ordered ``[linear(3); angular(3)]`` —
    the Pinocchio ``Motion::toVector()`` convention.
  - Force (wrench):   ``(..., 6)`` ordered ``[force(3); torque(3)]``.

The solver's trailing-batch forms live in `solver/batched_spatial.py`.
"""

from __future__ import annotations

import numpy as np
import torch

LIN = slice(0, 3)
ANG = slice(3, 6)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [v]x, shape (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-1),
            torch.stack([z, o, -x], dim=-1),
            torch.stack([-y, x, o], dim=-1),
        ],
        dim=-2,
    )


def rotation_about_axis(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about a (unit) axis. axis (..., 3), angle (...)."""
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    K = skew(axis)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand(K.shape)
    aaT = axis[..., :, None] * axis[..., None, :]
    return c * eye + s * K + (1.0 - c) * aaT


def rotation_about_axis_cs(axis: torch.Tensor, c: torch.Tensor,
                           s: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about a (unit) axis with the angle given as a
    (cos, sin) pair, the Pinocchio nq=2 unbounded-revolute convention
    (JointModelRevoluteUnbounded): no trig evaluation, works for any winding.
    axis (..., 3), c/s (...)."""
    c = c[..., None, None]
    s = s[..., None, None]
    K = skew(axis)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand(K.shape)
    aaT = axis[..., :, None] * axis[..., None, :]
    return c * eye + s * K + (1.0 - c) * aaT


def _small_angle_cutoff(dtype: torch.dtype) -> float:
    """theta^2 below which the Taylor branch beats the closed form.  The
    closed-form coefficients (1-cos t)/t^2 and (t-sin t)/t^3 cancel with
    relative error ~eps/t^2, while the two-term Taylor truncates at ~t^4;
    the crossover is t^2 ~ sqrt(eps), so it depends on the dtype (1.7e-3 in
    float32, 7e-8 in float64)."""
    return 5.0 * float(np.sqrt(torch.finfo(dtype).eps))


def se2_exp(dx, dy, dth):
    """SE(2) exponential: planar tangent (dx, dy, dtheta) -> (cos, sin, tx, ty).

    t = V(dtheta) @ (dx, dy) with V the planar left-Jacobian
    [[sin t/t, -(1-cos t)/t], [(1-cos t)/t, sin t/t]]; Taylor-guarded at
    t = 0 with the dtype-aware cutoff (`_small_angle_cutoff` on t^2)."""
    th2 = dth * dth
    small = th2 < _small_angle_cutoff(dth.dtype)
    safe = torch.where(small, torch.ones_like(dth), dth)
    c, s = torch.cos(dth), torch.sin(dth)
    a = torch.where(small, 1.0 - th2 / 6.0, s / safe)           # sin t/t
    b = torch.where(small, 0.5 * dth - th2 * dth / 24.0, (1.0 - c) / safe)
    tx = a * dx - b * dy
    ty = b * dx + a * dy
    return c, s, tx, ty


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w), the Pinocchio/Eigen coefficient order, to a
    rotation matrix.  q (..., 4), normalized internally."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def rpy_to_rotmat(rpy: torch.Tensor) -> torch.Tensor:
    """URDF roll-pitch-yaw (fixed XYZ axes) to rotation: R = Rz(y) Ry(p) Rx(r)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    rows = [
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ]
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def se3_identity(dtype=torch.float64, device=None):
    return (torch.eye(3, dtype=dtype, device=device),
            torch.zeros((3,), dtype=dtype, device=device))


def se3_compose(Ra, pa, Rb, pb):
    """(aMb) * (bMc) -> aMc."""
    R = Ra @ Rb
    p = pa + (Ra @ pb[..., None])[..., 0]
    return R, p


def se3_inverse(R, p):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, p)


def _mv(R, v):
    return (R @ v[..., None])[..., 0]


def _mtv(R, v):
    return (R.transpose(-1, -2) @ v[..., None])[..., 0]


def act_motion(R, p, v):
    """aMb acting on a motion expressed in B -> expressed in A (SE3::act)."""
    ang = _mv(R, v[..., ANG])
    lin = _mv(R, v[..., LIN]) + torch.linalg.cross(p.expand_as(ang), ang)
    return torch.cat([lin, ang], dim=-1)


def act_inv_motion(R, p, v):
    """aMb^-1 acting on a motion expressed in A -> expressed in B (SE3::actInv)."""
    w = v[..., ANG]
    lin = _mtv(R, v[..., LIN] - torch.linalg.cross(p.expand_as(w), w))
    ang = _mtv(R, w)
    return torch.cat([lin, ang], dim=-1)


def act_force(R, p, f):
    """aMb acting on a force expressed in B -> expressed in A (SE3::act on Force)."""
    lin = _mv(R, f[..., LIN])
    ang = _mv(R, f[..., ANG]) + torch.linalg.cross(p.expand_as(lin), lin)
    return torch.cat([lin, ang], dim=-1)


def act_inv_force(R, p, f):
    """aMb^-1 acting on a force expressed in A -> expressed in B."""
    lin = f[..., LIN]
    ang = _mtv(R, f[..., ANG] - torch.linalg.cross(p.expand_as(lin), lin))
    return torch.cat([_mtv(R, lin), ang], dim=-1)


def se3_action_matrix(R, p):
    """6x6 motion action matrix X with X v = act_motion(R, p, v):
    X = [[R, [p]x R], [0, R]] (pinocchio SE3::toActionMatrix)."""
    pxR = skew(p) @ R
    top = torch.cat([R, pxR], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_dual_action_matrix(R, p):
    """6x6 force action matrix X* with X* f = act_force(R, p, f):
    X* = [[R, 0], [[p]x R, R]] (pinocchio SE3::toDualActionMatrix)."""
    pxR = skew(p) @ R
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([pxR, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_act_on_sym6(R, p, H):
    """Congruence X* H X^-1 of a symmetric 6x6 onto the parent frame
    (`pinocchio::impl::internal::SE3actOn`); X^-1 = X*^T."""
    Xd = se3_dual_action_matrix(R, p)
    return Xd @ H @ Xd.transpose(-1, -2)


def exp3_quat(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential: rotation vector (..., 3) -> unit quaternion
    (x, y, z, w).  Taylor-guarded near 0 with the dtype-aware cutoff."""
    theta2 = (w * w).sum(-1)
    small = theta2 < _small_angle_cutoff(w.dtype)
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    # sin(theta/2)/theta -> 1/2 - theta^2/48
    s = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(0.5 * theta) / theta)
    # cos(theta/2) -> 1 - theta^2/8 + theta^4/384
    c = torch.where(small, 1.0 - theta2 / 8.0 + theta2 * theta2 / 384.0,
                    torch.cos(0.5 * theta))
    return torch.cat([s[..., None] * w, c[..., None]], dim=-1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (x, y, z, w) quaternions; composes rotations as
    R(q1 * q2) = R(q1) @ R(q2)."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def _so3_coeffs(w: torch.Tensor):
    """(a, b, d, K, KK) with a = sin t/t, b = (1-cos t)/t^2,
    d = (t-sin t)/t^3 for t = |w|, Taylor-guarded (`_small_angle_cutoff`)."""
    theta2 = (w * w).sum(-1)
    small = theta2 < _small_angle_cutoff(w.dtype)
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    c, s = torch.cos(theta), torch.sin(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, s / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - c) / safe2)
    d = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - s) / (safe2 * theta))
    K = skew(w)
    return a, b, d, K, K @ K


def se3_exp_translation(v: torch.Tensor) -> torch.Tensor:
    """Translation part of the SE(3) exponential: p = V(w) @ u with V the
    left-Jacobian of SO(3) (the rotation comes from `exp3_quat`: callers
    that integrate a quaternion state need only this half)."""
    u, w = v[..., LIN], v[..., ANG]
    _, b, d, K, KK = _so3_coeffs(w)
    V = (torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
         + b[..., None, None] * K + d[..., None, None] * KK)
    return _mv(V, u)


def se3_exp(v: torch.Tensor):
    """SE(3) exponential of a twist (..., 6) [linear; angular] -> (R, p):
    R = exp3(w), p = V(w) u with V the left-Jacobian of SO(3), both
    Taylor-guarded at w = 0 with the dtype-aware cutoff."""
    u, w = v[..., LIN], v[..., ANG]
    a, b, d, K, KK = _so3_coeffs(w)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    R = eye + a[..., None, None] * K + b[..., None, None] * KK
    V = eye + b[..., None, None] * K + d[..., None, None] * KK
    return R, _mv(V, u)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm: rotation matrix (..., 3, 3) -> rotation vector
    (..., 3) with |w| in [0, pi], branch for branch as `loik_tpu.spatial`:
    Taylor near theta = 0, theta / (2 sin theta) vee(R - R^T) in the bulk,
    and the axis from the diagonal near theta = pi (where vee(R - R^T) ~
    2 sin(theta) n underflows), each component's sign from the symmetric
    part's row of the largest one, the overall sign tied to vee so that the
    branch is continuous across its threshold.  Device ops only: a tick of
    closed-loop IK takes it without a host synchronisation."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(c)
    theta2 = theta * theta
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = theta2 < _small_angle_cutoff(R.dtype)
    # theta / (2 sin theta): series 1/2 + theta^2/12 + 7 theta^4/720
    sin_t = torch.sin(theta)
    safe_sin = torch.where(small, torch.ones_like(sin_t), sin_t)
    coef = torch.where(small, 0.5 + theta2 / 12.0 + 7.0 * theta2 * theta2 / 720.0,
                       theta / (2.0 * safe_sin))
    w_bulk = coef[..., None] * vee
    # near pi: n_i = sqrt((R_ii - c) / (1 - c)), signs from S = (R + R^T)/2
    near_pi = c < -0.99
    one_minus_c = torch.where(near_pi, 1.0 - c, torch.ones_like(c))
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    n_abs = torch.sqrt(torch.clamp((diag - c[..., None]) / one_minus_c[..., None], min=0.0))
    S = 0.5 * (R + R.transpose(-1, -2))
    k = torch.argmax(n_abs, dim=-1)                     # reference component
    Sk = torch.gather(S, -2, k[..., None, None].expand(k.shape + (1, 3)))[..., 0, :]
    onehot_k = torch.arange(3, device=R.device) == k[..., None]
    # component k is the positive reference (S[k,k] = c + (1-c) n_k^2 may
    # itself be negative, so it must not supply the sign)
    sgn = torch.where(onehot_k, 1.0, torch.where(Sk >= 0.0, 1.0, -1.0)).to(R.dtype)
    n = sgn * n_abs
    flip = (n * vee).sum(-1) < 0.0
    n = torch.where(flip[..., None], -n, n)
    return torch.where(near_pi[..., None], theta[..., None] * n, w_bulk)


def se3_log(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: placement (R, p) -> twist (..., 6) [linear; angular],
    the inverse of `se3_exp`: u = V(w)^-1 p, Taylor-guarded near w = 0 with
    the dtype-aware cutoff."""
    w = so3_log(R)
    theta2 = (w * w).sum(-1)
    small = theta2 < _small_angle_cutoff(R.dtype)
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    half = 0.5 * theta
    # g = 1/theta^2 - cos(theta/2) / (2 theta sin(theta/2));
    # series 1/12 + theta^2/720
    sin_h = torch.sin(half)
    safe_sin = torch.where(small, torch.ones_like(sin_h), sin_h)
    g = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / safe2 - torch.cos(half) / (2.0 * theta * safe_sin))
    K = skew(w)
    Vinv = (torch.eye(3, dtype=R.dtype, device=R.device).expand(K.shape)
            - 0.5 * K + g[..., None, None] * (K @ K))
    return torch.cat([_mv(Vinv, p), w], dim=-1)


def motion_cross(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Motion cross product v1 x v2 (spatial velocity bracket), [lin; ang]."""
    w1, u1 = v1[..., ANG], v1[..., LIN]
    w2, u2 = v2[..., ANG], v2[..., LIN]
    ang = torch.linalg.cross(w1, w2)
    lin = torch.linalg.cross(w1, u2) + torch.linalg.cross(u1, w2)
    return torch.cat([lin, ang], dim=-1)


def inf_norm(x: torch.Tensor, axis=None) -> torch.Tensor:
    return x.abs().amax() if axis is None else x.abs().amax(dim=axis)
