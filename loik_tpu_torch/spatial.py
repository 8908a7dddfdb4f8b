"""Batched spatial algebra on SE(3), motions (twists) and forces (wrenches).

The pieces of `loik_tpu.spatial` that forward kinematics and the URDF loader
use, on torch tensors with arbitrary LEADING batch dims:

  - SE(3) transform:  pair ``(R, p)`` with ``R (..., 3, 3)`` rotation and
    ``p (..., 3)`` translation, mapping frame B -> frame A ("aMb").
  - Motion (twist):   ``(..., 6)`` ordered ``[linear(3); angular(3)]`` —
    the Pinocchio ``Motion::toVector()`` convention.
  - Force (wrench):   ``(..., 6)`` ordered ``[force(3); torque(3)]``.

The solver's trailing-batch forms live in `solver/batched_spatial.py`.
"""

from __future__ import annotations

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


def se3_compose(Ra, pa, Rb, pb):
    """(aMb) * (bMc) -> aMc."""
    R = Ra @ Rb
    p = pa + (Ra @ pb[..., None])[..., 0]
    return R, p


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
