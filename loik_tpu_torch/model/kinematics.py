"""Kinematics utilities on top of KinematicTree: geometric Jacobians and
task-constraint construction helpers.

Port of `loik_tpu.model.kinematics`.  The reference consumes task
constraints (A_i, b_i) already expressed in the constrained joint's LOCAL
frame (ik-id-description.hpp:106-135) and leaves their construction to the
caller; these helpers build local-frame constraints from world-frame
velocity targets and expose the local/world geometric Jacobians.
"""

from __future__ import annotations

import torch

from .. import spatial


def joint_jacobian(tree, q: torch.Tensor, link: int, frame: str = "local") -> torch.Tensor:
    """Geometric Jacobian J of joint ``link``'s spatial velocity wrt nu:
    v_link = J @ nu, v in [linear; angular] order, in the link's local
    frame ("local") or the world frame ("world").  Shape (..., 6, nv) for
    q (..., nq); configuration-dependent subspaces are evaluated at q."""
    if frame not in ("local", "world"):
        raise ValueError("frame must be 'local' or 'world'")
    _, _, oR, op = tree.fwd_kinematics(q)
    J = torch.zeros(q.shape[:-1] + (6, tree.nv), dtype=q.dtype, device=q.device)
    Rl, pl = spatial.se3_inverse(oR[..., link, :, :], op[..., link, :])
    # dof j of ancestor a contributes (oMlink)^-1 oMa acting on S_a
    a = link
    while a >= 0:
        Rla, pla = spatial.se3_compose(Rl, pl, oR[..., a, :, :], op[..., a, :])
        Sa = tree.joint_S(a, q)                    # (6, k) or (..., 6, k)
        cols = spatial.act_motion(Rla[..., None, :, :], pla[..., None, :],
                                  Sa.transpose(-1, -2))            # (..., k, 6)
        iv, k = tree.idx_v[a], tree.nvs[a]
        J[..., :, iv: iv + k] = cols.transpose(-1, -2)
        a = tree.parents[a]
    if frame == "world":
        J = spatial.se3_action_matrix(oR[..., link, :, :], op[..., link, :]) @ J
    return J


def frame_velocity(tree, q, nu, link: int, frame: str = "local") -> torch.Tensor:
    """Spatial velocity of ``link`` for joint velocities nu (via the Jacobian)."""
    J = joint_jacobian(tree, q, link, frame)
    return (J @ nu[..., None])[..., 0]


def task_from_world_velocity(tree, q, link: int, v_world):
    """A local-frame equality constraint (A, b) commanding ``link`` to move
    with the world-frame spatial velocity ``v_world`` (..., 6): A = I6 in
    the local frame and b = (oMl)^-1 v_world, ready for IkProblem /
    DiffIkSolver.update_eq_constraint."""
    _, _, oR, op = tree.fwd_kinematics(q)
    v_world = torch.as_tensor(v_world, dtype=q.dtype, device=q.device)
    b = spatial.act_inv_motion(oR[..., link, :, :], op[..., link, :], v_world)
    A = torch.eye(6, dtype=b.dtype, device=b.device).expand(b.shape[:-1] + (6, 6))
    return A, b


def task_linear_velocity(tree, q, link: int, v_lin_world):
    """Constrain only the LINEAR velocity of the link-frame ORIGIN, given in
    world coordinates: the angular rows of A and b are zero and b's linear
    part is R^T v_lin_world — the standard point-tracking diff-IK task.
    (The velocity of the frame origin, not the linear part of the
    world-origin spatial twist.)"""
    _, _, oR, _ = tree.fwd_kinematics(q)
    v_lin = torch.as_tensor(v_lin_world, dtype=q.dtype, device=q.device)
    b_lin = (oR[..., link, :, :].transpose(-1, -2) @ v_lin[..., None])[..., 0]
    b = torch.cat([b_lin, torch.zeros_like(b_lin)], dim=-1)
    A = torch.zeros(b.shape[:-1] + (6, 6), dtype=b.dtype, device=b.device)
    A[..., :3, :3] = torch.eye(3, dtype=b.dtype, device=b.device)
    return A, b
