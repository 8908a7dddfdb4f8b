"""KinematicTree: the port's replacement for `pinocchio::ModelTpl`.

Mirrors `loik_tpu.model.tree.KinematicTree`: the topology is static Python
metadata (parents, joint types, dof indexing) and the geometry is tensor
leaves (joint placements, axes).  Each *moving* joint i (0-based; the
universe is not stored) has

  parent[i] in {-1} U [0, i)   (-1 = attached to the world)
  a constant motion subspace S[i] (6 x nv_i) in the local joint frame
  a configuration map M(q_i) computed per joint type.

Supported joint types: REVOLUTE and PRISMATIC, the constant-subspace 1-dof
joints of `panda`/`panda_arm`.  The type codes are those of `loik_tpu`, so
a tree converted from the JAX package keeps its codes; every other code
raises NotImplementedError (the joint zoo is ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .. import spatial

# Joint type codes, equal to loik_tpu.model.tree's
REVOLUTE = 0
PRISMATIC = 1

JOINT_NV = {REVOLUTE: 1, PRISMATIC: 1}
JOINT_NQ = {REVOLUTE: 1, PRISMATIC: 1}


def _check_supported(jtypes, names) -> None:
    for t, name in zip(jtypes, names):
        if t not in JOINT_NV:
            raise NotImplementedError(
                f"joint '{name}' has type code {t}: only REVOLUTE ({REVOLUTE}) "
                f"and PRISMATIC ({PRISMATIC}) joints are ported so far; the "
                "other joint types are ROADMAP queue 1 item 7"
            )


@dataclasses.dataclass(frozen=True)
class KinematicTree:
    """Frozen kinematic tree: static topology, tensor geometry."""

    # --- tensor leaves ---
    placement_R: torch.Tensor     # (N, 3, 3) fixed joint placement rotation (parent frame)
    placement_p: torch.Tensor     # (N, 3) fixed joint placement translation
    axis: torch.Tensor            # (N, 3) unit motion axis
    velocity_limit: torch.Tensor  # (nv,) default box bound magnitude per dof

    # --- static metadata ---
    parents: Tuple[int, ...]      # (N,) parent joint index, -1 = world
    jtypes: Tuple[int, ...]       # (N,) joint type codes
    idx_v: Tuple[int, ...]        # (N,) first dof index of each joint
    idx_q: Tuple[int, ...]        # (N,) first config index of each joint
    joint_names: Tuple[str, ...]  # (N,)
    name: str = "robot"

    def __post_init__(self):
        _check_supported(self.jtypes, self.joint_names)
        for i, p in enumerate(self.parents):
            if not -1 <= p < i:
                raise ValueError(
                    f"joint {i} has parent {p}: joints must be topologically "
                    "ordered (parent before child)"
                )

    # ------------------------------------------------------------------ #
    # static derived properties
    # ------------------------------------------------------------------ #
    @property
    def njoints(self) -> int:
        """Number of moving joints (= pinocchio njoints - 1, the universe dropped)."""
        return len(self.parents)

    @property
    def nv(self) -> int:
        return sum(JOINT_NV[t] for t in self.jtypes)

    @property
    def nq(self) -> int:
        return sum(JOINT_NQ[t] for t in self.jtypes)

    @property
    def nvs(self) -> Tuple[int, ...]:
        return tuple(JOINT_NV[t] for t in self.jtypes)

    @property
    def nv_max(self) -> int:
        return max(self.nvs)

    @property
    def dtype(self) -> torch.dtype:
        return self.placement_R.dtype

    @property
    def device(self) -> torch.device:
        return self.placement_R.device

    @property
    def padded_to_flat(self) -> Tuple[int, ...]:
        """(nv,) index into a flattened (N*nv_max,) padded dof array."""
        out = []
        for i, nvi in enumerate(self.nvs):
            out.extend(i * self.nv_max + k for k in range(nvi))
        return tuple(out)

    def to(self, device=None, dtype: Optional[torch.dtype] = None) -> "KinematicTree":
        """The same tree with its tensor leaves on ``device`` and in ``dtype``."""
        def conv(x):
            return x.to(device=device or x.device, dtype=dtype or x.dtype)

        return dataclasses.replace(
            self,
            placement_R=conv(self.placement_R),
            placement_p=conv(self.placement_p),
            axis=conv(self.axis),
            velocity_limit=conv(self.velocity_limit),
        )

    def astype(self, dtype: torch.dtype) -> "KinematicTree":
        return self.to(dtype=dtype)

    # ------------------------------------------------------------------ #
    # motion subspaces and joint transforms
    # ------------------------------------------------------------------ #
    def joint_S(self, i: int) -> torch.Tensor:
        """Motion subspace of joint i, shape (6, 1), [linear; angular] rows."""
        ax = self.axis[i][:, None]
        zero = torch.zeros_like(ax)
        if self.jtypes[i] == REVOLUTE:
            return torch.cat([zero, ax], dim=0)
        return torch.cat([ax, zero], dim=0)          # PRISMATIC

    def joint_calc(self, i: int, q: torch.Tensor):
        """M(q_i): joint displacement (R, p) in the joint's local frame.

        q has shape (..., nq); batching over leading dims is supported.
        Mirrors `jmodel.calc(jdata, q)` in FwdPassInit
        (loik-loid-optimized.hxx:263)."""
        x = q[..., self.idx_q[i]]
        ax = self.axis[i]
        if self.jtypes[i] == REVOLUTE:
            R = spatial.rotation_about_axis(ax.expand(x.shape + (3,)), x)
            return R, torch.zeros(x.shape + (3,), dtype=q.dtype, device=q.device)
        R = torch.eye(3, dtype=q.dtype, device=q.device).expand(x.shape + (3, 3))
        return R, x[..., None] * ax                  # PRISMATIC

    def neutral(self) -> torch.Tensor:
        """Neutral configuration (identity transforms), like pinocchio::neutral."""
        return torch.zeros((self.nq,), dtype=self.dtype, device=self.device)

    def random_configuration(self, batch_shape=(),
                             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Uniform joint values in [-pi, pi], drawn on the tree's device
        from ``generator`` (whose device must match)."""
        u = torch.rand(tuple(batch_shape) + (self.nq,), generator=generator,
                       dtype=self.dtype, device=self.device)
        return (2.0 * u - 1.0) * math.pi

    def integrate(self, q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
        """Configuration-manifold integration q ⊕ dq (`pinocchio::integrate`).
        Every supported joint is a 1-dof vector-space joint with
        idx_q == idx_v, so the step is a plain addition."""
        return q + dq

    # ------------------------------------------------------------------ #
    # forward kinematics
    # ------------------------------------------------------------------ #
    def fwd_kinematics(self, q: torch.Tensor):
        """liMi and oMi for all joints.

        Returns ``(liMi_R, liMi_p, oMi_R, oMi_p)`` each with leading batch
        dims of ``q`` and a joint axis of size N.  ``liMi = placement * M(q)``
        and ``oMi = oMi[parent] * liMi`` exactly as FwdPassInit
        (loik-loid-optimized.hxx:264-265)."""
        liMi_R, liMi_p, oMi_R, oMi_p = [], [], [], []
        for i in range(self.njoints):
            Rj, pj = self.joint_calc(i, q)
            R, p = spatial.se3_compose(self.placement_R[i], self.placement_p[i], Rj, pj)
            liMi_R.append(R)
            liMi_p.append(p)
            par = self.parents[i]
            if par < 0:
                oMi_R.append(R)
                oMi_p.append(p)
            else:
                Ro, po = spatial.se3_compose(oMi_R[par], oMi_p[par], R, p)
                oMi_R.append(Ro)
                oMi_p.append(po)
        return (torch.stack(liMi_R, dim=-3), torch.stack(liMi_p, dim=-2),
                torch.stack(oMi_R, dim=-3), torch.stack(oMi_p, dim=-2))
