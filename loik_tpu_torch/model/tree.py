"""KinematicTree: the port's replacement for `pinocchio::ModelTpl`.

Mirrors `loik_tpu.model.tree.KinematicTree`: the topology is static Python
metadata (parents, joint types, dof indexing) and the geometry is tensor
leaves (joint placements, axes).  Each *moving* joint i (0-based; the
universe is not stored) has

  parent[i] in {-1} U [0, i)   (-1 = attached to the world)
  a motion subspace S[i] (6 x nv_i) in the local joint frame
  a configuration map M(q_i) computed per joint type.

The joint types and their codes are those of `loik_tpu`: revolute
(arbitrary axis), prismatic, free-flyer, spherical, unbounded revolute
(nq=2 cos/sin, the Pinocchio convention for URDF `continuous`), translation
(3-dof), planar (x, y, theta with nq=4 x/y/cos/sin), helical, and the three
types whose motion subspace depends on the CONFIGURATION: universal (two
sequential rotations), spherical-ZYX (Euler-angle rates) and the merged
master->mimic pair.  Trees that hold one of those use the q-aware
`joint_S(i, q)`, and the solver computes per-problem subspaces once per
solve.

Functions that make tensors from nothing (`make_tree` here, the robots, the
URDF loader, the builders) take ``device=None``, meaning the CUDA device.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from .. import spatial

# Joint type codes, equal to loik_tpu.model.tree's
REVOLUTE = 0
PRISMATIC = 1
FREE_FLYER = 2
SPHERICAL = 3
REVOLUTE_UNBOUNDED = 4   # nq = (cos, sin): pinocchio JointModelRevoluteUnbounded
TRANSLATION = 5          # 3-dof translation: pinocchio JointModelTranslation
PLANAR = 6               # x, y, theta; nq = (x, y, cos, sin): JointModelPlanar
UNIVERSAL = 7            # two sequential rotations: pinocchio JointModelUniversal
HELICAL = 8              # screw: rotation + pitch-coupled translation along one
                         # axis (JointModelHelical); the pitch is static metadata
SPHERICAL_ZYX = 9        # ball joint on the Euler Z-Y-X chart: nq = nv = 3
                         # Euler-angle rates, vector-space integration
MIMIC_PAIR = 10          # a serial master->mimic pair (URDF <mimic>:
                         # q_mimic = mult*q_master + offset) merged into ONE
                         # 1-dof joint: FK composes master transform, inner
                         # placement and mimic transform.  (master_type,
                         # mimic_type, mult, offset) live in the static `mimic`
                         # tuple; the inner placement is placement2_R/p.

JOINT_NV = {REVOLUTE: 1, PRISMATIC: 1, FREE_FLYER: 6, SPHERICAL: 3,
            REVOLUTE_UNBOUNDED: 1, TRANSLATION: 3, PLANAR: 3, UNIVERSAL: 2,
            HELICAL: 1, SPHERICAL_ZYX: 3, MIMIC_PAIR: 1}
JOINT_NQ = {REVOLUTE: 1, PRISMATIC: 1, FREE_FLYER: 7, SPHERICAL: 4,
            REVOLUTE_UNBOUNDED: 2, TRANSLATION: 3, PLANAR: 4, UNIVERSAL: 2,
            HELICAL: 1, SPHERICAL_ZYX: 3, MIMIC_PAIR: 1}

_Q_DEPENDENT = (UNIVERSAL, SPHERICAL_ZYX, MIMIC_PAIR)


def resolve_device(device) -> torch.device:
    """``device=None`` is the CUDA device: the package's constructors build
    on the card unless the caller names another device.  No probing and no
    fallback: without a card the first allocation raises torch's own error."""
    return torch.device("cuda") if device is None else torch.device(device)


def _calc_1dof(t, axis, ang):
    """(R, p) displacement of a 1-dof revolute/prismatic joint at angle/
    offset ``ang`` (leading batch dims supported)."""
    if t == REVOLUTE:
        R = spatial.rotation_about_axis(axis.expand(ang.shape + (3,)), ang)
        return R, torch.zeros(ang.shape + (3,), dtype=axis.dtype, device=axis.device)
    if t == PRISMATIC:
        R = torch.eye(3, dtype=axis.dtype, device=axis.device).expand(ang.shape + (3, 3))
        return R, ang[..., None] * axis
    raise ValueError(f"mimic pairs support revolute/prismatic members; got {t}")


def _twist_1dof(t, axis):
    """(linear, angular) parts of a 1-dof joint's unit twist."""
    zero = torch.zeros_like(axis)
    if t == REVOLUTE:
        return zero, axis
    if t == PRISMATIC:
        return axis, zero
    raise ValueError(f"mimic pairs support revolute/prismatic members; got {t}")


def _mtv(R, v):
    """R^T v over leading batch dims."""
    return (R.transpose(-1, -2) @ v[..., None])[..., 0]


@dataclasses.dataclass(frozen=True)
class KinematicTree:
    """Frozen kinematic tree: static topology, tensor geometry."""

    # --- tensor leaves ---
    # placement_R, placement_p and axis may carry one batch axis after the
    # joint axis, (N, B, ...): per-problem geometry, used by the mixed
    # super-batch (parallel/mixed.py) for chains of 1-dof joints
    placement_R: torch.Tensor     # (N, 3, 3) fixed joint placement rotation (parent frame)
    placement_p: torch.Tensor     # (N, 3) fixed joint placement translation
    axis: torch.Tensor            # (N, 3) unit motion axis; unused by axis-free types
    velocity_limit: torch.Tensor  # (nv,) default box bound magnitude per dof

    # --- static metadata ---
    parents: Tuple[int, ...]      # (N,) parent joint index, -1 = world
    jtypes: Tuple[int, ...]       # (N,) joint type codes
    idx_v: Tuple[int, ...]        # (N,) first dof index of each joint
    idx_q: Tuple[int, ...]        # (N,) first config index of each joint
    joint_names: Tuple[str, ...]  # (N,)
    name: str = "robot"
    # second rotation axis (universal joints and mimic pairs; None otherwise)
    axis2: Optional[torch.Tensor] = None         # (N, 3)
    # helical pitch per joint (static); None = no helical joint
    pitches: Optional[Tuple[float, ...]] = None
    # mimic-pair metadata (static): per joint None or
    # (master_type, mimic_type, multiplier, offset); None = no mimic pairs
    mimic: Optional[Tuple[Optional[Tuple], ...]] = None
    # inner placement between a mimic pair's master and mimic joints
    placement2_R: Optional[torch.Tensor] = None  # (N, 3, 3)
    placement2_p: Optional[torch.Tensor] = None  # (N, 3)

    def __post_init__(self):
        for t, name in zip(self.jtypes, self.joint_names):
            if t not in JOINT_NV:
                raise ValueError(f"joint '{name}' has unknown type code {t}")
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
    def depth(self) -> int:
        """Longest root-to-leaf chain length."""
        d = {}
        for i, p in enumerate(self.parents):
            d[i] = 1 if p < 0 else d[p] + 1
        return max(d.values())

    @property
    def dtype(self) -> torch.dtype:
        return self.placement_R.dtype

    @property
    def device(self) -> torch.device:
        return self.placement_R.device

    def children(self, i: int) -> Tuple[int, ...]:
        return tuple(j for j, p in enumerate(self.parents) if p == i)

    @property
    def leaf_joints(self) -> Tuple[int, ...]:
        has_child = set(p for p in self.parents if p >= 0)
        return tuple(i for i in range(self.njoints) if i not in has_child)

    @property
    def dof_joint(self) -> Tuple[int, ...]:
        """(nv,) joint index owning each dof."""
        out = []
        for i, nvi in enumerate(self.nvs):
            out.extend([i] * nvi)
        return tuple(out)

    @property
    def padded_to_flat(self) -> Tuple[int, ...]:
        """(nv,) index into a flattened (N*nv_max,) padded dof array."""
        out = []
        for i, nvi in enumerate(self.nvs):
            out.extend(i * self.nv_max + k for k in range(nvi))
        return tuple(out)

    def to(self, device=None, dtype: Optional[torch.dtype] = None) -> "KinematicTree":
        """The same tree with its tensor leaves on ``device`` and in ``dtype``
        (the tree itself when that changes nothing)."""
        if ((device is None or torch.device(device) == self.device)
                and (dtype is None or dtype == self.dtype)):
            return self

        def conv(x):
            if x is None:
                return None
            return x.to(device=device or x.device, dtype=dtype or x.dtype)

        return dataclasses.replace(self, **{f: conv(getattr(self, f)) for f in _LEAVES})

    def astype(self, dtype: torch.dtype) -> "KinematicTree":
        """The tree in ``dtype``: the tree itself when it is in ``dtype``
        already, else ONE cast tree per (tree, dtype), kept as long as this
        tree lives (`derived`).  A solve that casts on every call (the
        delta-duals refinement's float32 and float64 trees) then hands a
        captured CUDA graph the same tree, whose tensors the graph reads,
        every call."""
        if dtype == self.dtype:
            return self
        return derived(self, ("astype", dtype), lambda t: t.to(dtype=dtype))

    # ------------------------------------------------------------------ #
    # motion subspaces
    # ------------------------------------------------------------------ #
    @property
    def has_q_dependent_S(self) -> bool:
        """True when any joint's motion subspace depends on the configuration
        (universal / spherical-ZYX / mimic-pair joints): the solver then
        computes per-problem subspaces at solve time."""
        return any(t in _Q_DEPENDENT for t in self.jtypes)

    @property
    def has_batched_geometry(self) -> bool:
        """True when the geometry leaves carry a per-problem batch axis
        (axis of shape (N, B, 3)): the mixed super-batch's padded chain."""
        return self.axis.ndim == 3

    def _const(self, rows) -> torch.Tensor:
        return torch.tensor(rows, dtype=self.dtype, device=self.device)

    def joint_S(self, i: int, q: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Motion subspace of joint i, shape (6, nv_i), [linear; angular] rows.

        With batched geometry leaves (axis of shape (N, B, 3)) the 1-dof
        subspaces gain a LEADING batch dim: (B, 6, 1).  Universal,
        spherical-ZYX and mimic-pair joints are configuration-dependent:
        pass ``q`` (shape (..., nq)); batch dims of ``q`` lead the result."""
        t = self.jtypes[i]
        if t in (REVOLUTE, REVOLUTE_UNBOUNDED, PRISMATIC, HELICAL):
            ax = self.axis[i]                                 # (3,) or (B, 3)
            if t == PRISMATIC:
                col = torch.cat([ax, torch.zeros_like(ax)], dim=-1)
            elif t == HELICAL:
                # screw twist [pitch*a; a]: pitch is the translation per
                # RADIAN of rotation (pinocchio JointModelHelical, v = h*w)
                h = float(self.pitches[i]) if self.pitches is not None else 0.0
                col = torch.cat([h * ax, ax], dim=-1)
            else:
                col = torch.cat([torch.zeros_like(ax), ax], dim=-1)
            return col[..., None]                             # (..., 6, 1)
        eye3 = torch.eye(3, dtype=self.dtype, device=self.device)
        if t == FREE_FLYER:
            return torch.eye(6, dtype=self.dtype, device=self.device)
        if t == SPHERICAL:
            return torch.cat([torch.zeros_like(eye3), eye3], dim=0)
        if t == TRANSLATION:
            return torch.cat([eye3, torch.zeros_like(eye3)], dim=0)
        if t == PLANAR:
            # local-frame planar twist: v = (vx, vy, 0; 0, 0, w): constant S
            # (pinocchio MotionPlanar; integration handles the manifold).
            # Columns of the identity, built on the device: no host data, so
            # a captured CUDA graph may evaluate it
            e = torch.eye(6, dtype=self.dtype, device=self.device)
            return torch.stack([e[:, 0], e[:, 1], e[:, 5]], dim=-1)
        if q is None:
            kind = {SPHERICAL_ZYX: "spherical-ZYX", MIMIC_PAIR: "a mimic pair",
                    UNIVERSAL: "universal"}[t]
            raise ValueError(
                f"joint {i} is {kind}: its motion subspace depends on the "
                "configuration; call joint_S(i, q)"
            )
        iq = self.idx_q[i]
        if t == SPHERICAL_ZYX:
            # body-frame angular velocity of R = Rz(a) Ry(b) Rx(c) in terms
            # of Euler-angle rates (the joint's velocity coordinates):
            #   w = a' Rx(c)^T Ry(b)^T ez + b' Rx(c)^T ey + c' ex
            b_, c_ = q[..., iq + 1], q[..., iq + 2]
            cb, sb = torch.cos(b_), torch.sin(b_)
            cc, sc = torch.cos(c_), torch.sin(c_)
            z, o = torch.zeros_like(cb), torch.ones_like(cb)
            col0 = torch.stack([-sb, sc * cb, cc * cb], dim=-1)
            col1 = torch.stack([z, cc, -sc], dim=-1)
            col2 = torch.stack([o, z, z], dim=-1)
            ang = torch.stack([col0, col1, col2], dim=-1)      # (..., 3, 3)
            return torch.cat([torch.zeros_like(ang), ang], dim=-2)
        if t == MIMIC_PAIR:
            # merged serial pair: v_C = [Ad^-1_{X2 M2(q2)} S_m + k S_j] q1'
            # with q2 = k q1 + o; the coupling makes the column
            # configuration-dependent through M2
            mt, jt, k_, o_ = self.mimic[i]
            q1 = q[..., iq]
            q2 = k_ * q1 + o_
            a1, a2 = self.axis[i], self.axis2[i]
            R2, p2 = _calc_1dof(jt, a2, q2)
            R2p, p2p = self.placement2_R[i], self.placement2_p[i]
            Rc = R2p @ R2                                     # (..., 3, 3)
            pc = p2p + (R2p @ p2[..., None])[..., 0]
            v1, w1 = _twist_1dof(mt, a1)
            v1 = v1.expand(q1.shape + (3,))
            w1 = w1.expand(q1.shape + (3,))
            vp = _mtv(Rc, v1 - torch.linalg.cross(pc, w1))
            wp = _mtv(Rc, w1)
            v2, w2 = _twist_1dof(jt, a2)
            col = torch.cat([vp + k_ * v2, wp + k_ * w2], dim=-1)
            return col[..., None]                             # (..., 6, 1)
        # UNIVERSAL: body-frame angular velocity of M = R1(q1) R2(q2):
        #   w = q1' R2(q2)^T a1 + q2' a2   (depends on q2)
        a1, a2 = self.axis[i], self.axis2[i]
        q2 = q[..., iq + 1]
        R2 = spatial.rotation_about_axis(a2.expand(q2.shape + (3,)), q2)
        col1 = _mtv(R2, a1.expand(q2.shape + (3,)))
        col2 = a2.expand(q2.shape + (3,))
        ang = torch.stack([col1, col2], dim=-1)               # (..., 3, 2)
        return torch.cat([torch.zeros_like(ang), ang], dim=-2)

    def joint_S_padded(self, q: Optional[torch.Tensor] = None) -> torch.Tensor:
        """All subspaces zero-padded to (N, 6, nv_max), or (N, B, 6, nv_max)
        with batched geometry leaves; pass ``q`` (unbatched) when the tree
        holds configuration-dependent joints."""
        nvm = self.nv_max
        mats = []
        for i in range(self.njoints):
            S = self.joint_S(i, q)
            mats.append(torch.nn.functional.pad(S, (0, nvm - S.shape[-1])))
        return torch.stack(mats)

    def dof_mask_padded(self) -> torch.Tensor:
        """(N, nv_max) 1.0 where the padded dof slot is real."""
        m = np.zeros((self.njoints, self.nv_max))
        for i, nvi in enumerate(self.nvs):
            m[i, :nvi] = 1.0
        return self._const(m.tolist())

    # ------------------------------------------------------------------ #
    # configuration-dependent joint transforms
    # ------------------------------------------------------------------ #
    def joint_calc(self, i: int, q: torch.Tensor):
        """M(q_i): joint displacement (R, p) in the joint's local frame.

        q has shape (..., nq); batching over leading dims is supported.
        With batched geometry leaves the joint's axis is (B, 3) and
        broadcasts against a (B, nq) q.  Mirrors `jmodel.calc(jdata, q)` in
        FwdPassInit (loik-loid-optimized.hxx:263)."""
        t = self.jtypes[i]
        iq = self.idx_q[i]
        ax = self.axis[i]
        kw = dict(dtype=q.dtype, device=q.device)

        def zeros3(like):
            return torch.zeros(like.shape + (3,), **kw)

        def eye3(like):
            return torch.eye(3, **kw).expand(like.shape + (3, 3))

        if t == REVOLUTE:
            ang = q[..., iq]
            return spatial.rotation_about_axis(ax.expand(ang.shape + (3,)), ang), zeros3(ang)
        if t == PRISMATIC:
            d = q[..., iq]
            return eye3(d), d[..., None] * ax
        if t == HELICAL:
            ang = q[..., iq]
            R = spatial.rotation_about_axis(ax.expand(ang.shape + (3,)), ang)
            h = float(self.pitches[i]) if self.pitches is not None else 0.0
            return R, (h * ang)[..., None] * ax
        if t == FREE_FLYER:
            return spatial.quat_to_rotmat(q[..., iq + 3: iq + 7]), q[..., iq: iq + 3]
        if t == SPHERICAL:
            R = spatial.quat_to_rotmat(q[..., iq: iq + 4])
            return R, torch.zeros(R.shape[:-2] + (3,), **kw)
        if t == REVOLUTE_UNBOUNDED:
            # nq = (cos, sin), normalized like pinocchio (robust to drift)
            c, s = q[..., iq], q[..., iq + 1]
            n = torch.sqrt(c * c + s * s)
            c, s = c / n, s / n
            return spatial.rotation_about_axis_cs(ax.expand(c.shape + (3,)), c, s), zeros3(c)
        if t == TRANSLATION:
            p = q[..., iq: iq + 3]
            return eye3(p[..., 0]), p
        if t == PLANAR:
            x, y = q[..., iq], q[..., iq + 1]
            c, s = q[..., iq + 2], q[..., iq + 3]
            n = torch.sqrt(c * c + s * s)
            c, s = c / n, s / n
            o, l = torch.zeros_like(c), torch.ones_like(c)
            R = torch.stack(
                [
                    torch.stack([c, -s, o], dim=-1),
                    torch.stack([s, c, o], dim=-1),
                    torch.stack([o, o, l], dim=-1),
                ],
                dim=-2,
            )
            return R, torch.stack([x, y, torch.zeros_like(x)], dim=-1)
        if t == SPHERICAL_ZYX:
            # R = Rz(a) Ry(b) Rx(c) == rpy_to_rotmat((c, b, a))
            a_, b_, c_ = q[..., iq], q[..., iq + 1], q[..., iq + 2]
            return spatial.rpy_to_rotmat(torch.stack([c_, b_, a_], dim=-1)), zeros3(a_)
        if t == UNIVERSAL:
            q1, q2 = q[..., iq], q[..., iq + 1]
            R1 = spatial.rotation_about_axis(ax.expand(q1.shape + (3,)), q1)
            R2 = spatial.rotation_about_axis(self.axis2[i].expand(q2.shape + (3,)), q2)
            return R1 @ R2, zeros3(q1)
        # MIMIC_PAIR: M = M_master(q1) * X2 * M_mimic(k q1 + o)
        mt, jt, k_, o_ = self.mimic[i]
        q1 = q[..., iq]
        q2 = k_ * q1 + o_
        R1, p1 = _calc_1dof(mt, ax, q1)
        R2, p2 = _calc_1dof(jt, self.axis2[i], q2)
        R2p, p2p = self.placement2_R[i], self.placement2_p[i]
        Rc = R2p @ R2
        pc = p2p + (R2p @ p2[..., None])[..., 0]
        return R1 @ Rc, p1 + (R1 @ pc[..., None])[..., 0]

    def neutral(self) -> torch.Tensor:
        """Neutral configuration (identity transforms), like pinocchio::neutral."""
        q = np.zeros((self.nq,))
        for i, t in enumerate(self.jtypes):
            if t == FREE_FLYER:
                q[self.idx_q[i] + 6] = 1.0  # unit quaternion w
            elif t == SPHERICAL:
                q[self.idx_q[i] + 3] = 1.0
            elif t == REVOLUTE_UNBOUNDED:
                q[self.idx_q[i]] = 1.0      # cos = 1
            elif t == PLANAR:
                q[self.idx_q[i] + 2] = 1.0  # cos = 1
        return self._const(q.tolist())

    def random_configuration(self, batch_shape=(),
                             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Random configuration drawn on the tree's device from ``generator``
        (whose device must match): angles in [-pi, pi], quaternions uniform,
        xyz in [-1, 1]."""
        u = torch.rand(tuple(batch_shape) + (self.nq,), generator=generator,
                       dtype=self.dtype, device=self.device)
        q = (2.0 * u - 1.0) * math.pi
        # normalize quaternion / (cos, sin) blocks; translations to [-1, 1]
        for i, t in enumerate(self.jtypes):
            iq = self.idx_q[i]
            if t in (FREE_FLYER, SPHERICAL):
                iqq = iq + (3 if t == FREE_FLYER else 0)
                quat = q[..., iqq: iqq + 4]
                q[..., iqq: iqq + 4] = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
            if t in (FREE_FLYER, TRANSLATION):
                q[..., iq: iq + 3] = q[..., iq: iq + 3] / math.pi
            elif t == REVOLUTE_UNBOUNDED:
                ang = q[..., iq].clone()  # uniform angle -> (cos, sin) on the circle
                q[..., iq] = torch.cos(ang)
                q[..., iq + 1] = torch.sin(ang)
            elif t == PLANAR:
                q[..., iq: iq + 2] = q[..., iq: iq + 2] / math.pi
                ang = q[..., iq + 2].clone()
                q[..., iq + 2] = torch.cos(ang)
                q[..., iq + 3] = torch.sin(ang)
        return q

    def integrate(self, q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
        """Configuration-manifold integration q (+) dq, Pinocchio convention
        (`pinocchio::integrate`): dq (..., nv) is a tangent step expressed in
        the joint's LOCAL frame.  Closes the tracking loop
        (q_next = integrate(q, dt * nu)).  Leading dims of q and dq broadcast.

        Revolute/prismatic add; spherical right-multiplies the quaternion by
        exp3(dw); free-flyer right-multiplies the SE(3) pose by exp6(dv)."""
        batch = torch.broadcast_shapes(q.shape[:-1], dq.shape[:-1])
        out = q.expand(batch + (self.nq,)).clone()
        for i, t in enumerate(self.jtypes):
            iq, iv = self.idx_q[i], self.idx_v[i]
            if t in (REVOLUTE, PRISMATIC, HELICAL, MIMIC_PAIR):
                out[..., iq] = out[..., iq] + dq[..., iv]
            elif t in (TRANSLATION, UNIVERSAL, SPHERICAL_ZYX):
                # vector-space joints: plain addition (a translation joint's
                # local frame never rotates, the universal joint's
                # configuration is two bounded angles, and spherical-ZYX
                # velocities ARE the Euler-angle rates)
                k = JOINT_NV[t]
                out[..., iq: iq + k] = out[..., iq: iq + k] + dq[..., iv: iv + k]
            elif t == REVOLUTE_UNBOUNDED:
                c, s = out[..., iq].clone(), out[..., iq + 1].clone()
                dth = dq[..., iv]
                dc, ds = torch.cos(dth), torch.sin(dth)
                out[..., iq] = c * dc - s * ds
                out[..., iq + 1] = s * dc + c * ds
            elif t == PLANAR:
                # SE(2) manifold step: M_new = M(q) * exp2(dq), local tangent
                c, s = out[..., iq + 2].clone(), out[..., iq + 3].clone()
                dc, ds, tx, ty = spatial.se2_exp(
                    dq[..., iv], dq[..., iv + 1], dq[..., iv + 2])
                out[..., iq] = out[..., iq] + c * tx - s * ty
                out[..., iq + 1] = out[..., iq + 1] + s * tx + c * ty
                out[..., iq + 2] = c * dc - s * ds
                out[..., iq + 3] = s * dc + c * ds
            elif t == SPHERICAL:
                dquat = spatial.exp3_quat(dq[..., iv: iv + 3])
                out[..., iq: iq + 4] = spatial.quat_mul(out[..., iq: iq + 4], dquat)
            else:  # FREE_FLYER
                p = out[..., iq: iq + 3]
                quat = out[..., iq + 3: iq + 7]
                R = spatial.quat_to_rotmat(quat)
                dp = spatial.se3_exp_translation(dq[..., iv: iv + 6])
                p_new = p + (R @ dp[..., None])[..., 0]
                # rotation updates in quaternion space (no rotmat->quat)
                dquat = spatial.exp3_quat(dq[..., iv + 3: iv + 6])
                out[..., iq + 3: iq + 7] = spatial.quat_mul(quat, dquat)
                out[..., iq: iq + 3] = p_new
        return out

    # ------------------------------------------------------------------ #
    # forward kinematics
    # ------------------------------------------------------------------ #
    def fwd_kinematics(self, q: torch.Tensor):
        """liMi and oMi for all joints.

        Returns ``(liMi_R, liMi_p, oMi_R, oMi_p)`` each with leading batch
        dims of ``q`` and a joint axis of size N.  ``liMi = placement * M(q)``
        and ``oMi = oMi[parent] * liMi`` exactly as FwdPassInit
        (loik-loid-optimized.hxx:264-265).  Batched placements (B, 3, 3)
        compose with the (B, 3, 3) joint transforms problem by problem."""
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


# id(tree) -> (weak reference to the tree, {key: (make, make(tree))}): the
# values `derived` keeps for a tree, in the order they were made
_DERIVED: dict = {}


def derived(tree: KinematicTree, key, make):
    """``make(tree)``, made once per (tree, ``key``) and kept as long as the
    tree lives: its casts (`KinematicTree.astype`) and the fused kernel's
    S operand.  ``make`` computes a tensor or a tree from the tree's
    leaves.  A tree is immutable; a captured CUDA graph that overwrites the
    leaves of the tree it holds in place brings these values up to date
    with `refresh_derived`."""
    tid = id(tree)
    slot = _DERIVED.get(tid)
    if slot is None or slot[0]() is not tree:
        slot = _DERIVED[tid] = (weakref.ref(tree, lambda ref: _forget(ref, tid)), {})
    hit = slot[1].get(key)
    if hit is None:
        hit = slot[1][key] = (make, make(tree))
    return hit[1]


def _forget(ref, tid) -> None:
    slot = _DERIVED.get(tid)
    if slot is not None and slot[0] is ref:
        del _DERIVED[tid]


def refresh_derived(tree: KinematicTree) -> None:
    """Recompute in place, from the tree's leaves as they are now, every
    value `derived` keeps for ``tree``, in the order they were made, and
    then those of each derived tree (a cast's S operand): the same
    operations as the first time, so the same bits."""
    slot = _DERIVED.get(id(tree))
    if slot is None or slot[0]() is not tree:
        return
    for make, value in list(slot[1].values()):
        new = make(tree)
        if isinstance(value, KinematicTree):
            for f in _LEAVES:
                dst = getattr(value, f)
                if dst is not None:
                    dst.copy_(getattr(new, f))
            refresh_derived(value)
        else:
            value.copy_(new)


# the tensor leaves of a tree, in loik_tpu's pytree order
_LEAVES = ("placement_R", "placement_p", "axis", "velocity_limit", "axis2",
           "placement2_R", "placement2_p")

COMPOSITE = "composite"  # make_tree-level sugar, expanded before building


def _rpy_R(rpy) -> np.ndarray:
    return spatial.rpy_to_rotmat(torch.as_tensor(np.asarray(rpy, np.float64))).numpy()


def _mount_R_p(j):
    """A joint dict's own placement as (R, p) numpy matrices."""
    if "R" in j:
        R = np.asarray(j["R"], np.float64)
    else:
        R = _rpy_R(j.get("rpy", (0.0, 0.0, 0.0)))
    return R, np.asarray(j.get("xyz", (0.0, 0.0, 0.0)), np.float64)


def _compose_mount(mount, target):
    """Fold `mount`'s placement into `target`'s (target <- mount * target)."""
    Rm, pm = _mount_R_p(mount)
    Rs, ps = _mount_R_p(target)
    for key in ("R", "rpy", "xyz"):
        target.pop(key, None)
    target["R"] = Rm @ Rs
    target["xyz"] = tuple(pm + Rm @ ps)


def _composite_subs(j):
    """Recursively flatten a composite's `sub` list into plain joint dicts
    (nested composites expand in place, their mount placements composed into
    their own first sub)."""
    subs = []
    for k, sj in enumerate(j["sub"]):
        sj = dict(sj)
        sj.setdefault("name", f"{j['name']}/{k}")
        if sj.get("type") == COMPOSITE:
            if not sj.get("sub"):
                raise ValueError(f"composite joint '{sj['name']}' has no subs")
            inner = _composite_subs(sj)
            _compose_mount(sj, inner[0])
            subs.extend(inner)
        else:
            subs.append(sj)
    return subs


def expand_composites(joints):
    """Expand `type=COMPOSITE` joint dicts into their sub-joint chains.

    A composite joint (pinocchio `JointModelComposite`) stacks sub-joints at
    one mount point: kinematically a serial chain of the subs with identity
    placements between them, which is how it expands here (the composite's
    own placement composes with the first sub's).  Nested composites expand
    recursively.  Children indices of later joints are remapped to the LAST
    sub-joint."""
    out = []
    last = {}  # original index -> expanded index of its last sub-joint
    for old_i, j in enumerate(joints):
        par = j["parent"]
        par_new = -1 if par < 0 else last[par]
        if j.get("type") == COMPOSITE:
            if not j.get("sub"):
                raise ValueError(f"composite joint '{j['name']}' has no subs")
            subs = _composite_subs(j)
            _compose_mount(j, subs[0])
            for k, sj in enumerate(subs):
                sj["parent"] = par_new if k == 0 else len(out) - 1
                out.append(sj)
        else:
            out.append(dict(j, parent=par_new))
        last[old_i] = len(out) - 1
    return out


def _unit(v) -> np.ndarray:
    v = np.asarray(v, dtype=np.float64)
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def make_tree(joints, name="robot", dtype: torch.dtype = torch.float64,
              device=None) -> KinematicTree:
    """Build a KinematicTree from a list of joint dicts.

    Each dict: {name, parent (int, -1=world), type, axis (3,) optional,
    axis2 (3,) optional (universal joints' second rotation axis),
    pitch (helical, m/rad) optional, xyz (3,) optional, rpy (3,) optional,
    R (3,3) optional (overrides rpy)}.
    `type=COMPOSITE` dicts carry a `sub` list of joint dicts (stacked at one
    mount point, pinocchio JointModelComposite) and are expanded into their
    equivalent serial chain.
    Joints must be listed in topological order (parent before child).
    ``device=None`` builds on the CUDA device."""
    joints = expand_composites(joints)
    parents, jtypes, names, pitches = [], [], [], []
    pR, pp, axes, axes2 = [], [], [], []
    mimics, p2R, p2p = [], [], []
    idx_v, idx_q = [], []
    nv = nq = 0
    for j in joints:
        par = j["parent"]
        if par >= len(parents):
            raise ValueError("joints must be topologically ordered")
        parents.append(par)
        t = j["type"]
        jtypes.append(t)
        names.append(j["name"])
        R, xyz = _mount_R_p(j)
        pR.append(R)
        pp.append(xyz)
        axes.append(_unit(j.get("axis", (0.0, 0.0, 1.0))))
        axes2.append(_unit(j.get("axis2", (0.0, 1.0, 0.0))))
        pitches.append(float(j.get("pitch", 0.0)))
        # mimic-pair extras: static coupling meta + inner placement
        if t == MIMIC_PAIR:
            m = j["mimic"]  # (master_type, mimic_type, multiplier, offset)
            mimics.append((int(m[0]), int(m[1]), float(m[2]), float(m[3])))
            p2R.append(np.asarray(j["R2"], dtype=np.float64) if "R2" in j
                       else _rpy_R(j.get("rpy2", (0.0, 0.0, 0.0))))
            p2p.append(np.asarray(j.get("xyz2", (0.0, 0.0, 0.0)), dtype=np.float64))
        else:
            mimics.append(None)
            p2R.append(np.eye(3))
            p2p.append(np.zeros(3))
        idx_v.append(nv)
        idx_q.append(nq)
        nv += JOINT_NV[t]
        nq += JOINT_NQ[t]
    vel_lim = np.full((nv,), np.inf)
    for j, iv, t in zip(joints, idx_v, jtypes):
        if "velocity_limit" in j:
            vel_lim[iv: iv + JOINT_NV[t]] = j["velocity_limit"]
    has_mimic = any(t == MIMIC_PAIR for t in jtypes)
    dev = resolve_device(device)

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=dev)

    return KinematicTree(
        placement_R=tensor(np.stack(pR)),
        placement_p=tensor(np.stack(pp)),
        axis=tensor(np.stack(axes)),
        velocity_limit=tensor(vel_lim),
        parents=tuple(parents),
        jtypes=tuple(jtypes),
        idx_v=tuple(idx_v),
        idx_q=tuple(idx_q),
        joint_names=tuple(names),
        name=name,
        axis2=(tensor(np.stack(axes2))
               if any(t in (UNIVERSAL, MIMIC_PAIR) for t in jtypes) else None),
        pitches=tuple(pitches) if any(t == HELICAL for t in jtypes) else None,
        mimic=tuple(mimics) if has_mimic else None,
        placement2_R=tensor(np.stack(p2R)) if has_mimic else None,
        placement2_p=tensor(np.stack(p2p)) if has_mimic else None,
    )
