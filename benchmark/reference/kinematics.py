"""Plain kinematics of a URDF robot: the reference's own model.

Reads the raw URDF with `xml.etree`, keeps the moving joints (revolute and
prismatic; fixed joints fold into the next joint's placement; a free-flyer
base is prepended on request) and computes, in any floating dtype, each
joint frame's placement and the Jacobian that maps joint velocities to the
frame's spatial velocity in its own local frame, [linear; angular], the
convention of Pinocchio and of the solver under test.  Imports nothing of
the program.
"""

from __future__ import annotations

import dataclasses
import math
import xml.etree.ElementTree as ET
from typing import List, Optional, Sequence

import torch


def _floats(text: Optional[str], default) -> List[float]:
    return [float(x) for x in text.split()] if text else list(default)


def _rpy(r: float, p: float, y: float) -> List[List[float]]:
    """URDF roll-pitch-yaw: R = Rz(y) Ry(p) Rx(r)."""
    cr, sr, cp, sp, cy, sy = (math.cos(r), math.sin(r), math.cos(p), math.sin(p),
                              math.cos(y), math.sin(y))
    return [[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr]]


def _mat(a, b):
    return [[sum(a[i][k] * b[k][j] for k in range(3)) for j in range(3)] for i in range(3)]


def _vec(a, v):
    return [sum(a[i][k] * v[k] for k in range(3)) for i in range(3)]


@dataclasses.dataclass(frozen=True)
class Joint:
    name: str
    kind: str                      # "revolute", "prismatic" or "free"
    parent: int                    # index into the kept joints, -1 for the root
    R0: List[List[float]]          # placement in the parent joint's frame
    p0: List[float]
    axis: List[float]
    lower: float
    upper: float
    nq: int
    nv: int


@dataclasses.dataclass(frozen=True)
class Robot:
    joints: List[Joint]

    @property
    def names(self) -> List[str]:
        return [j.name for j in self.joints]

    @property
    def nq(self) -> int:
        return sum(j.nq for j in self.joints)

    @property
    def nv(self) -> int:
        return sum(j.nv for j in self.joints)

    def q_slices(self):
        out, a = [], 0
        for j in self.joints:
            out.append(slice(a, a + j.nq))
            a += j.nq
        return out

    def v_slices(self):
        out, a = [], 0
        for j in self.joints:
            out.append(slice(a, a + j.nv))
            a += j.nv
        return out


def load(path: str, floating_base: bool = False,
         keep: Optional[Sequence[str]] = None) -> Robot:
    """The moving joints of the URDF at ``path`` in depth-first order.  With
    ``keep``, only the joints named there (each one's ancestors must be kept
    too); ``floating_base`` prepends a free-flyer named "root_joint"."""
    root = ET.parse(path).getroot()
    raw = []
    for j in root.findall("joint"):
        o = j.find("origin")
        xyz = _floats(o.get("xyz") if o is not None else None, (0, 0, 0))
        rpy = _floats(o.get("rpy") if o is not None else None, (0, 0, 0))
        ax = j.find("axis")
        lim = j.find("limit")
        raw.append(dict(
            name=j.get("name"), type=j.get("type"),
            parent=j.find("parent").get("link"), child=j.find("child").get("link"),
            R=_rpy(*rpy), p=xyz,
            axis=_floats(ax.get("xyz") if ax is not None else None, (1, 0, 0)),
            lower=float(lim.get("lower", "nan")) if lim is not None else float("nan"),
            upper=float(lim.get("upper", "nan")) if lim is not None else float("nan")))
    children = {l.get("name"): [] for l in root.findall("link")}
    for r in raw:
        children[r["parent"]].append(r)
    roots = set(children) - {r["child"] for r in raw}
    if len(roots) != 1:
        raise ValueError(f"{path}: expected one root link, got {sorted(roots)}")
    eye = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    joints: List[Joint] = []
    if floating_base:
        joints.append(Joint("root_joint", "free", -1, eye, [0.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                            float("nan"), float("nan"), 7, 6))

    def walk(link, parent, R, p):
        for r in sorted(children[link], key=lambda r: r["name"]):
            Rc, pc = _mat(R, r["R"]), [a + b for a, b in zip(p, _vec(R, r["p"]))]
            if r["type"] == "fixed" or (keep is not None and r["name"] not in keep):
                if r["type"] == "fixed":
                    walk(r["child"], parent, Rc, pc)
                continue
            if r["type"] not in ("revolute", "prismatic"):
                raise ValueError(f"{path}: joint type {r['type']} is not modelled")
            n = math.sqrt(sum(a * a for a in r["axis"]))
            joints.append(Joint(r["name"], r["type"], parent, Rc, pc,
                                [a / n for a in r["axis"]], r["lower"], r["upper"], 1, 1))
            walk(r["child"], len(joints) - 1, eye, [0.0, 0.0, 0.0])

    walk(roots.pop(), 0 if floating_base else -1, eye, [0.0, 0.0, 0.0])
    if keep is not None and sorted(keep) != sorted(j.name for j in joints
                                                   if j.kind != "free"):
        raise ValueError(f"{path}: joints {sorted(keep)} are not a connected subtree")
    return Robot(joints)


def quat_to_rot(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) (..., 4) to a rotation matrix (..., 3, 3)."""
    quat = quat / quat.norm(dim=-1, keepdim=True)
    x, y, z, w = quat.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def axis_rot(axis: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rodrigues: the rotation by ``ang`` (B,) about the unit ``axis`` (3,)."""
    x, y, z = axis.unbind(-1)
    c, s = torch.cos(ang), torch.sin(ang)
    t = 1 - c
    return torch.stack([
        torch.stack([c + x * x * t, x * y * t - z * s, x * z * t + y * s], -1),
        torch.stack([y * x * t + z * s, c + y * y * t, y * z * t - x * s], -1),
        torch.stack([z * x * t - y * s, z * y * t + x * s, c + z * z * t], -1),
    ], -2)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-2)


def jacobians(robot: Robot, q: torch.Tensor, dtype=torch.float64) -> List[torch.Tensor]:
    """For each joint, the (B, 6, nv) matrix mapping joint velocities to the
    joint frame's spatial velocity in its local frame, for configurations q
    (B, nq), computed in ``dtype``: v_i = X_i^-1 v_parent + S_i nu_i, where
    X_i = (R, p) is the placement times the joint's motion and
    X^-1 (v, w) = (R' (v - p x w), R' w)."""
    q = q.to(dtype)
    B, dev = q.shape[0], q.device
    out: List[torch.Tensor] = []
    qs, vs = robot.q_slices(), robot.v_slices()
    for i, j in enumerate(robot.joints):
        R0 = torch.tensor(j.R0, dtype=dtype, device=dev)
        p0 = torch.tensor(j.p0, dtype=dtype, device=dev)
        if j.kind == "free":
            qi = q[:, qs[i]]
            R, p = quat_to_rot(qi[:, 3:7]), qi[:, 0:3]
        else:
            ax = torch.tensor(j.axis, dtype=dtype, device=dev)
            qi = q[:, qs[i].start]
            if j.kind == "revolute":
                R, p = R0 @ axis_rot(ax, qi), p0.expand(B, 3)
            else:
                R = R0.expand(B, 3, 3)
                p = p0 + qi[:, None] * (R0 @ ax)
        J = torch.zeros((B, 6, robot.nv), dtype=dtype, device=dev)
        if j.parent >= 0:
            Jp = out[j.parent]
            lin, ang = Jp[:, :3], Jp[:, 3:]
            Rt = R.transpose(-1, -2)
            J[:, :3] = Rt @ (lin - _cross(p[:, :, None].expand_as(ang), ang))
            J[:, 3:] = Rt @ ang
        sl = vs[i]
        if j.kind == "free":
            J[:, :, sl] += torch.eye(6, dtype=dtype, device=dev)
        elif j.kind == "revolute":
            J[:, 3:, sl.start] += torch.tensor(j.axis, dtype=dtype, device=dev)
        else:
            J[:, :3, sl.start] += torch.tensor(j.axis, dtype=dtype, device=dev)
        out.append(J)
    return out


def frames(robot: Robot, q: torch.Tensor, dtype=torch.float64):
    """Each joint frame's placement in the world, (R (B, N, 3, 3), p (B, N, 3))."""
    q = q.to(dtype)
    B, dev = q.shape[0], q.device
    Rs, ps = [], []
    for i, (j, sl) in enumerate(zip(robot.joints, robot.q_slices())):
        R0 = torch.tensor(j.R0, dtype=dtype, device=dev)
        p0 = torch.tensor(j.p0, dtype=dtype, device=dev)
        if j.kind == "free":
            R, p = quat_to_rot(q[:, sl.start + 3:sl.stop]), q[:, sl.start:sl.start + 3]
        elif j.kind == "revolute":
            R, p = R0 @ axis_rot(torch.tensor(j.axis, dtype=dtype, device=dev), q[:, sl.start]), \
                p0.expand(B, 3)
        else:
            R = R0.expand(B, 3, 3)
            p = p0 + q[:, sl.start, None] * (R0 @ torch.tensor(j.axis, dtype=dtype, device=dev))
        if j.parent >= 0:
            Rp, pp = Rs[j.parent], ps[j.parent]
            R, p = Rp @ R, pp + (Rp @ p[..., None])[..., 0]
        Rs.append(R)
        ps.append(p)
    return torch.stack(Rs, 1), torch.stack(ps, 1)
