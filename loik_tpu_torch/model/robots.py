"""Model zoo: the robots of `loik_tpu.model.robots`.

Panda and TALOS come from the package's own copies of the URDF assets
(byte-identical to `loik_tpu/model/assets/`).  UR5, Solo-12, the Talos-like
humanoid and the mobile UR5 are built programmatically: what matters to the
solver is the tree topology, joint types and dof counts; link geometry
values are realistic public kinematic parameters.

Every constructor takes ``device=None``, meaning the CUDA device, and is
cached per (dtype, device).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import torch

from .tree import (FREE_FLYER, PLANAR, REVOLUTE, REVOLUTE_UNBOUNDED, UNIVERSAL,
                   KinematicTree, make_tree)
from .urdf import load_urdf

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")


@functools.lru_cache(maxsize=None)
def panda(dtype_str: str = "float64", device=None) -> KinematicTree:
    """9-dof Franka Panda (7 revolute + 2 prismatic fingers)."""
    return load_urdf(os.path.join(_ASSETS, "panda.urdf"),
                     dtype=getattr(torch, dtype_str), device=device)


@functools.lru_cache(maxsize=None)
def panda_arm(dtype_str: str = "float64", device=None) -> KinematicTree:
    """7-dof Panda arm only (the '7-DoF constrained diff-IK' BASELINE metric)."""
    tree = panda(dtype_str, device)
    return dataclasses.replace(
        tree,
        placement_R=tree.placement_R[:7],
        placement_p=tree.placement_p[:7],
        axis=tree.axis[:7],
        velocity_limit=tree.velocity_limit[:7],
        parents=tree.parents[:7],
        jtypes=tree.jtypes[:7],
        idx_v=tree.idx_v[:7],
        idx_q=tree.idx_q[:7],
        joint_names=tree.joint_names[:7],
        name="panda_arm",
    )


@functools.lru_cache(maxsize=None)
def ur5(dtype_str: str = "float64", device=None) -> KinematicTree:
    """6-dof Universal Robots UR5 (public DH-derived joint frames)."""
    J = [
        dict(name="shoulder_pan_joint", parent=-1, type=REVOLUTE, xyz=(0, 0, 0.089159),
             axis=(0, 0, 1), velocity_limit=3.15),
        dict(name="shoulder_lift_joint", parent=0, type=REVOLUTE, xyz=(0, 0.13585, 0),
             rpy=(0, 1.570796326794897, 0), axis=(0, 1, 0), velocity_limit=3.15),
        dict(name="elbow_joint", parent=1, type=REVOLUTE, xyz=(0, -0.1197, 0.425),
             axis=(0, 1, 0), velocity_limit=3.15),
        dict(name="wrist_1_joint", parent=2, type=REVOLUTE, xyz=(0, 0, 0.39225),
             rpy=(0, 1.570796326794897, 0), axis=(0, 1, 0), velocity_limit=3.2),
        dict(name="wrist_2_joint", parent=3, type=REVOLUTE, xyz=(0, 0.093, 0),
             axis=(0, 0, 1), velocity_limit=3.2),
        dict(name="wrist_3_joint", parent=4, type=REVOLUTE, xyz=(0, 0.09465, 0),
             axis=(0, 1, 0), velocity_limit=3.2),
    ]
    return make_tree(J, name="ur5", dtype=getattr(torch, dtype_str), device=device)


@functools.lru_cache(maxsize=None)
def solo12(dtype_str: str = "float64", device=None) -> KinematicTree:
    """Solo-12 quadruped: free-flyer base + 4 legs x (HAA, HFE, KFE) = 18 dof."""
    J = [dict(name="root_joint", parent=-1, type=FREE_FLYER)]
    legs = [("FL", 0.1946, 0.0875), ("FR", 0.1946, -0.0875),
            ("HL", -0.1946, 0.0875), ("HR", -0.1946, -0.0875)]
    for prefix, x, y in legs:
        base = len(J)
        J.append(dict(name=f"{prefix}_HAA", parent=0, type=REVOLUTE, xyz=(x, y, 0),
                      axis=(1, 0, 0), velocity_limit=12.0))
        J.append(dict(name=f"{prefix}_HFE", parent=base, type=REVOLUTE,
                      xyz=(0, 0.014 if y > 0 else -0.014, 0), axis=(0, 1, 0),
                      velocity_limit=12.0))
        J.append(dict(name=f"{prefix}_KFE", parent=base + 1, type=REVOLUTE,
                      xyz=(0, 0.03745 if y > 0 else -0.03745, -0.16), axis=(0, 1, 0),
                      velocity_limit=12.0))
    return make_tree(J, name="solo12", dtype=getattr(torch, dtype_str), device=device)


@functools.lru_cache(maxsize=None)
def talos(dtype_str: str = "float64", device=None) -> KinematicTree:
    """TALOS humanoid from the embedded URDF asset: free-flyer base + 32
    actuated joints (2x6 legs, 2 torso, 2x7 arms, 2 head, 2 grippers) =
    33 joints / 38 dof, with fixed sole/wrist-FT/camera frames merged by the
    loader.  The whole-body benchmark fixture."""
    return load_urdf(
        os.path.join(_ASSETS, "talos.urdf"),
        dtype=getattr(torch, dtype_str),
        floating_base=True,
        device=device,
    )


@functools.lru_cache(maxsize=None)
def talos_like(dtype_str: str = "float64", device=None) -> KinematicTree:
    """Talos-class humanoid: free-flyer + 2x6 legs + 2-dof torso + 2x7 arms +
    2-dof head = 31 joints / 36 dof, built programmatically with the
    whole-body topology of the TALOS URDF."""
    J = [dict(name="root_joint", parent=-1, type=FREE_FLYER)]

    def leg(side, sign):
        base = len(J)
        J.append(dict(name=f"leg_{side}_1_joint", parent=0, type=REVOLUTE,
                      xyz=(-0.02, sign * 0.085, -0.27105), axis=(0, 0, 1), velocity_limit=3.87))
        J.append(dict(name=f"leg_{side}_2_joint", parent=base, type=REVOLUTE,
                      axis=(1, 0, 0), velocity_limit=5.8))
        J.append(dict(name=f"leg_{side}_3_joint", parent=base + 1, type=REVOLUTE,
                      axis=(0, 1, 0), velocity_limit=5.8))
        J.append(dict(name=f"leg_{side}_4_joint", parent=base + 2, type=REVOLUTE,
                      xyz=(0, 0, -0.38), axis=(0, 1, 0), velocity_limit=7.0))
        J.append(dict(name=f"leg_{side}_5_joint", parent=base + 3, type=REVOLUTE,
                      xyz=(0, 0, -0.325), axis=(0, 1, 0), velocity_limit=5.8))
        J.append(dict(name=f"leg_{side}_6_joint", parent=base + 4, type=REVOLUTE,
                      axis=(1, 0, 0), velocity_limit=4.8))

    leg("left", +1)
    leg("right", -1)
    torso = len(J)
    J.append(dict(name="torso_1_joint", parent=0, type=REVOLUTE, xyz=(0, 0, 0.0722),
                  axis=(0, 0, 1), velocity_limit=5.4))
    J.append(dict(name="torso_2_joint", parent=torso, type=REVOLUTE,
                  axis=(0, 1, 0), velocity_limit=5.4))

    def arm(side, sign):
        base = len(J)
        J.append(dict(name=f"arm_{side}_1_joint", parent=torso + 1, type=REVOLUTE,
                      xyz=(0.00493, sign * 0.1365, 0.04673), axis=(0, 0, 1), velocity_limit=2.7))
        J.append(dict(name=f"arm_{side}_2_joint", parent=base, type=REVOLUTE,
                      xyz=(0.0, sign * 0.1575, 0.0), axis=(1, 0, 0), velocity_limit=3.66))
        J.append(dict(name=f"arm_{side}_3_joint", parent=base + 1, type=REVOLUTE,
                      axis=(0, 1, 0), velocity_limit=4.58))
        J.append(dict(name=f"arm_{side}_4_joint", parent=base + 2, type=REVOLUTE,
                      xyz=(0.02, 0, -0.273), axis=(0, 1, 0), velocity_limit=4.58))
        J.append(dict(name=f"arm_{side}_5_joint", parent=base + 3, type=REVOLUTE,
                      xyz=(-0.02, 0, -0.2643), axis=(0, 0, 1), velocity_limit=1.95))
        J.append(dict(name=f"arm_{side}_6_joint", parent=base + 4, type=REVOLUTE,
                      axis=(1, 0, 0), velocity_limit=1.76))
        J.append(dict(name=f"arm_{side}_7_joint", parent=base + 5, type=REVOLUTE,
                      axis=(0, 1, 0), velocity_limit=1.76))

    arm("left", +1)
    arm("right", -1)
    head = len(J)
    J.append(dict(name="head_1_joint", parent=torso + 1, type=REVOLUTE,
                  xyz=(0.0, 0, 0.316), axis=(0, 1, 0), velocity_limit=1.0))
    J.append(dict(name="head_2_joint", parent=head, type=REVOLUTE,
                  axis=(0, 0, 1), velocity_limit=1.0))
    return make_tree(J, name="talos_like", dtype=getattr(torch, dtype_str), device=device)


@functools.lru_cache(maxsize=None)
def mobile_ur5(dtype_str: str = "float64", device=None) -> KinematicTree:
    """Mobile manipulator: planar base (x, y, yaw — e.g. an omnidirectional
    AGV) carrying a UR5 arm whose wrist joints are CONTINUOUS (unbounded
    revolute, nq=2 cos/sin), plus a 2-dof universal pan/tilt sensor head —
    the bench-class model exercising the broadened joint set (PLANAR,
    REVOLUTE_UNBOUNDED, UNIVERSAL) end-to-end.  nv = 3 + 6 + 2 = 11."""
    J = [dict(name="base_planar_joint", parent=-1, type=PLANAR,
              velocity_limit=1.5)]
    arm = [
        dict(name="shoulder_pan_joint", parent=0, type=REVOLUTE,
             xyz=(0.2, 0, 0.5), axis=(0, 0, 1), velocity_limit=3.15),
        dict(name="shoulder_lift_joint", parent=1, type=REVOLUTE,
             xyz=(0, 0.13585, 0), rpy=(0, 1.570796326794897, 0),
             axis=(0, 1, 0), velocity_limit=3.15),
        dict(name="elbow_joint", parent=2, type=REVOLUTE,
             xyz=(0, -0.1197, 0.425), axis=(0, 1, 0), velocity_limit=3.15),
        dict(name="wrist_1_joint", parent=3, type=REVOLUTE_UNBOUNDED,
             xyz=(0, 0, 0.39225), rpy=(0, 1.570796326794897, 0),
             axis=(0, 1, 0), velocity_limit=3.2),
        dict(name="wrist_2_joint", parent=4, type=REVOLUTE_UNBOUNDED,
             xyz=(0, 0.093, 0), axis=(0, 0, 1), velocity_limit=3.2),
        dict(name="wrist_3_joint", parent=5, type=REVOLUTE_UNBOUNDED,
             xyz=(0, 0.09465, 0), axis=(0, 1, 0), velocity_limit=3.2),
    ]
    J.extend(arm)
    J.append(dict(name="head_universal_joint", parent=0, type=UNIVERSAL,
                  xyz=(-0.15, 0, 0.9), axis=(0, 0, 1), axis2=(0, 1, 0),
                  velocity_limit=2.0))
    return make_tree(J, name="mobile_ur5", dtype=getattr(torch, dtype_str), device=device)


_REGISTRY = {
    "panda": panda,
    "panda_arm": panda_arm,
    "ur5": ur5,
    "solo12": solo12,
    "talos": talos,
    "talos_like": talos_like,
    "mobile_ur5": mobile_ur5,
}


def get(name: str, dtype_str: str = "float64", device=None) -> KinematicTree:
    return _REGISTRY[name](dtype_str, device)
