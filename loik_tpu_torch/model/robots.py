"""Model zoo: the robots of `loik_tpu.model.robots` ported so far.

Panda comes from the package's own copy of the URDF asset (byte-identical
to `loik_tpu/model/assets/panda.urdf`).  The other robots (ur5, solo12,
talos, talos_like, mobile_ur5) need joint types that are not ported yet
(ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from .tree import KinematicTree
from .urdf import load_urdf

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")


def panda(dtype_str: str = "float64", device="cpu") -> KinematicTree:
    """9-dof Franka Panda (7 revolute + 2 prismatic fingers)."""
    return load_urdf(os.path.join(_ASSETS, "panda.urdf"),
                     dtype=getattr(torch, dtype_str), device=device)


def panda_arm(dtype_str: str = "float64", device="cpu") -> KinematicTree:
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


_REGISTRY = {"panda": panda, "panda_arm": panda_arm}


def get(name: str, dtype_str: str = "float64", device="cpu") -> KinematicTree:
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"robot '{name}' is not ported yet (ported: {sorted(_REGISTRY)}; "
            "the rest need the joint types of ROADMAP queue 1 item 7)"
        )
    return _REGISTRY[name](dtype_str, device)
