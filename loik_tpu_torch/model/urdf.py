"""Minimal URDF loader producing a KinematicTree.

Port of `loik_tpu.model.urdf.load_urdf` for revolute, prismatic and fixed
joints, with the same `xml.etree` parsing and the same traversal, so a URDF
yields the same joint order and placements in both packages.  Fixed joints
are merged into the downstream joint's placement (their frames contribute
no dofs), matching how pinocchio composes `jointPlacements`.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np
import torch

from .. import spatial
from .tree import PRISMATIC, REVOLUTE, KinematicTree

_TYPE_MAP = {"revolute": REVOLUTE, "prismatic": PRISMATIC}


def _parse_origin(el):
    xyz = np.zeros(3)
    rpy = np.zeros(3)
    o = el.find("origin")
    if o is not None:
        if o.get("xyz"):
            xyz = np.fromstring(o.get("xyz"), sep=" ")
        if o.get("rpy"):
            rpy = np.fromstring(o.get("rpy"), sep=" ")
    R = spatial.rpy_to_rotmat(torch.as_tensor(rpy, dtype=torch.float64)).numpy()
    return R, xyz


def load_urdf(source: str, name: str | None = None,
              dtype: torch.dtype = torch.float64, device="cpu") -> KinematicTree:
    """Parse a URDF string or file path into a KinematicTree.

    Joint types other than revolute, prismatic and fixed raise
    NotImplementedError (ROADMAP queue 1 item 7); `<mimic>` couplings raise
    ValueError, as `loik_tpu`'s default policy does."""
    if "<robot" not in source:
        with open(source) as f:
            source = f.read()
    root = ET.fromstring(source)
    robot_name = name or root.get("name", "robot")

    links = {l.get("name") for l in root.findall("link")}
    joints = []
    child_links = set()
    for j in root.findall("joint"):
        jd = {
            "name": j.get("name"),
            "type": j.get("type"),
            "parent_link": j.find("parent").get("link"),
            "child_link": j.find("child").get("link"),
        }
        if jd["type"] != "fixed" and jd["type"] not in _TYPE_MAP:
            raise NotImplementedError(
                f"joint '{jd['name']}' has URDF type '{jd['type']}': only "
                "revolute, prismatic and fixed joints are ported so far "
                "(ROADMAP queue 1 item 7)"
            )
        mim = j.find("mimic")
        if mim is not None:
            raise ValueError(
                f"joint '{jd['name']}' mimics '{mim.get('joint')}': <mimic> "
                "couplings are not supported as independent dofs"
            )
        jd["R"], jd["p"] = _parse_origin(j)
        ax = j.find("axis")
        jd["axis"] = (np.fromstring(ax.get("xyz"), sep=" ") if ax is not None
                      else np.array([0.0, 0.0, 1.0]))
        lim = j.find("limit")
        jd["velocity_limit"] = (
            float(lim.get("velocity"))
            if lim is not None and lim.get("velocity") else np.inf
        )
        joints.append(jd)
        child_links.add(jd["child_link"])

    roots = [l for l in links if l not in child_links]
    if len(roots) != 1:
        raise ValueError(f"expected a single root link, got {roots}")

    children_of_link: Dict[str, List[dict]] = {}
    for jd in joints:
        children_of_link.setdefault(jd["parent_link"], []).append(jd)

    out = []
    # (link, parent_moving_joint_idx, accumulated fixed transform R, p)
    stack = [(roots[0], -1, np.eye(3), np.zeros(3))]
    while stack:
        link, parent_idx, accR, accp = stack.pop()
        for jd in sorted(children_of_link.get(link, []), key=lambda d: d["name"]):
            R = accR @ jd["R"]
            p = accp + accR @ jd["p"]
            if jd["type"] == "fixed":
                stack.append((jd["child_link"], parent_idx, R, p))
                continue
            out.append(dict(jd, parent=parent_idx, R=R, p=p))
            stack.append((jd["child_link"], len(out) - 1, np.eye(3), np.zeros(3)))

    axes = []
    for e in out:
        n = np.linalg.norm(e["axis"])
        axes.append(e["axis"] / n if n > 0 else e["axis"])

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    return KinematicTree(
        placement_R=tensor(np.stack([e["R"] for e in out])),
        placement_p=tensor(np.stack([e["p"] for e in out])),
        axis=tensor(np.stack(axes)),
        velocity_limit=tensor([e["velocity_limit"] for e in out]),
        parents=tuple(e["parent"] for e in out),
        jtypes=tuple(_TYPE_MAP[e["type"]] for e in out),
        idx_v=tuple(range(len(out))),
        idx_q=tuple(range(len(out))),
        joint_names=tuple(e["name"] for e in out),
        name=robot_name,
    )
