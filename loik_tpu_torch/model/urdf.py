"""Minimal URDF loader producing a KinematicTree.

Port of `loik_tpu.model.urdf.load_urdf`, with the same `xml.etree` parsing
and the same traversal, so a URDF yields the same joint order and placements
in both packages.  Supports revolute / continuous / prismatic / floating /
planar / fixed joints plus the spherical / translation / universal
(<axis2>) / helical (<pitch value=>) / spherical_zyx extensions and the
<mimic> policy (reject by default, mimic='reduce' folding).  Fixed joints
are merged into the downstream joint's placement (their frames contribute
no dofs), matching how pinocchio composes `jointPlacements`.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np
import torch

from .. import spatial
from .tree import (FREE_FLYER, HELICAL, MIMIC_PAIR, PLANAR, PRISMATIC,
                   REVOLUTE, REVOLUTE_UNBOUNDED, SPHERICAL, SPHERICAL_ZYX,
                   TRANSLATION, UNIVERSAL, KinematicTree, make_tree)

_TYPE_MAP = {
    "revolute": REVOLUTE,
    # Pinocchio maps URDF `continuous` to JointModelRevoluteUnbounded
    # (nq=2 cos/sin); same convention here
    "continuous": REVOLUTE_UNBOUNDED,
    "prismatic": PRISMATIC,
    "floating": FREE_FLYER,
    "planar": PLANAR,
    "spherical": SPHERICAL,      # not standard URDF; accepted as an extension
    "translation": TRANSLATION,  # extension (pinocchio JointModelTranslation)
    "universal": UNIVERSAL,      # extension; second axis via <axis2 xyz=.../>
    "helical": HELICAL,          # extension; screw pitch via <pitch value=/>
    "spherical_zyx": SPHERICAL_ZYX,  # extension (Euler Z-Y-X ball joint)
    "mimic_pair": MIMIC_PAIR,    # internal: produced by mimic='reduce'
}


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
              dtype: torch.dtype = torch.float64, floating_base: bool = False,
              mimic: str = "raise", device=None) -> KinematicTree:
    """Parse a URDF string or file path into a KinematicTree.

    floating_base=True prepends a free-flyer joint at the root link, the way
    pinocchio's `buildModel(path, JointModelFreeFlyer())` does for humanoids
    and quadrupeds.  ``device=None`` builds on the CUDA device.

    mimic: what to do with `<mimic>` joint couplings (q = k q_master + o):
      - "raise" (default): reject with a clear error — loading a mimic joint
        as an independent dof silently solves the wrong problem.
      - "reduce": fold each SERIAL-ADJACENT pair (the mimic joint hangs
        directly off its master's child link, no siblings or intervening
        fixed frames) into ONE 1-dof `MIMIC_PAIR` joint whose
        configuration-dependent subspace carries the coupling exactly
        (coupled finger phalanges etc.).  Non-adjacent mimics still raise:
        cross-branch couplings cannot be expressed by the solver's
        per-joint variables.
    """
    if "<robot" not in source:
        with open(source) as f:
            source = f.read()
    root = ET.fromstring(source)
    robot_name = name or root.get("name", "robot")

    links = {l.get("name") for l in root.findall("link")}
    joints = []
    child_of: Dict[str, dict] = {}
    for j in root.findall("joint"):
        jd = {
            "name": j.get("name"),
            "type": j.get("type"),
            "parent_link": j.find("parent").get("link"),
            "child_link": j.find("child").get("link"),
        }
        mim = j.find("mimic")
        if mim is not None:
            # <mimic joint=... multiplier=... offset=...> couples this
            # joint's dof to its master's (q = k q_master + o); handled
            # below per the `mimic` policy
            jd["mimic"] = {
                "joint": mim.get("joint"),
                "multiplier": float(mim.get("multiplier") or 1.0),
                "offset": float(mim.get("offset") or 0.0),
            }
        R, p = _parse_origin(j)
        jd["R"], jd["p"] = R, p
        ax = j.find("axis")
        jd["axis"] = (
            np.fromstring(ax.get("xyz"), sep=" ") if ax is not None else np.array([0.0, 0.0, 1.0])
        )
        ax2 = j.find("axis2")  # universal-joint extension
        if ax2 is not None and ax2.get("xyz"):
            jd["axis2"] = np.fromstring(ax2.get("xyz"), sep=" ")
        pt = j.find("pitch")  # helical extension: translation (m) per radian
        if pt is not None and pt.get("value"):
            jd["pitch"] = float(pt.get("value"))
        lim = j.find("limit")
        jd["velocity_limit"] = (
            float(lim.get("velocity")) if lim is not None and lim.get("velocity") else np.inf
        )
        joints.append(jd)
        child_of[jd["child_link"]] = jd

    # ---- mimic policy ----------------------------------------------------
    mimic_jds = [jd for jd in joints if "mimic" in jd]
    if mimic_jds and mimic != "reduce":
        jd = mimic_jds[0]
        raise ValueError(
            f"joint '{jd['name']}' mimics '{jd['mimic']['joint']}': <mimic> "
            "couplings are not supported as independent dofs (the per-joint "
            "solver variables cannot express nu_mimic = k * nu_master); "
            "pass mimic='reduce' to fold serial-adjacent pairs into one "
            "coupled joint, or remove the mimic joint from the URDF"
        )
    for jd in mimic_jds:
        by_name = {j2["name"]: j2 for j2 in joints}
        master = by_name.get(jd["mimic"]["joint"])
        if master is None:
            raise ValueError(
                f"joint '{jd['name']}' mimics unknown joint "
                f"'{jd['mimic']['joint']}'"
            )
        def _subtree_has_moving(j0):
            # walk the link->joint graph below j0: any non-fixed joint means
            # j0's branch carries dofs and blocks the serial reduction
            stack = [j0]
            while stack:
                j2 = stack.pop()
                if j2["type"] != "fixed":
                    return True
                stack.extend(j3 for j3 in joints
                             if j3["parent_link"] == j2["child_link"])
            return False

        # siblings on the master's child link: purely cosmetic fixed frames
        # (visual/collision/tool frames, common on real gripper URDFs) do
        # not affect the coupling and are dropped by the traversal anyway —
        # only dof-carrying branches block the reduction
        blocking = [
            j2 for j2 in joints
            if j2["parent_link"] == master["child_link"] and j2 is not jd
            and _subtree_has_moving(j2)
        ]
        if jd["parent_link"] != master["child_link"] or blocking:
            names = ", ".join(f"'{j2['name']}'" for j2 in blocking)
            raise ValueError(
                f"mimic joint '{jd['name']}' is not serial-adjacent to its "
                f"master '{master['name']}' (it must be the only DOF-"
                "carrying joint on the master's child link, with no "
                "intervening fixed frames between master and mimic"
                + (f"; blocking branch(es): {names}" if names else "")
                + "): cross-branch couplings cannot be expressed by the "
                "solver's per-joint variables. Leaf fixed frames "
                "(visual/tool) on the master's child link are allowed and "
                "dropped."
            )
        if master["type"] not in ("revolute", "prismatic") or jd[
                "type"] not in ("revolute", "prismatic"):
            raise ValueError(
                f"mimic reduction supports revolute/prismatic pairs; got "
                f"{master['type']} -> {jd['type']}"
            )
        if "mimic" in master:
            raise ValueError(
                f"chained mimic ('{jd['name']}' mimics mimic-joint "
                f"'{master['name']}') is not supported"
            )
        k = jd["mimic"]["multiplier"]
        # merge: the master becomes a 1-dof MIMIC_PAIR joint whose FK/S
        # carry the coupling exactly (tree.MIMIC_PAIR); the mimic joint's
        # own origin becomes the pair's inner placement
        master["_pair"] = (_TYPE_MAP[master["type"]], _TYPE_MAP[jd["type"]],
                           k, jd["mimic"]["offset"])
        master["_R2"], master["_p2"] = jd["R"], jd["p"]
        master["axis2"] = jd["axis"]
        master["type"] = "mimic_pair"
        master["child_link"] = jd["child_link"]
        vl_m = master.get("velocity_limit", np.inf)
        vl_j = jd.get("velocity_limit", np.inf)
        master["velocity_limit"] = (
            min(vl_m, vl_j / abs(k)) if k else vl_m
        )
        joints.remove(jd)

    # find the root link (a link that is never a child)
    child_links = set(child_of)
    roots = [l for l in links if l not in child_links]
    if len(roots) != 1:
        raise ValueError(f"expected a single root link, got {roots}")
    root_link = roots[0]

    children_of_link: Dict[str, List[dict]] = {}
    for jd in joints:
        children_of_link.setdefault(jd["parent_link"], []).append(jd)

    out_joints = []
    # (link, parent_moving_joint_idx, accumulated fixed transform R, p)
    stack = [(root_link, -1, np.eye(3), np.zeros(3))]
    if floating_base:
        out_joints.append(
            dict(name="root_joint", parent=-1, type=FREE_FLYER, xyz=(0, 0, 0), rpy=(0, 0, 0))
        )
        stack = [(root_link, 0, np.eye(3), np.zeros(3))]

    while stack:
        link, parent_idx, accR, accp = stack.pop()
        for jd in sorted(children_of_link.get(link, []), key=lambda d: d["name"]):
            R = accR @ jd["R"]
            p = accp + accR @ jd["p"]
            if jd["type"] == "fixed":
                stack.append((jd["child_link"], parent_idx, R, p))
                continue
            t = _TYPE_MAP.get(jd["type"])
            if t is None:
                raise ValueError(f"unsupported joint type {jd['type']}")
            idx = len(out_joints)
            entry = dict(name=jd["name"], parent=parent_idx, type=t)
            entry["_R"], entry["_p"] = R, p
            entry["axis"] = jd["axis"]
            if "axis2" in jd:
                entry["axis2"] = jd["axis2"]
            if "pitch" in jd:
                entry["pitch"] = jd["pitch"]
            if "_pair" in jd:
                entry["mimic"] = jd["_pair"]
                entry["_R2"], entry["_p2"] = jd["_R2"], jd["_p2"]
            entry["velocity_limit"] = jd["velocity_limit"]
            out_joints.append(entry)
            stack.append((jd["child_link"], idx, np.eye(3), np.zeros(3)))

    # make_tree expects rpy; we already have rotation matrices, so bypass via
    # a direct build: convert entries to the make_tree schema with matrices.
    tree = make_tree(
        [
            dict(
                name=e["name"], parent=e["parent"], type=e["type"], axis=e.get("axis", (0, 0, 1)),
                axis2=e.get("axis2", (0, 1, 0)),
                velocity_limit=e.get("velocity_limit", np.inf),
                pitch=e.get("pitch", 0.0),
                **({"mimic": e["mimic"], "R2": e["_R2"], "xyz2": e["_p2"]}
                   if "mimic" in e else {}),
            )
            for e in out_joints
        ],
        name=robot_name,
        dtype=dtype,
        device=device,
    )
    # overwrite placements with the exact accumulated matrices
    pR = np.stack([e.get("_R", np.eye(3)) for e in out_joints])
    pp = np.stack([e.get("_p", np.zeros(3)) for e in out_joints])
    return dataclasses.replace(
        tree,
        placement_R=torch.as_tensor(pR, dtype=dtype, device=tree.device),
        placement_p=torch.as_tensor(pp, dtype=dtype, device=tree.device),
    )
