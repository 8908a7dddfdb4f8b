"""Programmatic tree builders: serial chains and random trees for testing.

Port of `loik_tpu.model.builders`.  `random_tree` plays the role of
`pinocchio::buildModels::humanoidRandom`: arbitrary topology and mixed joint
types for fuzzing the solver.  It draws from a numpy generator in the
reference's order, so one seed gives the same tree in both packages.
``device=None`` builds on the CUDA device.
"""

from __future__ import annotations

import numpy as np

from .tree import (FREE_FLYER, MIMIC_PAIR, PRISMATIC, REVOLUTE, SPHERICAL,
                   KinematicTree, make_tree)


def serial_chain(n: int, jtype: int = REVOLUTE, link_length: float = 0.3,
                 axis=(0, 0, 1), name: str = "chain", device=None) -> KinematicTree:
    joints = []
    for i in range(n):
        joints.append(
            dict(
                name=f"j{i}",
                parent=i - 1,
                type=jtype,
                xyz=(link_length, 0.0, 0.0) if i > 0 else (0.0, 0.0, 0.0),
                axis=axis,
                velocity_limit=4.0,
            )
        )
    return make_tree(joints, name=name, device=device)


def random_tree(rng: np.random.Generator, n_joints: int,
                floating_base: bool = False,
                allow_prismatic: bool = True,
                allow_spherical: bool = False,
                force_spherical: bool = False,
                force_types=(),
                name: str = "random", device=None) -> KinematicTree:
    """Random topology (each joint's parent drawn from earlier joints),
    random placements and axes, mixed revolute/prismatic(/spherical) joints.

    `force_spherical` guarantees at least one spherical joint (the last
    non-base joint) regardless of the draws; `force_types` likewise pins the
    LAST len(force_types) joints to the given type codes (e.g. the broadened
    set: PLANAR / TRANSLATION / REVOLUTE_UNBOUNDED / UNIVERSAL) — fuzz tests
    that target a specific D-block or subspace path must not depend on RNG
    luck."""
    joints = []
    start = 0
    if floating_base:
        joints.append(dict(name="root", parent=-1, type=FREE_FLYER))
        start = 1
    force_types = tuple(force_types)
    for i in range(start, n_joints):
        parent = -1 if i == 0 else int(rng.integers(0, i))
        t = REVOLUTE
        u = rng.random()
        if allow_prismatic and u < 0.25:
            t = PRISMATIC
        elif allow_spherical and u > 0.75:
            t = SPHERICAL
        if force_spherical and i == n_joints - 1:
            t = SPHERICAL
        if force_types and i >= n_joints - len(force_types):
            t = force_types[i - (n_joints - len(force_types))]
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        axis2 = rng.normal(size=3)
        axis2 /= np.linalg.norm(axis2)
        j = dict(
            name=f"j{i}",
            parent=parent,
            type=t,
            xyz=tuple(rng.uniform(-0.4, 0.4, size=3)),
            rpy=tuple(rng.uniform(-np.pi, np.pi, size=3)),
            axis=tuple(axis),
            axis2=tuple(axis2),
            pitch=float(rng.uniform(0.02, 0.3)),  # used by HELICAL only
            velocity_limit=5.0,
        )
        if t == MIMIC_PAIR:
            # random serial rev/prism coupling with a random inner placement
            j["mimic"] = (
                int(rng.choice([REVOLUTE, PRISMATIC])),
                int(rng.choice([REVOLUTE, PRISMATIC])),
                float(rng.uniform(0.4, 1.8) * rng.choice([-1.0, 1.0])),
                float(rng.uniform(-0.3, 0.3)),
            )
            j["xyz2"] = tuple(rng.uniform(-0.2, 0.2, size=3))
            j["rpy2"] = tuple(rng.uniform(-np.pi, np.pi, size=3))
        joints.append(j)
    return make_tree(joints, name=name, device=device)
