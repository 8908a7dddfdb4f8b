from . import builders, kinematics, robots
from .tree import (COMPOSITE, FREE_FLYER, HELICAL, MIMIC_PAIR, PLANAR, PRISMATIC,
                   REVOLUTE, REVOLUTE_UNBOUNDED, SPHERICAL, SPHERICAL_ZYX,
                   TRANSLATION, UNIVERSAL, KinematicTree, make_tree)
from .urdf import load_urdf

__all__ = [
    "KinematicTree", "make_tree", "load_urdf", "robots", "builders", "kinematics",
    "REVOLUTE", "PRISMATIC", "FREE_FLYER", "SPHERICAL", "REVOLUTE_UNBOUNDED",
    "TRANSLATION", "PLANAR", "UNIVERSAL", "HELICAL", "SPHERICAL_ZYX",
    "MIMIC_PAIR", "COMPOSITE",
]
