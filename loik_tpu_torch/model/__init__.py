from . import robots
from .tree import PRISMATIC, REVOLUTE, KinematicTree
from .urdf import load_urdf

__all__ = ["KinematicTree", "load_urdf", "robots", "REVOLUTE", "PRISMATIC"]
