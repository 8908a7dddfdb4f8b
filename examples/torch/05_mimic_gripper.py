"""Coupled (mimic) joints: load, reduce, solve.

The counterpart of examples/05_mimic_gripper.py on loik_tpu_torch.  Most
gripper / coupled-phalanx URDFs carry a `<mimic>` tag (q_mimic = k *
q_master + o).  Loading one as an independent actuated dof silently solves
the WRONG problem, so the loader rejects mimic URDFs by default; for
SERIAL-adjacent pairs `load_urdf(mimic='reduce')` folds the pair into ONE
1-dof joint whose configuration-dependent motion subspace carries the
coupling exactly.  The kernel takes one constant S per tree, so this solve
runs the eager loop on every device.

Run:  python examples/torch/05_mimic_gripper.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, os.pardir))

import numpy as np
import torch

from loik_tpu_torch import SolverParams, make_problem
from loik_tpu_torch.model import load_urdf
from loik_tpu_torch.solver import solve

FINGER = """
<robot name="coupled_finger">
  <link name="base"/><link name="prox"/><link name="dist"/><link name="tip"/>
  <joint name="knuckle" type="revolute">
    <origin xyz="0 0 0.10"/><parent link="base"/><child link="prox"/>
    <axis xyz="0 1 0"/><limit effort="1" velocity="2.0"/>
  </joint>
  <joint name="distal" type="revolute">
    <origin xyz="0 0 0.05"/><parent link="prox"/><child link="dist"/>
    <axis xyz="0 1 0"/><limit effort="1" velocity="2.0"/>
    <mimic joint="knuckle" multiplier="0.71" offset="0.0"/>
  </joint>
  <joint name="tip_roll" type="revolute">
    <origin xyz="0 0 0.04"/><parent link="dist"/><child link="tip"/>
    <axis xyz="1 0 0"/><limit effort="1" velocity="3.0"/>
  </joint>
</robot>
"""

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", help="torch device (default: the card)")
dev = torch.device(parser.parse_args().device)

# default policy: loud rejection
try:
    load_urdf(FINGER, device=dev)
except ValueError as e:
    print("default load rejected the mimic coupling:")
    print("  ", str(e).split(";")[0])

# reduction: knuckle+distal fold into one coupled dof
tree = load_urdf(FINGER, mimic="reduce", device=dev)
print(f"\nreduced model: joints={tree.joint_names} nv={tree.nv} "
      f"(was 3 independent dofs)")

# drive the fingertip; the coupled pair must move as one dof
A = np.zeros((1, 6, 6))
A[0, 0, 0] = 1.0                      # constrain fingertip v_x
b = np.zeros((1, 6))
b[0, 0] = 0.05
vl = tree.velocity_limit.cpu().numpy()
problem = make_problem(tree, (tree.njoints - 1,), A=A, b=b, lb=-vl, ub=vl)
params = SolverParams(max_iter=100, tol_abs=1e-8, tol_rel=1e-8)
q = tree.random_configuration((4,), generator=torch.Generator(device=dev).manual_seed(0))
res = solve(tree, params, q, problem)
print(f"solved batch of 4: converged={res.converged.tolist()} "
      f"iters={res.iterations.tolist()}")
print("nu (coupled dof + tip):\n", res.nu.cpu().numpy().round(4))
