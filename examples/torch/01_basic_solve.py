"""Basic constrained differential IK: the reference fixture problem.

The counterpart of examples/01_basic_solve.py on loik_tpu_torch: a
manipulator, identity tracking weights, one 6-D equality task at the end
effector (A = I6, b = commanded spatial velocity), joint-velocity box
bounds, solved for a BATCH of configurations at once.

Run:  python examples/torch/01_basic_solve.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, os.pardir))

import numpy as np
import torch

from loik_tpu_torch import DiffIkSolver, SolverParams
from loik_tpu_torch.model import robots

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", help="torch device (default: the card)")
dev = torch.device(parser.parse_args().device)

tree = robots.panda_arm("float32", device=dev)   # 7-dof Franka Panda arm
params = SolverParams(max_iter=200, tol_abs=1e-4, tol_rel=1e-4)

ee = tree.njoints - 1                             # constrain the last joint/link
solver = DiffIkSolver(tree, params, constraint_links=(ee,))
solver.update_ineq_constraints(-4.0 * np.ones(tree.nv), 4.0 * np.ones(tree.nv))
solver.update_eq_constraint(ee, b=[0.0, 0.0, 0.2, 0.0, 0.0, 0.0])  # EE up at 0.2 m/s

B = 1024
gen = torch.Generator(device=dev).manual_seed(0)
qs = tree.random_configuration((B,), generator=gen)
res = solver.solve(qs)

conv = res.converged.cpu().numpy()
iters = res.iterations.cpu().numpy()
print(f"robot={tree.name} batch={B} device={dev}")
print(f"converged: {conv.sum()}/{B} "
      f"(infeasible certified: {int(res.primal_infeasible.sum())})")
print(f"iterations: mean={iters.mean():.1f} max={int(iters.max())}")
print(f"max primal residual (converged): "
      f"{res.primal_residual.cpu().numpy()[conv].max():.2e}")
print("nu[0] =", res.nu[0].cpu().numpy().round(4))
