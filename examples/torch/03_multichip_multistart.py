"""Scale-out: sharded batch solve + multi-start global IK.

The counterpart of examples/03_multichip_multistart.py on loik_tpu_torch.
The problem batch is split over a 1-D mesh of the visible cards
(`make_mesh()`); each card solves its block and the results are gathered
on the first.  With --device cpu the mesh is eight repetitions of the CPU
device, the analog of loik_tpu's virtual host devices.

Run:  python examples/torch/03_multichip_multistart.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, os.pardir))

import numpy as np
import torch

from loik_tpu_torch import SolverParams, make_problem
from loik_tpu_torch.model import robots
from loik_tpu_torch.parallel import (convergence_metrics, make_mesh, solve_multistart,
                                     solve_sharded)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", help="torch device (default: the card)")
dev = torch.device(parser.parse_args().device)

mesh = make_mesh() if dev.type == "cuda" else make_mesh([dev] * 8)
n = mesh.size
print(f"mesh: {n} x {mesh.devices[0]}")

tree = robots.panda_arm("float32", device=mesh.devices[0])
params = SolverParams(max_iter=100, tol_abs=1e-4, tol_rel=1e-4)
b = np.zeros((1, 6))
b[0, 2] = 0.2
problem = make_problem(tree, (6,), b=b, lb=-4 * np.ones(7), ub=4 * np.ones(7))

# ---- sharded batch solve -------------------------------------------------
B = 128 * n
gen = torch.Generator(device=tree.device).manual_seed(0)
qs = tree.random_configuration((B,), generator=gen)
res = solve_sharded(tree, params, qs, problem, mesh)
m = convergence_metrics(res)                      # reduced on the first device
print(f"sharded solve: B={B} over {n} devices; "
      f"converged={int(m['num_converged'])} "
      f"mean_iters={float(m['mean_iterations']):.1f} "
      f"result on {res.nu.device}")

# ---- multi-start global IK ----------------------------------------------
gen = torch.Generator(device=tree.device).manual_seed(1)
ms = solve_multistart(tree, params, problem, gen, num_seeds=B, mesh=mesh, k=4)
assert ms.found, "no seed converged: resample"
print(f"multistart: best task error {float(ms.error[0]):.2e} "
      f"({int(ms.num_converged)}/{B} seeds converged); "
      f"q* = {ms.q[0].cpu().numpy().round(3)}")
