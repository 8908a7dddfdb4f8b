"""Gradients through the solver: calibrate a task target by descent.

The counterpart of examples/06_differentiable_ik.py on loik_tpu_torch.
`solve_unrolled` makes the WHOLE diff-IK solve differentiable with
autograd (solver/diff.py; the eager body, on whatever device its inputs
are on).  Demo: find the commanded end-effector velocity b_z whose solved
joint motion matches a demonstrated joint velocity profile, the inner
pattern of learning-from-demonstration pipelines that embed an IK layer.
Each Newton step (value, gradient and Hessian of the loss) is one
`utils.jit` function, as the JAX example's `step_fn` is one `jax.jit`: on
the card it is captured once as a CUDA graph and replayed; on the CPU it
runs eagerly.

Run:  python examples/torch/06_differentiable_ik.py [--device cpu] [--quick]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, os.pardir))

import numpy as np
import torch

from loik_tpu_torch import SolverParams, make_problem, solve_unrolled, utils
from loik_tpu_torch.model import robots

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", help="torch device (default: the card)")
parser.add_argument("--quick", action="store_true",
                    help="2 Newton steps instead of 6 (a smoke run on the CPU)")
args = parser.parse_args()
dev = torch.device(args.device)

tree = robots.ur5(device=dev)
A = np.zeros((1, 6, 6))
A[0, 2, 2] = 1.0                                  # constrain EE v_z
problem = make_problem(tree, (tree.njoints - 1,), A=A, b=np.zeros((1, 6)),
                       lb=-10 * np.ones(tree.nv), ub=10 * np.ones(tree.nv))
params = SolverParams()
q = tree.random_configuration((8,), generator=torch.Generator(device=dev).manual_seed(0))


mask = (torch.arange(6, device=dev) == 2).to(tree.dtype)    # b_z in the task row


def with_bz(bz):
    """The problem with b[0, 2] = bz, a 0-d tensor (differentiable), made on
    the device: a graph cannot copy host data to the card."""
    return problem.replace(b=problem.b * (1 - mask) + bz * mask)


# "demonstration": the joint velocities produced by a hidden target
b_true = 0.17
nu_demo = solve_unrolled(tree, params, q, with_bz(torch.tensor(b_true, dtype=tree.dtype,
                                                               device=dev)),
                         num_iters=50).nu.detach()


def loss(bz):
    out = solve_unrolled(tree, params, q, with_bz(bz), num_iters=50)
    return ((out.nu - nu_demo) ** 2).mean()


@utils.jit
def step_fn(bz):
    """(loss, gradient, Hessian) at bz: autograd gives the curvature
    through the solver too."""
    bz.requires_grad_()
    val = loss(bz)
    (g,) = torch.autograd.grad(val, bz, create_graph=True)
    (h,) = torch.autograd.grad(g, bz)
    return val, g, h


bz = torch.tensor(0.5, dtype=tree.dtype, device=dev)
for step in range(2 if args.quick else 6):
    val, g, h = step_fn(bz)
    bz = bz - g / torch.clamp(h, min=1e-8)             # Newton step
    print(f"step {step}: loss {float(val):.3e}  b_z {float(bz):+.5f}")

print(f"\nrecovered b_z = {float(bz):+.5f}  (true {b_true:+.5f})")
assert abs(float(bz) - b_true) < 1e-3
