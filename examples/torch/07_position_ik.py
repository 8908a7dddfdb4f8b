"""Position-level IK: drive a batch of arms to target SE(3) poses.

The counterpart of examples/07_position_ik.py on loik_tpu_torch.  The
reference solver is differential: it answers "what joint VELOCITY realizes
this task right now".  Reaching a target POSE is the closed loop its
tailored per-tick overload exists for (loik-loid-optimized.hpp:596-695):
measure the pose error, command a velocity toward the target, solve,
integrate.  `solve_clik` runs that loop for a batch of poses; saturation
and the secondary tracking objective are handled by the constrained QP
itself.  In float64 for the ~1e-7 pose-error floor: on the card each tick
is one launch of the kernel's float64 instantiation (fused=True), on the
CPU the eager loop.

Run:  python examples/torch/07_position_ik.py [--device cpu] [--quick]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, os.pardir))

import numpy as np
import torch

from loik_tpu_torch import SolverParams, make_problem, solve_clik
from loik_tpu_torch.model import robots

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", help="torch device (default: the card)")
parser.add_argument("--quick", action="store_true",
                    help="a sixteenth of the ticks (a smoke run on the CPU)")
args = parser.parse_args()
dev = torch.device(args.device)
scale = 16 if args.quick else 1

tree = robots.panda_arm(device=dev)
ee = tree.njoints - 1
params = SolverParams(max_iter=100, tol_abs=1e-6, tol_rel=1e-6)

# --- batch of reachable target poses (FK of perturbed configurations) ----
B = 16
q0 = tree.neutral().expand(B, tree.nq).contiguous()
rng = np.random.default_rng(0)
dq = torch.as_tensor(0.35 * rng.normal(size=(B, tree.nv)), device=dev)
_, _, oR, op = tree.fwd_kinematics(tree.integrate(q0, dq))
target_R, target_p = oR[:, ee], op[:, ee]

res = solve_clik(tree, params, q0, target_R, target_p, link=ee,
                 dt=0.1, steps=80 // scale, gain=2.0, fused=True)
print(f"reached {int(res.reached.sum())}/{B} poses")
print(f"pose error: pos max {float(res.pos_err.max()):.2e} m, "
      f"rot max {float(res.rot_err.max()):.2e} rad")
hist = res.err_history.cpu().numpy()
print("error contraction (batch max |err|_inf per tick):",
      " -> ".join(f"{hist[t].max():.1e}" for t in sorted({0, 10 // scale, 20 // scale,
                                                            40 // scale, 80 // scale - 1})))

# --- tight velocity bounds: cap the commanded twist so every tick's QP ---
# stays feasible while the box constraint shapes the motion
ub = 0.5 * np.ones(tree.nv)
problem = make_problem(tree, (ee,), lb=-ub, ub=ub)
res_b = solve_clik(tree, params, q0, target_R, target_p, link=ee,
                   dt=0.1, steps=120 // scale, gain=4.0, max_task_velocity=0.3,
                   problem=problem, fused=True)
print(f"\nwith |nu| <= 0.5 rad/s bounds: reached {int(res_b.reached.sum())}"
      f"/{B}; final-tick joint speed "
      f"{float(res_b.nu.abs().max()):.1e} rad/s (settled)")

# --- an unreachable pose fails loudly, not silently -----------------------
far = solve_clik(tree, params, q0[:1], torch.eye(3, dtype=q0.dtype, device=dev),
                 torch.tensor([3.0, 0.0, 0.5], dtype=q0.dtype, device=dev), link=ee,
                 steps=40 // scale, fused=True)
print(f"\nunreachable pose: reached={bool(far.reached[0])}, stalls at "
      f"closest approach (pos err {float(far.pos_err[0]):.2f} m)")
