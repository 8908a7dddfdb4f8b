"""1 kHz-style trajectory tracking: the tailored per-tick solve, two ways.

The counterpart of examples/02_tracking_loop.py on loik_tpu_torch.  The
reference's control-loop entry point `Solve(q, c_id, Ai, bi)`
(loik-loid-optimized.hpp:596-695) updates ONE equality constraint per tick
and warm-starts duals from the previous tick.  Here: track a vertical
sinusoid with the Panda end effector, (1) per-tick `solve_tracking` with
q integrated between ticks, the sensor-in-the-loop pattern, and (2)
`track_scan`, which enqueues a whole horizon of ticks without a host
synchronisation between them (on the card: one kernel launch per tick).

Run:  python examples/torch/02_tracking_loop.py [--device cpu] [--quick]
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
parser.add_argument("--quick", action="store_true",
                    help="50 + 20 ticks instead of 300 + 100 (a smoke run on the CPU)")
args = parser.parse_args()
dev = torch.device(args.device)

tree = robots.panda_arm("float32", device=dev)
ee = tree.njoints - 1
params = SolverParams(max_iter=100, tol_abs=1e-4, tol_rel=1e-4, warm_start=True)

solver = DiffIkSolver(tree, params, constraint_links=(ee,))
solver.update_ineq_constraints(-2.0 * np.ones(tree.nv), 2.0 * np.ones(tree.nv))

dt, ticks = 1e-3, 50 if args.quick else 300
q = tree.neutral()[None]
iters = []
for t in range(ticks):
    vz = 0.1 * np.cos(2 * np.pi * 1.0 * t * dt)       # 1 Hz vertical wave
    res = solver.solve_tracking(q, ee, b=[0.0, 0.0, vz, 0.0, 0.0, 0.0])  # warm duals
    q = tree.integrate(q, dt * res.nu)
    iters.append(res.iterations)
iters = torch.cat(iters).cpu().numpy()            # one read after the loop

print(f"ticks={ticks}  iterations/tick: first={iters[0]} "
      f"warm mean={iters[1:].mean():.1f} max={iters[1:].max()}")
print("final q =", q[0].cpu().numpy().round(3))

# ---- a staged horizon: the same targets enqueued back to back ------------
# (a controller that can stage its targets, trajectory replay or an MPC
# rollout, waits for the device once per horizon instead of once per tick)
T = 20 if args.quick else 100
b_seq = np.zeros((T, 6), np.float32)
b_seq[:, 2] = 0.1 * np.cos(2 * np.pi * 1.0 * np.arange(T) * dt)
stream = solver.track_scan(q, b_seq)              # warm state threads tick to tick
print(f"track_scan: {T} ticks in one call, warm iters "
      f"mean={stream.iterations.double().mean():.1f}, "
      f"converged={stream.converged.double().mean():.3f}")
