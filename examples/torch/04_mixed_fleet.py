"""Heterogeneous robot fleet in ONE padded batch.

The counterpart of examples/04_mixed_fleet.py on loik_tpu_torch.  A UR5
cell and a Panda cell each stream differential-IK problems; the padded
super-batch path (parallel/mixed.py) embeds both serial chains into one
common padded chain and solves the combined batch at once (on the card,
the kernel reads each problem's own motion subspaces).

Run:  python examples/torch/04_mixed_fleet.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, os.pardir))

import numpy as np
import torch

from loik_tpu_torch.model import robots
from loik_tpu_torch.params import SolverParams
from loik_tpu_torch.parallel import prepare_mixed_padded
from loik_tpu_torch.problem import make_problem


def group(robot, seed, B, vz, dev):
    tree = robots.get(robot, "float32", device=dev)
    b = np.zeros((1, 6))
    b[0, 2] = vz
    vl = np.minimum(tree.velocity_limit.cpu().numpy(), 4.0)
    problem = make_problem(tree, (tree.njoints - 1,), b=b, lb=-vl, ub=vl)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tree, tree.random_configuration((B,), generator=gen), problem


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: the card)")
    dev = torch.device(parser.parse_args().device)
    params = SolverParams(max_iter=150, tol_abs=1e-4, tol_rel=1e-4,
                          mu=0.1, mu_equality_scale_factor=1e5)
    groups = [group("ur5", 0, 256, 0.15, dev), group("panda_arm", 1, 256, 0.10, dev)]
    # assemble the super-batch once; a control loop then pays only the
    # per-tick q packing + solve (solve_mixed_padded wraps both for one-offs)
    fleet = prepare_mixed_padded([(t, 256, p) for t, _, p in groups])
    for tick in range(2):
        results = fleet.solve(params, [q for _, q, _ in groups])
    for (tree, _, _), res in zip(groups, results):
        conv = res.converged.cpu().numpy()
        it = res.iterations.cpu().numpy()
        print(f"{tree.name:10s} B={conv.size}  converged={conv.mean():.2f}  "
              f"iters mean={it.mean():.1f}  nu shape={tuple(res.nu.shape)}")


if __name__ == "__main__":
    main()
