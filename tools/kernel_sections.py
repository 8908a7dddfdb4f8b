#!/usr/bin/env python3
"""Where one problem's time goes inside the fused kernel, by section.

    python3 tools/kernel_sections.py [--path flagship|solo12|talos] [--B N ...]
                                     [--check-interval K] [--batch-tile N]

Builds the kernel with `-DLOIK_PROFILE`: lane 0 of problem 0 then adds up
the cycles (`clock64`) it spends between the marks in
`csrc/fused_admm.cu` (enum LoikSection) and prints them when the problem
leaves the loop.  Runs the cold float32 loop of one of chip_smoke.py's
configurations at each batch size B (B = 1: the problem alone on the card;
the path's full B: with every SM busy) and prints the kernel's line of
cycles (the total, then one number per section) above a line that names the
sections and problem 0's iteration count.  `--tol 0 --no-certificates`
makes every problem run to `--max-iter` (no convergence, no infeasibility
stop), so that the first iteration's cold instruction cache weighs little.  The profiled build is a
separate library (its flags are part of the library's name); nothing else
uses it.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

SECTIONS = ("H init", "U = H S", "D, D^-1, Ha", "X* Ha X*'", "p init", "BwdPass r, p_a",
            "BwdPass X* p_a", "FwdPass2", "BoxProj + duals", "dual residual",
            "reduce", "flags", "8 empty phases", "8 dependent shared loads",
            "8 dependent parameter loads", "8 dependent divisions", "8 dependent additions",
            "8 phases load-add-store on 8 lanes", "8 phases load-multiply-add-store on 6 lanes")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default="flagship", choices=("flagship", "solo12", "talos"))
    ap.add_argument("--B", type=int, nargs="*", default=[])
    ap.add_argument("--check-interval", type=int, default=1)
    ap.add_argument("--batch-tile", type=int, default=None)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--no-certificates", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_sections: needs a CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke
    import loik_tpu_torch as lt
    import loik_tpu_torch.solver.solve  # noqa: F401  (the module, not the function)
    from loik_tpu_torch.kernels import _build
    from loik_tpu_torch.kernels import fused

    sm = sys.modules["loik_tpu_torch.solver.solve"]
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DLOIK_PROFILE",)
    _build.build()
    dev = torch.device("cuda")
    K = args.check_interval
    for B in (args.B or [1, chip_smoke.PATHS[args.path]["B"]]):
        tree, _, problem, params, q = chip_smoke.config(
            lt, torch, args.path, torch.float32, dev, B, K, args.max_iter)
        params = params.replace(tol_abs=args.tol, tol_rel=args.tol,
                                check_feasibility=not args.no_certificates)
        prob, st = chip_smoke.initial_state(sm, tree, problem, params, q)
        sys.stdout.flush()
        out = fused.fused_solve_loop(tree, params, prob, st, args.batch_tile)
        torch.cuda.synchronize()
        print(f"{args.path} B={B} K={K}: problem 0 ran {int(out.iterations[0])} iterations "
              f"(max {int(out.iterations.max())}); sections in the order of the line above: "
              + ", ".join(SECTIONS), flush=True)


if __name__ == "__main__":
    main()
