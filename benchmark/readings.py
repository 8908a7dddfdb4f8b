"""The readings the comparison's limits are set from, several seeds in one
process (the benchmark's own runs never run this).

    python3 benchmark/readings.py --workload <cell> --side <side> \
        --seconds <s> --seeds <n> [<n> ...] [--tol-scale <k>] [--seed-key <key>]

``program``: the cell's window as `run.py` drives it, then the comparison's
numbers (the lower readings).  The controls, each in the program's place,
give the upper readings:

- ``bfloat16`` (any cell; the answers are float32): the reference in
  bfloat16, its answers for the inputs a window of ``--seconds`` of the
  program checks;
- any control the cell's request loop offers (`entries/<entry>.py`'s
  `control`), such as ``float32`` for `solve_refined`: the program's own
  float32 path with the float64 step switched off.

``--tol-scale k`` runs the side with its tolerances k times the
configuration's: with ``float32``, answers flagged converged at a looser
tolerance than the configuration states, and without the float64 step
that certifies them.  ``--seed-key`` sets that key of the traffic mix to each seed, so that what
the mix fixes (a tracking fleet's ``fleet_seed``) is drawn per seed too.
One JSON line per seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seed-key", help="a traffic key set to each seed")
    p.add_argument("--tol-scale", type=float, default=1.0,
                   help="tolerances this many times the configuration's")
    p.add_argument("--cpu", action="store_true", help="a tiny batch on the CPU (tests)")
    p.add_argument("--batch", type=int, default=8)
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import torch

    import drive
    import inputs
    import run

    if args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("needs a CUDA device", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cell = inputs.load_cell(args.workload)
    if args.cpu:
        cell.config["batch"] = args.batch
        cell.traffic = {**cell.traffic, "batch": None}
    if args.tol_scale != 1.0:
        tol = {k: args.tol_scale * float(cell.solver[k]) for k in ("tol_abs", "tol_rel")}
        cell.traffic = {**cell.traffic, "solver": {**cell.traffic.get("solver", {}), **tol}}
    if args.seed_key and args.seed_key not in cell.traffic:
        print(f"the traffic has no key {args.seed_key!r}", file=sys.stderr)
        return 2
    prog = drive.Program(cell, device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.seed_key:
            cell.traffic = {**cell.traffic, args.seed_key: seed}
        req = drive.requests(prog, seed)
        if args.side not in ("program", "bfloat16"):
            req.control(args.side)
        drive.run_calls(req, 0, count=req.settle)
        win = drive.run_calls(req, req.settle, seconds=args.seconds)
        numbers = run.check(torch, req, win.kept,
                            "bfloat16" if args.side == "bfloat16" else "float64")
        print(json.dumps({"workload": args.workload, "side": args.side, "seed": seed,
                          "calls": win.calls, "seconds": time.perf_counter() - t0,
                          "tol_scale": args.tol_scale,
                          **({args.seed_key: seed} if args.seed_key else {}),
                          **numbers}), flush=True)
        del req
    return 0


if __name__ == "__main__":
    sys.exit(main())
