#!/usr/bin/env python3
"""Time the flagship's two kernel launches alone, for one checkout.

    python3 tools/flagship_kernel_time.py [--root DIR] [--reps N]

Imports `loik_tpu_torch` from DIR (default: this checkout), builds its
kernel, drives the flagship delta-duals solve once (panda_arm, B=16384,
check_interval 8, tol 1e-6) with the inputs of both launches recorded, then
launches each again N times: the kernel's own device time from
torch.profiler and the wrapper call by CUDA events, medians.  Prints one JSON
line.  To compare two commits on one card, run it in turns inside one job:
parent, change, change, parent (the parent unpacked with `git archive`).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("flagship_kernel_time: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    import loik_tpu_torch as lt
    from loik_tpu_torch.kernels import _build
    from loik_tpu_torch.kernels import fused as fused_mod

    t0 = time.time()
    _build.build()
    build_s = time.time() - t0
    dev = torch.device("cuda")
    tree = lt.robots.panda_arm("float32", device=dev)
    problem = lt.make_problem(
        tree, (6,), b=torch.tensor([[0.0, 0.0, 0.2, 0.0, 0.0, 0.0]]),
        lb=-4.0 * torch.ones(7), ub=4.0 * torch.ones(7))
    params = lt.SolverParams(max_iter=200, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
                             mu_equality_scale_factor=1e5, tail_solve=False,
                             check_interval=8)
    q = tree.random_configuration((16384,), generator=torch.Generator(device=dev).manual_seed(0))

    captured = []
    launch = fused_mod.fused_solve_loop

    def recording(*a, **kw):
        captured.append((a, kw))
        return launch(*a, **kw)

    fused_mod.fused_solve_loop = recording
    res = lt.solve_delta_duals(tree, params, q, problem, fused="require")
    torch.cuda.synchronize()
    fused_mod.fused_solve_loop = launch
    assert len(captured) == 2, len(captured)

    out = {"root": args.root, "build_s": round(build_s, 1),
           "converged": float(res.converged.double().mean()),
           "mean_iterations": float(res.iterations.double().mean())}
    for stage, (a, kw) in enumerate(captured, 1):
        launch(*a, **kw)
        torch.cuda.synchronize()
        alone, call = [], []
        for _ in range(args.reps):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                launch(*a, **kw)
                torch.cuda.synchronize()
            alone.append(sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                             if "fused_admm_kernel" in e.key) / 1e3)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            launch(*a, **kw)
            end.record()
            end.synchronize()
            call.append(start.elapsed_time(end))
        out[f"stage{stage}_kernel_alone_ms"] = statistics.median(alone)
        out[f"stage{stage}_kernel_alone_min_max_ms"] = [min(alone), max(alone)]
        out[f"stage{stage}_fused_solve_loop_ms"] = statistics.median(call)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
