#!/usr/bin/env python3
"""Time the fused kernel's launches alone on a main path, for one checkout.

    python3 tools/flagship_kernel_time.py [--root DIR] [--path flagship]
                                          [--reps N] [--batch-tile N ...]

Imports `loik_tpu_torch` and `chip_smoke` from DIR (default: this checkout),
builds its kernel, drives one main path of chip_smoke.py once with the
inputs of every launch recorded, then launches each again N times: the
kernel's own device time from torch.profiler and the wrapper call by CUDA
events, medians.  Paths:
  flagship, solo12, talos: the delta-duals solve (two launches, stage 1 and
      stage 2) at chip_smoke's batch and check_interval;
  tracking: one `track_scan` stream of T=100 warm ticks on panda_arm at
      B=16384, tol 1e-4, after five settling ticks (100 launches; reported
      per tick, the sum over the stream / T).
`--batch-tile` replays the launches at the given `batch_tile` values instead
of the checkout's default (one result per value); `--check-interval`
overrides the path's; `--prefix N ...` launches the first recorded launch
again on its first N problems and reports the time beside the longest
iteration count (N = 1: the time one problem needs, alone on the card).
Prints one JSON line.  To
compare two commits on one card, run it in turns inside one job: parent,
change, change, parent (the parent unpacked with `git archive`).  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def kernel_ms(torch, fn):
    """Device time of the fused kernel in one call of fn (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
               if "fused_admm_kernel" in e.key) / 1e3


def event_ms(torch, fn):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--path", default="flagship",
                    choices=("flagship", "solo12", "talos", "tracking"))
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--batch-tile", type=int, nargs="*", default=[])
    ap.add_argument("--check-interval", type=int, default=None)
    ap.add_argument("--prefix", type=int, nargs="*", default=[])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flagship_kernel_time: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke
    import loik_tpu_torch as lt
    from loik_tpu_torch.kernels import _build
    from loik_tpu_torch.kernels import fused as fused_mod

    t0 = time.time()
    _build.build()
    build_s = time.time() - t0
    dev = torch.device("cuda")
    tracking = args.path == "tracking"
    name = "flagship" if tracking else args.path
    B = 16384 if tracking else chip_smoke.PATHS[name]["B"]
    K = 1 if tracking else chip_smoke.PATHS[name]["K"]
    if args.check_interval:
        K = args.check_interval
    tree, links, problem, params, q = chip_smoke.config(
        lt, torch, name, torch.float32, dev, B, K)
    if tracking:
        T = 100
        params = params.replace(tol_abs=1e-4, tol_rel=1e-4, warm_start=True)
        b_seq = torch.zeros((T, 6), dtype=torch.float32, device=dev)
        b_seq[:, 2] = 0.2 * torch.cos(2 * torch.pi * torch.arange(T, device=dev) / T)
    solver = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")
    if tracking:
        for _ in range(5):
            solver.solve_tracking(q, links[0], b=problem.b[0])

    captured = []
    launch = fused_mod.fused_solve_loop

    def recording(*a, **kw):
        captured.append((a, kw))
        return launch(*a, **kw)

    fused_mod.fused_solve_loop = recording
    res = solver.track_scan(q, b_seq) if tracking else solver.solve_refined(q, method="delta")
    torch.cuda.synchronize()
    fused_mod.fused_solve_loop = launch
    assert len(captured) == (T if tracking else 2), len(captured)

    out = {"root": args.root, "path": args.path, "B": B, "build_s": round(build_s, 1),
           "converged": float(res.converged.double().mean()),
           "mean_iterations": float(res.iterations.double().mean())}

    def replay(call, tile):
        a, kw = call
        if tile is None:
            return lambda: launch(*a, **kw)
        return lambda: launch(*a[:4], tile)

    for tile in (args.batch_tile or [None]):
        key = "" if tile is None else f"tile{tile}_"
        if tracking:
            fns = [replay(c, tile) for c in captured]

            def stream():
                for fn in fns:
                    fn()

            stream()
            torch.cuda.synchronize()
            alone = [kernel_ms(torch, stream) / T for _ in range(max(1, args.reps // 3))]
            out[f"{key}kernel_alone_ms_per_tick"] = statistics.median(alone)
            out[f"{key}kernel_alone_min_max_ms_per_tick"] = [min(alone), max(alone)]
            continue
        for stage, call in enumerate(captured, 1):
            fn = replay(call, tile)
            fn()
            torch.cuda.synchronize()
            alone = [kernel_ms(torch, fn) for _ in range(args.reps)]
            calls = [event_ms(torch, fn) for _ in range(args.reps)]
            out[f"{key}stage{stage}_kernel_alone_ms"] = statistics.median(alone)
            out[f"{key}stage{stage}_kernel_alone_min_max_ms"] = [min(alone), max(alone)]
            out[f"{key}stage{stage}_fused_solve_loop_ms"] = statistics.median(calls)
    # the first launch again on its first n problems: with n = 1 the time over
    # the iteration count is what one problem needs for one iteration
    a, _ = captured[0]
    for n in args.prefix:
        prob_n = chip_smoke.batch_prefix(torch, a[2], B, n)
        st_n = chip_smoke.batch_prefix(torch, a[3], B, n)
        fn = lambda: launch(a[0], a[1], prob_n, st_n)
        its = fn().iterations
        alone = [kernel_ms(torch, fn) for _ in range(args.reps)]
        out[f"prefix{n}_kernel_alone_ms"] = statistics.median(alone)
        out[f"prefix{n}_iterations_max_mean"] = [int(its.max()), float(its.double().mean())]
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
