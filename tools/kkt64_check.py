#!/usr/bin/env python3
"""The KKT64 kernel (`loik_tpu_torch/kernels/csrc/kkt64.cu`) against the
plain float64 step on the card: its bits and its times at the plan cells'
shapes.

    python3 tools/kkt64_check.py [--reps 200] [--out FILE]

Two parts, one JSON object (a summary printed; the whole object also
written to ``--out``):

- ``bits``: `kernels.kkt64.kkt64_step` against `solver.refine._kkt64_plain`
  on the state the float32 stage 1 of the plan cells' robots leaves at
  their batches (panda_arm B 16384, talos 4096, solo12 10240:
  `chip_smoke.config`), and on random states of the cases of
  tests/kkt64_fixtures.py (float64 leaves one per problem, every
  constant-subspace joint type with two constraints on one link, batched
  geometry, more constraints than the fused loop takes) at B 45 and 4096:
  the outputs that differ in any bit (none expected).
- ``times``: per plan cell, the kernel's device time a launch (CUDA events
  over a captured graph of ``--reps`` launches, and the profiler's kernel
  time), two byte bounds at 3.35 TB/s (`kernels.kkt64.step_bytes`: the
  state read once and the delta problem and state written once, and the
  same without the delta state's zeroed leaves) with the kernel's share of
  each, and the plain step's time as a captured graph with its device
  operations a call.

Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from loik_tpu_torch.kernels import _build, kkt64  # noqa: E402
from loik_tpu_torch.solver import refine  # noqa: E402

from kkt64_fixtures import CASES, CELLS, case, differences, prepared32, stage1  # noqa: E402

HBM_BYTES_PER_S = 3.35e12


def graph_ms(fn, reps):
    """Device ms a call of ``fn`` as ``reps`` calls captured in one graph."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_us(fn, name, reps=20):
    """(device us a call of the kernels named ``name``, of every device
    operation, device operations a call), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    mine = sum(e.device_time_total for e in ev if name in e.key)
    every = sum(e.device_time_total for e in ev)
    return mine / reps, every / reps, sum(e.count for e in ev) / reps


def bits():
    rows = []
    for name in CELLS:
        tree, problem, prob32, st = stage1(name)
        got = kkt64.kkt64_step(tree, problem, prob32, st)
        rows.append(dict(case=name, B=st.vis.shape[-1], state="stage 1",
                         differ=differences(got, refine._kkt64_plain(tree, problem, prob32, st))))
    for name in CASES:
        for B in (45, 4096):
            tree, problem, st = case(name, "cuda", B)
            prob32 = prepared32(tree, problem, B)
            got = kkt64.kkt64_step(tree, problem, prob32, st)
            rows.append(dict(case=name, B=B, state="random", differ=differences(
                got, refine._kkt64_plain(tree, problem, prob32, st))))
    return rows


def times(reps):
    rows = []
    for name in CELLS:
        tree, problem, prob32, st = stage1(name)
        N, K, B = st.nu.shape
        nbytes, needed = kkt64.step_bytes(st, problem)
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        needed_us = needed / HBM_BYTES_PER_S * 1e6

        def kernel():
            return kkt64.kkt64_step(tree, problem, prob32, st)

        def plain():
            return refine._kkt64_plain(tree, problem, prob32, st)

        k_ms = graph_ms(kernel, reps)
        k_prof, _, k_ops = profiled_us(kernel, "kkt64_kernel")
        p_ms = graph_ms(plain, max(1, reps // 20))
        _, p_prof, p_ops = profiled_us(plain, "kkt64_kernel", reps=3)
        rows.append(dict(cell=f"{name}.plan", B=B, N=N, K=K, NC=problem.num_constraints,
                         bytes=nbytes, bound_us=bound_us, needed_bytes=needed,
                         needed_bound_us=needed_us, kernel_graph_us=k_ms * 1e3,
                         kernel_profiler_us=k_prof, kernel_ops=k_ops,
                         bound_share_pct=100.0 * bound_us / (k_ms * 1e3),
                         needed_share_pct=100.0 * needed_us / (k_ms * 1e3),
                         plain_graph_us=p_ms * 1e3, plain_profiler_us=p_prof,
                         plain_ops=p_ops))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kkt64_check: needs a CUDA device")
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    result = dict(card=card, torch=torch.__version__, bits=bits(), times=times(args.reps))
    result["ok"] = all(not r["differ"] for r in result["bits"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print("card", card)
    for r in result["bits"]:
        print("bits", json.dumps(r))
    for r in result["times"]:
        print("time", json.dumps(r))
    print(json.dumps(dict(ok=result["ok"])))
    if not result["ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
