#!/usr/bin/env python3
"""Time the flagship's graphed solve and count its captures over calibrated
trees, for one checkout.

    python3 tools/graph_replay_time.py [--root DIR] [--reps N]

Imports `loik_tpu_torch` from DIR (default: this checkout) and this
checkout's chip_smoke.py (the flagship's task, `config`, and the calibrated
copies of phase 21, `calibrated_copy` and `TOPOLOGY`), builds DIR's kernel
and drives the flagship's `DiffIkSolver.solve_refined(q, method="delta")`
at chip_smoke's batch and check_interval as a CUDA graph: first on
panda_arm, then on each calibrated copy, with each call's captures, graph
pool bytes, `memory_reserved` before and after and seconds; then the
repeated call with one tree, its launches and host synchronisations, and
its time (CUDA events, median of N, after one warm-up call).  Prints one
JSON line.  To compare two commits on one card, run it in turns inside one
job: parent, change, change, parent (the parent unpacked with
`git archive`).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("graph_replay_time: needs a CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import loik_tpu_torch as lt
    from loik_tpu_torch.kernels import _build
    from loik_tpu_torch.kernels import fused as fused_mod
    from loik_tpu_torch.utils import graphs

    if os.path.dirname(os.path.abspath(lt.__file__)) != os.path.join(root, "loik_tpu_torch"):
        raise SystemExit(f"graph_replay_time: imported {lt.__file__}, not {root}'s package")
    _build.build()
    dev = torch.device("cuda")
    B, K = cs.PATHS["flagship"]["B"], cs.PATHS["flagship"]["K"]
    base, links, problem, params, q = cs.config(lt, torch, "flagship", torch.float32, dev, B, K)
    trees = [base] + [cs.calibrated_copy(torch, base, cs.TOPOLOGY["seed"] + i)
                      for i in range(cs.TOPOLOGY["copies"])]
    solvers = [lt.DiffIkSolver(t, params, links, problem=problem, fused="require")
               for t in trees]

    def flagship(i):
        return solvers[i].solve_refined(q, method="delta")

    sequence = []
    for i in range(len(trees)):
        torch.cuda.synchronize()
        n0, r0 = len(graphs.CAPTURES), torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        flagship(i)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        caps = graphs.CAPTURES[n0:]
        sequence.append(dict(tree=i, captures=len(caps),
                             pool_bytes=sum(c.pool_bytes for c in caps),
                             reserved_before=r0, reserved_after=torch.cuda.memory_reserved(),
                             seconds=secs))
    torch.cuda.synchronize()
    fused_mod.LAUNCHES = 0
    _, syncs = cs.count_syncs(torch, lambda: flagship(len(trees) - 1))
    torch.cuda.synchronize()
    launches = fused_mod.LAUNCHES
    times = [cs.event_ms(torch, lambda: flagship(len(trees) - 1))[1]
             for _ in range(args.reps)]
    print(json.dumps({
        "root": root, "B": B, "check_interval": K, "sequence": sequence,
        "repeated_launches": launches, "repeated_host_syncs": len(syncs),
        "replay_ms": statistics.median(times), "replay_ms_all": times,
        "card": cs.card_line()}), flush=True)


if __name__ == "__main__":
    main()
