"""Measure what a first call costs against joint count: the counterpart of
tools/compile_scaling.py for the PyTorch/CUDA port.  loik_tpu pays trace
and compile once per program; the port pays a CUDA graph capture once per
key (`loik_tpu_torch.utils.graphs`): an eager warm-up call, the body
recorded under `torch.cuda.graph`, and the graph's instantiation.  The
solver's sweeps walk the tree joint by joint in Python, so a body call
dispatches more operators, and its graph holds more nodes, the taller the
tree.  This tool records that curve, on the chain of compile_scaling.py
(revolute joints, axes cycling x/y/z, one constraint at the last joint,
b_z = 0.1, bounds +-4, float32, max_iter 32, tol 1e-4), for three paths:

- ``solve``: the plain solve, its masked loop a WHILE node (the
  counterpart of the ``_solve_impl`` program compile_scaling.py compiles);
- ``solve_fused``: the solve through the hand-written kernel, where
  `kernels.fused.fused_eligibility` allows it (else its reason is printed);
- ``step`` (with ``--step``): the first-order training step of
  chip_smoke.py's phase 20 through `utils.jit` (sum nu^2 of
  `solve_unrolled` over 8 body calls, d/d b_z and d/d q, check_interval 1).

Per size and path: the operators one eager call dispatches (views counted
apart, by a `TorchDispatchMode`, autograd's backward included) and, for
``solve`` and ``step``, the operators of one body call (the difference of
two eager calls that differ in body calls, over that difference).  On the card also: the
first call in s, split as `graphs.Capture` records it (warm-up / record /
instantiate), the graph's nodes (the WHILE bodies' included), its pool in
MiB, the body executions of a replay and the replay's time (median of 5,
CUDA events), all after the eager calls that count operators and with the
kernel library built first, so that a warm-up finds them loaded.  One
line per size, then one JSON line.  No gate: it is a
measurement.

Usage:
    python tools/capture_scaling.py [--sizes 7 18 34 64 100] [--b 256] [--step]
    python tools/capture_scaling.py --device cpu --sizes 3 5 --b 4   # counts only

The card is the default; without one it raises unless given ``--device
cpu``, where it counts operators and measures nothing.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import loik_tpu_torch as lt
from loik_tpu_torch.kernels import _build, fused
from loik_tpu_torch.model.tree import REVOLUTE, make_tree
from loik_tpu_torch.solver import refine
from loik_tpu_torch.utils import graphs

UNROLLED_ITERS = 8


class Operators(TorchDispatchMode):
    """Counts the operators dispatched while it is on (autograd's worker
    threads included), views apart."""

    def __init__(self):
        super().__init__()
        self.ops = self.views = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.is_view:
            self.views += 1
        else:
            self.ops += 1
        return func(*args, **(kwargs or {}))


def chain(n, device):
    axes = [((1, 0, 0), (0, 1, 0), (0, 0, 1))[i % 3] for i in range(n)]
    J = [dict(name=f"j{i}", parent=i - 1, type=REVOLUTE, xyz=(0.05, 0.0, 0.1),
              axis=axes[i], velocity_limit=4.0) for i in range(n)]
    return make_tree(J, name=f"chain{n}", dtype=torch.float32, device=device)


def task(n, B, device):
    """(tree, problem, q, params) of compile_scaling.py's chain."""
    tree = chain(n, device)
    b = np.zeros((1, 6), np.float32)
    b[0, 2] = 0.1
    problem = lt.make_problem(tree, (n - 1,), b=b, lb=-4 * np.ones(n), ub=4 * np.ones(n))
    gen = torch.Generator(device=device).manual_seed(0)
    q = tree.random_configuration((B,), generator=gen)
    return tree, problem, q, lt.SolverParams(max_iter=32, tol_abs=1e-4, tol_rel=1e-4)


def step_fn(tree, params, problem, num_iters):
    """The first-order step of chip_smoke.py's phase 20: (sum nu^2, d/d
    b_z, d/d q), b_z the parameter."""
    mask = (torch.arange(6, device=tree.device) == 2).to(tree.dtype)

    def step(bz, q):
        bz.requires_grad_()
        q.requires_grad_()
        prob = problem.replace(b=problem.b * (1 - mask) + bz * mask)
        value = (lt.solve_unrolled(tree, params, q, prob, num_iters=num_iters).nu ** 2).sum()
        gb, gq = torch.autograd.grad(value, (bz, q))
        return value, gb, gq
    return step


def counted(fn):
    """(operators, views, body executions of a while loop) of one eager
    call of ``fn``."""
    graphs.reset_body_executions()
    with graphs.disable_graphs(), Operators() as mode:
        fn()
    return mode.ops, mode.views, graphs.body_executions()


def paths(n, B, device, with_step):
    """Per path: (name, the call or the reason it does not run, None or
    another eager call that differs from it in body calls: (that call,
    its body calls, the path's body calls), None where the while loop's
    count is read)."""
    tree, problem, q, params = task(n, B, device)
    one = params.replace(max_iter=1)
    out = [("solve", lambda: lt.solve(tree, params, q, problem),
            (lambda: lt.solve(tree, one, q, problem), None, None))]
    ok, why = fused.fused_eligibility(tree, params, B, refine.default_batch_tile(n),
                                      dtype=torch.float32)
    out.append(("solve_fused", (lambda: fused.solve_fused(tree, params, q, problem))
                if ok else why, None))
    if with_step:
        bz = torch.full((), 0.1, dtype=tree.dtype, device=device)
        step = lt.utils.jit(step_fn(tree, params, problem, UNROLLED_ITERS))
        # jitted too, so that it marks detached aliases, not bz and q
        longer = lt.utils.jit(step_fn(tree, params, problem, UNROLLED_ITERS + 1))
        out.append(("step", lambda: step(bz, q),
                    (lambda: longer(bz, q), UNROLLED_ITERS + 1, UNROLLED_ITERS)))
    return out


def card_line():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def on_card(fn):
    """The card's numbers of ``fn``'s graph: its first call (which must
    capture once), a replay's body executions and its time."""
    torch.cuda.synchronize()
    n = len(graphs.CAPTURES)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    if len(graphs.CAPTURES) != n + 1:
        raise RuntimeError(f"{len(graphs.CAPTURES) - n} captures in a first call, expected 1")
    cap = graphs.CAPTURES[-1]
    graphs.reset_body_executions()
    fn()
    bodies = graphs.body_executions()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return dict(first_call_s=first, warm_s=cap.warm_seconds, record_s=cap.record_seconds,
                instantiate_s=cap.instantiate_seconds, capture_s=cap.seconds,
                nodes=cap.nodes, pool_mib=cap.pool_bytes / 2**20, body_executions=bodies,
                replay_ms=statistics.median(times))


def measure(n, B, device, with_step):
    rows = []
    for name, call, other in paths(n, B, device, with_step):
        row = dict(njoints=n, path=name)
        if isinstance(call, str):
            rows.append(dict(row, skipped=call))
            continue
        ops, views, bodies = row["ops"], row["views"], _ = counted(call)
        if other is not None:
            o2, v2, b2 = counted(other[0])
            b2, bodies = other[1] or b2, other[2] or bodies
            if b2 != bodies:
                row["ops_per_body"] = (ops - o2) / (bodies - b2)
                row["views_per_body"] = (views - v2) / (bodies - b2)
        if device.type == "cuda":
            row.update(on_card(call))
        rows.append(row)
    graphs.clear_graphs()
    return rows


def line(n, rows):
    parts = []
    for r in rows:
        if "skipped" in r:
            parts.append(f"{r['path']}: not run ({r['skipped']})")
            continue
        s = f"{r['path']}: ops {r['ops']} (+{r['views']} views)"
        if "ops_per_body" in r:
            s += f", {r['ops_per_body']:.0f} a body call (+{r['views_per_body']:.0f})"
        if "first_call_s" in r:
            s += (f", first {r['first_call_s']:.2f}s (warm {r['warm_s']:.2f} / record "
                  f"{r['record_s']:.2f} / instantiate {r['instantiate_s']:.2f}), "
                  f"nodes {r['nodes']}, pool {r['pool_mib']:.0f} MiB, bodies "
                  f"{r['body_executions']}, replay {r['replay_ms']:.3f} ms")
        parts.append(s)
    return f"njoints={n:4d}  " + "; ".join(parts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[7, 18, 34, 64, 100])
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--step", action="store_true",
                    help="also the first-order training step through utils.jit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (counts only)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("capture_scaling: no CUDA card (torch.cuda.is_available() is "
                         "False); pass --device cpu to count operators only")
    if device.type == "cuda":
        kind, card = torch.cuda.get_device_name(device), card_line()
        # built before the first capture, whose warm-up would load it
        t0 = time.perf_counter()
        _build.build()
        built = f", kernel library ready in {time.perf_counter() - t0:.1f}s"
    else:
        kind, card, built = "cpu", None, ""
    print(f"# graph capture, B={args.b}, f32, max_iter=32, device {kind}"
          + (f" ({card}){built}" if card else " (operator counts only)"), flush=True)
    rows = []
    for n in args.sizes:
        got = measure(n, args.b, device, args.step)
        print(line(n, got), flush=True)
        rows += got
    print(json.dumps(dict(tool="capture_scaling", device=kind, card=card, b=args.b,
                          max_iter=32, unrolled_iters=UNROLLED_ITERS, rows=rows)), flush=True)


if __name__ == "__main__":
    main()
