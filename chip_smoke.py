#!/usr/bin/env python3
"""Drive loik_tpu_torch's main paths once on one CUDA card and check them.

    python3 chip_smoke.py        # from the repository root, one GPU

Eight main paths through the fused ADMM kernel
(`loik_tpu_torch/kernels/csrc/fused_admm.cu`), then the differentiable solve
and the logged mirror of a kernel solve (phases 15-16), then the scale-out
and surface paths (phase 17), all launched eagerly under
`utils.disable_graphs()` (several phases hook Python functions that a CUDA
graph's replay never calls); then phase 18, the same entry points as
captured CUDA graphs, the default on the card, and phase 19, the entry
points whose graphs hold the solver's masked while loop as a WHILE node.
Three are the
tight-tolerance solve
`DiffIkSolver(..., fused="require").solve_refined(q, method="delta")` at
tol 1e-6, whose two float32 stages each run the kernel:
  - flagship: `panda_arm` (7 revolute joints), one 6-D end-effector
    constraint, box +-4, B = 16384, check_interval 8;
  - solo12: free-flyer base + 4 x 3 revolute joints (13 joints, 18 dof),
    a base twist command and four point-foot constraints, box +-12,
    B = 10240, check_interval 4;
  - talos: the TALOS humanoid (33 joints, 38 dof, free-flyer base), a
    gripper heave with the base held, box +-4, B = 4096, check_interval 1.
Two are the fleet paths:
  - mixed: 512 UR5 + 512 panda_arm as ONE padded super-batch
    (`parallel.prepare_mixed_padded`, `MixedPadded.solve_packed` with
    `solve_delta_duals(fused="require")`), box = the velocity limits capped
    at 4, v_z = 0.2, tol 1e-6, check_interval 4: the kernel reads every
    problem's own motion subspaces (`S_all`);
  - tracking: `DiffIkSolver(panda_arm, ..., fused="require")` with warm
    starts at tol 1e-4, check_interval 1, fleets of B = 16384 and B = 256,
    a target sweep of T = 100 ticks through `track_scan`: one launch per
    tick, each tick's state the input of the next.
Three are the planner and position-level paths:
  - multistart: bench.py's multistart configuration, `panda_arm` with the
    flagship's task and settings, 7 batches of B = 16384 random seeds
    (>= 1e5) from one seeded CUDA generator through
    `parallel.solve_multistart` with the delta-duals `solve_fn` (stage-1 cap
    32, fused="require"), top k = 8: two launches per batch;
  - clik: `DiffIkSolver(panda_arm, ..., fused="require").reach`, B = 16384
    from the neutral configuration to FK of neutral moved by 0.35 N(0, 1)
    tangent steps, dt 0.1, 80 ticks, gain 2, float32 at tol 1e-4,
    check_interval 1, max_iter 100: one launch per tick;
  - two-stage: the flagship's inputs through
    `solve_refined(method="two-stage", stage1_max_iter=32, stage2_max_iter=4)`
    (bench.py's two-stage defaults): one launch (the float32 stage 1), then
    the float64 stage 2 on the masked while loop; and `mobile_ur5` (a
    universal joint, so the kernel cannot take it) at B = 4096 through
    `solve_refined()` with fused=None, which takes the two-stage path on
    while loops alone, silently.

Phases (any failure raises, so the script exits nonzero):
  1. a CUDA device, and the card's name and power limit from nvidia-smi;
  2. the kernel library built with nvcc from the sources in the checkout,
     with the build time, ptxas' register, stack and spill report, and for
     every path the shared memory one problem's frame takes (sized by the
     tree) and the problems per block the wrapper chooses;
  3. the double instantiation against the eager float64 loop on the
     flagship at B=1024, check_interval 1 and 8: every state field within
     1e-9 abs-or-rel, iterations and flags equal;
  4. the float instantiation against the eager float32 loop at B=16384 for
     max_iter 1, 2, 3 at check_interval 1, within 1e-4 abs-or-rel.  The
     kernel sums in the eager loop's order without FMA contraction, so the
     expected error is 0; 1e-4 is the bound for float32 reassociation;
  5. the flagship main path: the launch count rises by 2, the outcome budget
     against the eager path (nu within 2e-5 where both converged, converged
     flags differing on at most max(1, B/100) problems, equal iteration
     counts on at least 99%), and, for every problem flagged converged, the
     task residual |A v - b|_inf over every constraint and the box violation
     recomputed in float64 from (q, nu) at most 1e-5.  Then the kernel and
     the eager loop are run again on the inputs the main path gave each
     stage, compared and timed with CUDA events (median of 5 after a
     warm-up; the kernel's own device time from torch.profiler beside it),
     the least time the card could take for the same work is computed
     from this run's shapes and iteration counts, and stage 1 is timed
     again at other numbers of problems per block and on a 64th and an 8th
     of the batch;
  6. multi-dof joints and tall trees against the eager loop: the double
     instantiation on solo12 (B=1024, check_interval 1 and 4) and talos
     (B=256, check_interval 1) within 1e-9, padded dof slots zero; the float
     instantiation on both at full B for max_iter 1, 2, 3 within 1e-4;
  7. the solo12 main path, checked and timed as phase 5;
  8. the talos main path, likewise;
  9. per-problem subspaces against the eager loop: the double instantiation
     on the mixed chain at B=1024, check_interval 1 and 4, within 1e-9, the
     padded joint's dof slots exactly zero; the float instantiation at
     B=1024 and B=16384 for max_iter 1, 2, 3 within 1e-4; and panda_arm with
     its shared S broadcast to `S_all` against the shared-S launch on the
     flagship's inputs, bit for bit, both timed;
 10. the mixed main path: the launch count rises by 2, the outcome budget
     against the eager path, the float64 task residual and box violation of
     every converged problem at most 1e-5 RECOMPUTED PER GROUP ON THE
     GROUP'S OWN UNPADDED TREE from `unpack`'s result, and against
     `solve_mixed` (one kernel solve per topology) converged flags differing
     on at most max(1, B/100) problems and nu within 2e-5 where both
     converged.  Timed as phase 5, once more at 8192 + 8192, and as
     `solve_scan(q_packed=..., light=True)` over 20 staged super-batches;
 11. the tracking path: `track_scan` over T=10 at B=1024 equals T eager
     ticks on every state field and 10 calls of `solve_tracking`; for each
     fleet, after five settling ticks, the T=100 stream launches the kernel
     exactly T times and enqueues WITHOUT A HOST SYNCHRONISATION (counted
     with torch's sync debug mode); converged fraction, mean warm iterations
     and the float64 task residual of the last tick's converged problems (at
     most 1e-3); ms per tick by CUDA events around the whole stream, the
     host's enqueue time, the synchronous p50 of `solve_tracking`, the
     kernel alone per tick, the device's idle share over one stream
     (torch.profiler), and the bound;
 12. the multistart path: the launch count rises by 2 per batch; in every
     batch the errors ascend, slots beyond num_converged are inf, and every
     finite slot's float64 task residual recomputed from (q, nu) is at most
     1e-5 and equals its error within 1e-5; on a 1024-seed prefix the
     outcome budget against the eager path.  Seeds/s with every seed
     counted (CUDA events, median of 5 batches after a warm-up) with the
     kernel alone beside it, and the first batch's launches against the
     eager loop on their inputs, timed, with the bound;
 13. the closed-loop IK path: exactly 80 launches and no host
     synchronisation over the tick loop; the kernel path against the eager
     path on every returned field after 10 ticks at B=1024 (1e-4
     abs-or-rel, 0 expected) and after 80 ticks at B=64, with the reached
     fraction no more than 1% below the eager path's; the final pos_err/rot_err
     against a float64 FK of the returned q within 1e-5; the float32
     pose-error floor; ms per tick, host enqueue per tick, kernel alone per
     tick and the device's idle share over one run, and the bound;
 14. the two-stage path: one launch, the float64 certificate of every
     converged problem, the converged fraction beside the delta path's,
     stage 1, stage 2 and total times; then `mobile_ur5` with no launch, no
     warning, certified the same way;
 15. the differentiable solve (`solve_unrolled`, no kernel: the eager body
     under autograd) on the flagship's task, b_z = 0.2 the parameter,
     B = 16384, check_interval 1, 60 calls: no launch; in float64 the
     forward equals `solve` with the same budget (nu within 1e-8 where both
     converged, converged flags equal); d loss/d b_z and d loss/d q at two
     coordinates (loss = sum nu^2) against central differences on the card
     (tests/test_diff.py's bounds); at B = 1024 the second derivative
     against a central difference of the first (1e-4); the float32 gradient
     finite and within UNROLLED's bound of the float64 one; forward and
     forward + backward times (CUDA events, median of 5) and the peak memory
     of a step in both types; 0 host synchronisations in a warm forward;
 16. logging and the mirror: `debug_mirror(..., atol=0.0)` of the kernel's
     flagship float32 `solve_fused` at B = 16384, of the 64 problems that
     ran longest (`sample=`) and of a warm tracking tick (tol 1e-4): flags,
     iterations and both residuals bit for bit, and the last logged
     residual of every problem its reported one; the eager solve with and
     without logging, in turns; `no_recompile_guard` silent over three warm
     `solve_refined` calls and firing on a first solve at B = 65536;
     `trace()` naming the kernel around a delta and a two-stage solve (its
     events against the launches counted, their device time), and the
     two-stage stage-1 launch re-run alone in five profiler sessions;
 17. scale-out and the rest of the surface, on the flagship's task at
     B = 16384 in float32: `parallel.solve_sharded` over `make_mesh()` and
     over 4 repetitions of the card against `solve` on the same inputs
     (phase 5's outcome budget, the differences logged, 0 expected) and
     `convergence_metrics` against its numpy recomputation; one batch of
     16384 seeds through `solve_multistart(mesh=<2 repetitions of the card>,
     solve_fn=<delta-duals, fused="require">, k=8)`: the launch count rises
     by 2 per distinct device of the mesh (a device solves all its shards as
     one batch), phase 12's ranking invariants, the top-k errors those of
     the unsharded call on the same generator seed within 2e-5, both timed
     (CUDA events, median of 5), each launch against its plain version with
     its bound (the `kernels` entry `multistart_sharded`);
     `parallel.distributed` at world size 1 on NCCL over a localhost TCP
     port chosen at run time: `solve_global` and `global_metrics` equal to
     `convergence_metrics`; the numpy oracle (`loik_tpu_torch.oracle`)
     against the kernel's float64 instantiation on panda at the oracle
     fixture's configuration, ur5 neutral and 16 random panda_arm
     configurations: flags and iterations equal, nu within 1e-9;
     `load_urdf_native` of talos (floating base) on the card, leaf for leaf
     equal to `load_urdf`, and the talos main path on it equal to the one on
     the Python tree bit for bit; `entry.entry()` once and
     `entry.dryrun_multichip(torch.cuda.device_count())`; every
     `examples/torch/0N_*.py` as a concurrent subprocess (graphs on), exit
     code 0; the sharded multistart's launches alone from the trace of a
     whole call;
 18. the compiled entry points as CUDA graphs (`utils.graphs`, the default
     on the card): the flagship's, solo12's and talos'
     `solve_refined(method="delta")` at phase 5's, 7's and 8's sizes, the
     mixed super-batch 512 + 512 (`MixedPadded.solve_packed` with the
     delta-duals solve), one multistart batch of 16384 seeds scored by the
     delta-duals solve, the tracking stream `solve_stream` from a settled
     warm state at B = 16384 and 256 (T = 100), `solve_tracking` at B =
     16384 and `reach` (B = 16384, 80 ticks), each: the first call's time
     with its capture, the graph's pool (`memory_reserved` across the
     capture) and static input bytes; a repeated call replays and launches
     the kernel 2 (each solve), 100, 1 and 80 times (counted on replay)
     with 0 host synchronisations; graphed equal to the same call launched
     eagerly (`disable_graphs()`) on every tensor of the result, bit for
     bit; the flagship certified as in phase 5; a second call with other
     inputs leaves the first result unchanged; graphed and eager-launched
     times in turns (CUDA events, median of 5; `solve_tracking`:
     synchronous p50 over 40 ticks) and, for the stream and CLIK, the
     device's idle share on the profiler's trace of one replayed run (the
     gaps between its device operations over their span).  The `kernels`
     entries of those paths carry these numbers under "graph";
 19. the masked while loop as a CUDA graph WHILE node
     (`utils.graphs.while_loop`): `solve()` on the flagship (B = 16384,
     check_interval 8), solo12 (B = 10240, 4) and talos (B = 4096, 1); the
     two-stage `solve_refined()` on mobile_ur5 (B = 4096, both stages while
     loops) and on the flagship (caps 32 / 4: one kernel launch, then the
     float64 while loop); the flagship's `solve_delta_refined`; the mixed
     512 + 512 `solve_packed` and `solve_scan` over R = 4 with the default
     solve; one multistart batch of 16384 seeds with the default solve (the
     sampler, solve, scoring and top k as one graph, the eager call drawing
     from a twin generator); `track_scan` (T = 10, from a settled warm
     state; and T = 100 graphed, its first 10 ticks held to those, timed
     once) and
     `solve_tracking` on the plain loop at B = 256, each: the
     first call's time, the capture's time, pool and nodes (the WHILE
     bodies' included); a repeated call with 0 host synchronisations and 1
     kernel launch (the flagship two-stage) or 0; graphed equal to the same
     call launched eagerly on every tensor, bit for bit, after as many loop
     body executions (`graphs.body_executions`); the two-stage runs
     certified as in phase 5; a second call with other inputs leaving the
     first result unchanged; graphed and eager-launched times in turns
     (CUDA events, median of 5; an eager-launched call over 2.5 s timed
     once, marked "a single reading"; `solve_tracking`: synchronous p50
     over 10 ticks); the share of
     the graphed call spent copying the carry back.  The two-stage
     `kernels` entry carries its numbers under "graph".

The line before the last reports the kernel on each path as JSON; the last
line is the run's verdict as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

SOURCE = "loik_tpu_torch/kernels/csrc/fused_admm.cu"
REPLACES = "loik_tpu/kernels/fused.py:62"
# published peaks of one H100 SXM: float32 outside the tensor cores, HBM3
PEAK_FP32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# the delta-duals main paths: batch, check_interval
PATHS = {
    "flagship": dict(B=16384, K=8),
    "solo12": dict(B=10240, K=4),
    "talos": dict(B=4096, K=1),
    "mixed": dict(B=1024, K=4),
}
# the tracking path: fleets, ticks, tolerance
TRACKING = dict(fleets=(16384, 256), T=100, tol=1e-4, settle=5)
# the planner paths (bench.py's multistart and two-stage defaults,
# examples/07_position_ik.py's closed loop)
MULTISTART = dict(B=16384, seeds=100_000, k=8, stage1_max_iter=32, prefix=1024)
CLIK = dict(B=16384, steps=80, dt=0.1, gain=2.0, tol=1e-4, max_iter=100, spread=0.35,
            prefix=1024, short=10, reached_prefix=64)
TWO_STAGE = dict(stage1_max_iter=32, stage2_max_iter=4, mobile_B=4096)
# the while-loop graphs (phase 19): the mixed scan's reps; the plain-loop
# tracking fleet, its ticks (cut from the kernel path's 100: its stragglers
# make about 68 body executions a tick, 15 s a graphed stream of 100 on
# NVIDIA H100 80GB HBM3), the solve_tracking ticks compared and timed; an
# eager-launched call longer than eager_reps_below_ms is timed once
WHILE = dict(mixed_reps=4, tracking_B=256, tracking_T=10, tracking_T_long=100, ticks=5,
             p50_ticks=10, eager_reps_below_ms=2500.0)
# the differentiable solve (flagship task, check_interval 1), the second
# derivative's batch, the float32 gradient's bound against float64, and the
# batch of the allocation guard's first solve.  The float32 bound: at tol
# 1e-6 float32 sits at its floor (about 1e-5), so problems freeze at other
# iterations than in float64 and the unrolled gradients of those differ;
# the first reading was 8.84e-3 (NVIDIA H100 80GB HBM3, 700 W), the bound
# is about twice that.  After the cache is emptied the allocator's pool
# settles within a few calls: one warm-up call left it reserving 2 more
# segments over the next three
UNROLLED = dict(B=16384, num_iters=60, B_second=1024, f32_rel_bound=2e-2, guard_B=65536,
                guard_warmup=3)
# the scale-out and surface paths (phase 17): the flagship's task at full
# batch, split over meshes of 1 and `shards` shards (repetitions of the
# card), the multistart batch over `ms_shards`, the oracle on its fixtures
# and `oracle_random` random flagship problems, each example with a limit
SCALE_OUT = dict(B=16384, shards=4, ms_shards=2, k=8, oracle_random=16, example_timeout=300)
# the oracle fixture's explicit panda configuration (tests/test_oracle.py::PANDA_Q,
# from the reference's tests/loik-loid.cpp:214)
PANDA_Q = (-2.79684649, -0.55090374, 0.424806, -1.21112304, -0.89856966,
           0.79726132, -0.07125267, 0.13154589, 0.13171856)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def _skew(r):
    return [[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]], [-r[1], r[0], 0.0]]


def config(lt, torch, name, dtype, device, B, check_interval, max_iter=200):
    """(tree, constraint links, problem, params, seeded q batch) of a path."""
    ds = str(dtype).removeprefix("torch.")
    gen = torch.Generator(device=device).manual_seed(0)
    if name == "flagship":
        tree = lt.robots.panda_arm(ds, device=device)
        links = (6,)                   # the end-effector joint
        b = torch.tensor([[0.0, 0.0, 0.2, 0.0, 0.0, 0.0]], dtype=dtype)
        problem = lt.make_problem(
            tree, links, b=b, lb=-4.0 * torch.ones(tree.nv, dtype=dtype),
            ub=4.0 * torch.ones(tree.nv, dtype=dtype))
        q = tree.random_configuration((B,), generator=gen)
    elif name == "solo12":
        # stance task: a 6-D base twist command (heave 0.1) and zero linear
        # velocity of the four foot POINTS, 0.16 m below the knee frames
        # (A encodes v_lin - [r]x w per foot)
        tree = lt.robots.solo12(ds, device=device)
        links = (0,) + tree.leaf_joints
        A = torch.zeros((5, 6, 6), dtype=dtype)
        A[0] = torch.eye(6, dtype=dtype)
        for k in range(1, 5):
            A[k, :3, :3] = torch.eye(3, dtype=dtype)
            A[k, :3, 3:] = -torch.tensor(_skew([0.0, 0.0, -0.16]), dtype=dtype)
        b = torch.zeros((5, 6), dtype=dtype)
        b[0, 2] = 0.1
        problem = lt.make_problem(
            tree, links, A=A, b=b, lb=-12.0 * torch.ones(tree.nv, dtype=dtype),
            ub=12.0 * torch.ones(tree.nv, dtype=dtype))
        # bent-knee standing configurations (straight legs are singular)
        q0 = tree.neutral().clone()
        q0[7:] = torch.tensor([0, 0.8, -1.6] * 2 + [0, -0.8, 1.6] * 2, dtype=dtype)
        dq = 0.3 * (2.0 * torch.rand((B, tree.nv), generator=gen, dtype=dtype,
                                     device=device) - 1.0)
        q = tree.integrate(q0, dq)
    elif name == "talos":
        # a commanded gripper heave with the base held (stance)
        tree = lt.robots.talos(ds, device=device)
        links = (tree.joint_names.index("gripper_left_joint"), 0)
        b = torch.zeros((2, 6), dtype=dtype)
        b[0, 2] = 0.2
        problem = lt.make_problem(
            tree, links, b=b, lb=-4.0 * torch.ones(tree.nv, dtype=dtype),
            ub=4.0 * torch.ones(tree.nv, dtype=dtype))
        q = tree.random_configuration((B,), generator=gen)
    else:
        raise KeyError(name)
    params = lt.SolverParams(
        max_iter=max_iter, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
        mu_equality_scale_factor=1e5, tail_solve=False,
        check_interval=check_interval,
    )
    return tree, links, problem, params, q


def initial_state(sm, tree, problem, params, q):
    """Prepared problem and reset state with FK, as `_solve_impl` builds them."""
    from loik_tpu_torch.solver.state import init_state

    dtype, B = q.dtype, q.shape[0]
    prob = sm.prepare_problem(tree, problem, B, dtype)
    st = sm._reset_state(tree, params,
                         init_state(tree, B, problem.num_constraints, dtype, q.device),
                         dtype)
    liMi_R, liMi_p = sm.fwd_pass_init(tree, q)
    return prob, dataclasses.replace(st, liMi_R=liMi_R, liMi_p=liMi_p)


def state_errors(torch, fields, got, want):
    """Per floating field, (max abs error, max abs-or-rel error) with the
    tests/test_lockstep.py predicate; infinities in the same places (the
    residuals of problems that never ran) count as equal.  Integer and
    boolean fields must be equal."""
    errs = {}
    for name in fields:
        a, b = getattr(got, name), getattr(want, name)
        if not a.is_floating_point():
            n = int((a != b).sum())
            if n:
                raise AssertionError(f"{name} differs on {n} entries")
            continue
        a, b = a.double(), b.double()
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"{name}: NaNs at different places")
        err = (torch.nan_to_num(a) - torch.nan_to_num(b)).abs()
        rel = err / torch.nan_to_num(b).abs().clamp_min(1.0)
        errs[name] = (float(err.max()), float(torch.minimum(err, rel).max()))
    return errs


def cuda_median_ms(torch, fn, reps=5):
    """Median CUDA-event time of fn() after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(torch, fn):
    """One call of fn on torch.profiler.  Returns the wall time of the block
    (ms, host clock, synced) and, in us, the device time of the fused
    kernel's launches and of every kernel, copy and set, summed over the
    events of the exported trace (`trace_device_us`), and the fused
    kernel's time as `key_averages()` reports it (phase 16 sets the two
    side by side)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    avg_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                 if "fused_admm_kernel" in e.key)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        launches, kernel_us, device_us = trace_device_us(path)
        busy_us, span_us = trace_busy_span_us(path)
    return dict(wall_ms=wall, kernel_us=kernel_us, kernel_avg_us=avg_us,
                device_us=device_us, launches=launches, busy_us=busy_us, span_us=span_us)


def trace_device_us(path):
    """From a Chrome trace of torch.profiler: (the fused kernel's launches,
    their device time, the device time of every kernel, copy and set), us."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    ours = [e for e in device
            if e.get("cat") == "kernel" and "fused_admm_kernel" in e.get("name", "")]
    return (len(ours), sum(e.get("dur", 0) for e in ours),
            sum(e.get("dur", 0) for e in device))


def trace_busy_span_us(path):
    """From a Chrome trace of torch.profiler: (the time at least one kernel,
    copy or set ran on the device, their intervals merged; the span from
    the first one's start to the last one's end), us.  Their difference is
    the time the device sat idle between operations."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "ts" in e)
    if not spans:
        return 0.0, 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return busy, max(b for _, b in spans) - spans[0][0]


def kernel_device_ms(torch, fn):
    """Device time of the fused kernel itself in one call of fn, from the
    profiler's trace (the CUDA-event times above also hold the wrapper's
    operand copies and host work); None if the trace holds no launch."""
    us = profiled(torch, fn)["kernel_us"]
    return us / 1e3 if us else None


def idle_report(what, prof, T):
    """The kernel alone per tick, device busy and idle share of one
    `profiled` stream or run of T ticks."""
    if not prof["device_us"]:
        log("    profiler saw no device time: kernel alone and idle share not measured")
        return None
    alone = prof["kernel_us"] / 1e3 / T if prof["kernel_us"] else None
    log(f"    profiler over one {what}: wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['device_us'] / 1e3:.3f} ms, idle share "
        f"{1 - prof['device_us'] / 1e3 / prof['wall_ms']:.4f}, kernel alone "
        + ("not measured" if alone is None else f"{alone:.4f} ms per tick"))
    return alone


def link_velocities(sm, bsp, tree, q, nu):
    """Local-frame spatial velocity of every link for joint velocities nu
    (B, nv): the kinematic recursion v_i = X_i^-1 v_parent + S_i nu_i from
    FK, with S evaluated at q where it depends on it.  Returns a list of
    (B, 6) tensors."""
    R, p = sm.fwd_pass_init(tree, q)                 # (N,3,3,B), (N,3,B)
    nu_t = nu.movedim(0, -1)                           # (nv, B)
    v = []
    for i in range(tree.njoints):
        par = tree.parents[i]
        v_par = v[par] if par >= 0 else nu_t.new_zeros((6, nu_t.shape[-1]))
        iv, k = tree.idx_v[i], tree.nvs[i]
        S = tree.joint_S(i, q)                         # (6, k) or (B, 6, k)
        S = S.movedim(0, -1) if S.ndim == 3 else S[:, :, None]
        v.append(bsp.act_inv_motion(R[i], p[i], v_par) + bsp.mv(S, nu_t[iv:iv + k]))
    return [x.movedim(-1, 0) for x in v]


def batch_prefix(torch, x, B, n):
    """A prepared problem or a state cut to its first n of B problems."""
    cut = {f.name: getattr(x, f.name)[..., :n].contiguous() for f in dataclasses.fields(x)
           if isinstance(getattr(x, f.name), torch.Tensor) and getattr(x, f.name).ndim
           and getattr(x, f.name).shape[-1] == B}
    return dataclasses.replace(x, **cut)


def loop_bound(fused_mod, tree, params, prob, st_in, st_out):
    """(bytes, operations) the fused loop needs for this call: every input
    read once and every output written once, and the arithmetic of the
    iterations these inputs actually ran (a multiply and an add count one
    operation each).  The H half of the Riccati sweep runs once per body
    call (iterations / check_interval), the checks once per body call too."""
    tensors = [getattr(st_in, n) for n in fused_mod._STATE_FIELDS]
    tensors += [getattr(prob, n) for n in fused_mod._PROB_FIELDS]
    tensors += [getattr(prob, n) for n in fused_mod._OPTIONAL_FIELDS
                if getattr(prob, n) is not None]
    # the motion subspaces: per problem (S_all) or one small tensor per tree
    tensors += [st_in.liMi_R, st_in.liMi_p,
                prob.S_all if prob.S_all is not None
                else fused_mod._subspace_operand(tree, st_in.vis.dtype)]
    tensors += [getattr(st_out, n) for n in fused_mod._STATE_FIELDS]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)

    N, NC, nv = tree.njoints, len(prob.constraint_links), tree.nv
    K = params.check_interval
    nonroot = [k for k, par in zip(tree.nvs, tree.parents) if par >= 0]
    h_half = 6 * N + 72 * NC                      # rho I + H_ref + mu_eq AtA
    for k in tree.nvs:                            # U = H S, D = S'U + mu I, D^-1
        h_half += 66 * k + 11 * k * k + k + (1 if k == 1 else 2 * k ** 3)
    for k in nonroot:                             # U D^-1, H - U D^-1 U', X* Ha X*'
        h_half += 6 * k * (2 * k - 1) + 72 * k + 846
    iterate = 2 * nv + 12 * N + 18 * NC           # FwdPass1
    iterate += 12 * nv + sum(12 * k + 51 for k in nonroot)            # BwdPass
    iterate += N * (39 + 72) + sum(12 * k + 2 * k * k + 12 * k for k in tree.nvs)  # FwdPass2
    iterate += 6 * nv + 144 * NC                  # BoxProj, DualUpdate
    checks = 57 * N + 13 * nv + 78 * N + 40 * N + 20 * nv + 30 * NC   # dual residual, norms
    its = int((st_out.iterations - st_in.iterations).sum())
    ops = its * iterate + (its // K) * (h_half + checks)
    return nbytes, ops


def bound_ms(nbytes, ops):
    """The least time for (bytes, operations) at the published peaks, and
    which of the two sets it."""
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, ops / PEAK_FP32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class HostSplit:
    """Host-clock time per layer of one solve, with a synchronize around
    every timed call: wraps the named module functions for one `with`."""

    def __init__(self, torch, targets):
        self.torch, self.targets, self.ms, self.saved = torch, targets, {}, []

    def __enter__(self):
        for label, mod, attr in self.targets:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, self._timed(label, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)

    def _timed(self, label, fn):
        def wrapper(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            self.ms[label] = self.ms.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return wrapper


def capture_launches(mods, fn):
    """fn() with the launch count set to 0 just before and read just after,
    and every `fused_solve_loop` call's inputs recorded.  Returns (fn's
    result, launches counted by the wrapper, the recorded calls)."""
    torch, fused_mod = mods[0], mods[2]
    captured = []
    launch = fused_mod.fused_solve_loop

    def recording(tree_, params_, prob_, st_, batch_tile=None):
        captured.append((tree_, params_, prob_, st_, batch_tile))
        return launch(tree_, params_, prob_, st_, batch_tile)

    fused_mod.fused_solve_loop = recording
    try:
        fused_mod.LAUNCHES = 0
        res = fn()
        torch.cuda.synchronize()
        launches = fused_mod.LAUNCHES
    finally:
        fused_mod.fused_solve_loop = launch
    return res, launches, captured


def outcome_budget(res, ref, B, what, it_frac=0.99):
    """nu within 2e-5 where both converged, converged flags differing on at
    most max(1, B/100) problems, equal iteration counts on at least it_frac
    (None: not held)."""
    conv, conv_r = res.converged, ref.converged
    both = conv & conv_r
    nu_err = float((res.nu - ref.nu)[both].abs().max())
    flag_diff = int((conv != conv_r).sum())
    it_eq = float((res.iterations == ref.iterations).double().mean())
    log(f"    vs {what}: nu max |diff| {nu_err:.3e} (converged in both), "
        f"flag diffs {flag_diff}, equal iteration counts {it_eq:.4f}, "
        f"all-problem nu max |diff| {float((res.nu - ref.nu).abs().max()):.3e}")
    if not (nu_err <= 2e-5 and flag_diff <= max(1, B // 100)
            and (it_frac is None or it_eq >= it_frac)):
        raise AssertionError(f"outcome budget against {what} not met")


def certify(mods, tree, problem, links, q, res, label=""):
    """For every problem flagged converged: the task residual |A v - b|_inf
    over every constraint and the box violation, recomputed in float64 from
    (q, nu) on `tree`; at most 1e-5 each."""
    torch, sm, bsp = mods[0], mods[3], mods[5]
    conv = res.converged
    nu64 = res.nu.double()[conv]
    v = link_velocities(sm, bsp, tree.astype(torch.float64), q.double()[conv], nu64)
    task = max(float((v[c] @ problem.A[k].double().T - problem.b[k].double()).abs().max())
               for k, c in enumerate(links))
    box = float(torch.clamp(torch.maximum(problem.lb.double() - nu64,
                                          nu64 - problem.ub.double()), min=0).max())
    log(f"    {label}converged {float(conv.double().mean()):.4f}, mean iterations "
        f"{float(res.iterations.double().mean()):.2f}, f64 task residual "
        f"{task:.3e} over {len(links)} constraints, box violation {box:.3e} "
        "(max over converged)")
    if not (task <= 1e-5 and box <= 1e-5):
        raise AssertionError("a converged problem misses the task or the box")


def host_split(mods, fn):
    """Where the host's time goes: one call of fn with a synchronize around
    each layer."""
    torch, _, fused_mod, sm, rf, _ = mods
    split = HostSplit(torch, [
        ("FK", sm, "fwd_pass_init"), ("prepare", sm, "prepare_problem"),
        ("prepare", rf, "prepare_problem"), ("reset", sm, "_reset_state"),
        ("reset", rf, "_reset_state"), ("f64 KKT", rf, "kkt_residual"),
        ("kernel wrapper", fused_mod, "fused_solve_loop")])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with split:
        fn()
        torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    rest = total - sum(split.ms.values())
    log(f"    host split of one synced solve ({total:.3f} ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.ms.items())
        + f", rest (delta problem, casts, validation, recombination, packing) {rest:.3f} ms")


def stage_report(mods, captured, eager_reps=3, what="stage"):
    """Each recorded launch again, kernel against its plain version on the
    same inputs: compared (at most 2e-5, expected 0), timed with CUDA events
    and on the profiler, with the bound from these inputs.  Returns the sums
    over the launches."""
    torch, _, fused_mod, sm, _, _ = mods
    launch = fused_mod.fused_solve_loop
    out = dict(ms=0.0, plain_ms=0.0, alone_ms=0.0, err=0.0, nbytes=0, ops=0)
    for stage, (tree_, params_, prob_, st_, bt) in enumerate(captured, 1):
        ker = launch(tree_, params_, prob_, st_, bt)
        ref = sm._solve_loop(tree_, prob_, params_, st_)
        err = max(a for a, _ in state_errors(torch, fused_mod._STATE_FIELDS,
                                             ker, ref).values())
        k_ms = cuda_median_ms(torch, lambda: launch(tree_, params_, prob_, st_, bt))
        p_ms = cuda_median_ms(torch, lambda: sm._solve_loop(tree_, prob_, params_, st_),
                              reps=eager_reps)
        dev_ms = kernel_device_ms(torch, lambda: launch(tree_, params_, prob_, st_, bt))
        nbytes, ops = loop_bound(fused_mod, tree_, params_, prob_, st_, ker)
        b_ms, b_by = bound_ms(nbytes, ops)
        log(f"    {what} {stage}: fused_solve_loop {k_ms:.3f} ms (kernel alone "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'} on the "
            f"profiler), eager loop {p_ms:.3f} ms, max abs err {err:.3e}; "
            f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G operations, bound {b_ms:.4f} ms "
            f"by {b_by}")
        out["ms"] += k_ms
        out["plain_ms"] += p_ms
        out["err"] = max(out["err"], err)
        out["alone_ms"] = (None if dev_ms is None or out["alone_ms"] is None
                           else out["alone_ms"] + dev_ms)
        out["nbytes"] += nbytes
        out["ops"] += ops
    if out["err"] > 2e-5:
        raise AssertionError(f"kernel vs eager loop at the main path's inputs: {out['err']}")
    return out


def kernels_entry(name, launches, rep):
    least_ms, least_by = bound_ms(rep["nbytes"], rep["ops"])
    return {
        "name": f"fused_admm/{name}", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": rep["err"],
        "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": least_ms,
        "bound_by": least_by, "library_ms": None, "kernel_alone_ms": rep["alone_ms"],
    }


def main_path(mods, name, phase):
    """Drive one delta-duals main path through the kernel, check it against
    the eager path and in float64, time it; returns the path's `kernels`
    entry."""
    torch, lt, fused_mod = mods[:3]
    B, K = PATHS[name]["B"], PATHS[name]["K"]
    dev = torch.device("cuda")
    tree, links, problem, params, q = config(lt, torch, name, torch.float32, dev, B, K)
    solver = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")
    eager = lt.DiffIkSolver(tree, params, links, problem=problem, fused=False)

    res, launches, captured = capture_launches(
        mods, lambda: solver.solve_refined(q, method="delta"))
    log(f"[{phase}] {name} main path B={B} check_interval={K} ({tree.njoints} joints, "
        f"{tree.nv} dof, {len(links)} constraints): kernel launches {launches}")
    if launches != 2 or len(captured) != 2:
        raise AssertionError(f"expected 2 kernel launches, got {launches}")

    outcome_budget(res, eager.solve_refined(q, method="delta"), B, "eager")
    # certification honesty: recompute every task residual in float64 from (q, nu)
    certify(mods, tree, problem, links, q, res)

    ms_path = cuda_median_ms(torch, lambda: solver.solve_refined(q, method="delta"))
    ms_eager_path = cuda_median_ms(torch, lambda: eager.solve_refined(q, method="delta"),
                                   reps=3)
    log(f"    solve_refined: kernel path {ms_path:.3f} ms (median of 5), eager path "
        f"{ms_eager_path:.3f} ms (median of 3), CUDA events")
    host_split(mods, lambda: solver.solve_refined(q, method="delta"))

    # each stage's kernel against its plain version on the same inputs
    rep = stage_report(mods, captured)
    launch = fused_mod.fused_solve_loop

    # problems per block (8 lanes each): stage 1 again at other tiles; the
    # wrapper lowers a tile to what the block's shared memory holds
    tree_, params_, prob_, st_, bt = captured[0]
    tiles = {}
    for t in (2, 4, 8, 16, 32):
        fit = fused_mod.problems_per_block(tree_.nvs, len(links), torch.float32, t)
        if fit not in tiles:
            tiles[fit] = cuda_median_ms(torch, lambda: launch(tree_, params_, prob_, st_, t))
    log("    stage 1 by problems per block: "
        + ", ".join(f"{t}: {ms:.3f} ms" for t, ms in tiles.items()))

    # batch size: stage 1 again on the first n problems, with the longest
    # and the mean iteration count among them (the launch lasts as long as
    # its slowest problem)
    sizes = []
    for n in (B // 64, B // 8, B):
        prob_n, st_n = batch_prefix(torch, prob_, B, n), batch_prefix(torch, st_, B, n)
        its = launch(tree_, params_, prob_n, st_n, bt).iterations
        ms = cuda_median_ms(torch, lambda: launch(tree_, params_, prob_n, st_n, bt))
        sizes.append(f"{n}: {ms:.3f} ms (iterations max {int(its.max())}, "
                     f"mean {float(its.double().mean()):.2f})")
    log("    stage 1 by batch size: " + ", ".join(sizes))
    return kernels_entry(name, launches, rep)


def against_eager(mods, name, dtype, B, K, max_iter=200):
    """The kernel and the eager loop from the same initial state."""
    torch, lt, fused_mod, sm, _, _ = mods
    dev = torch.device("cuda")
    tree, _, problem, params, q = config(lt, torch, name, dtype, dev, B, K, max_iter)
    prob, st = initial_state(sm, tree, problem, params, q)
    ker = fused_mod.fused_solve_loop(tree, params, prob, st)
    ref = sm._solve_loop(tree, prob, params, st)
    for field in ("nu", "z", "w", "stfw"):     # padded dof slots stay zero
        x = getattr(ker, field)
        for i, k in enumerate(tree.nvs):
            if k < tree.nv_max and float(x[i, k:].abs().max()) != 0.0:
                raise AssertionError(f"{name}: {field}[{i}] writes a padded dof slot")
    return state_errors(torch, fused_mod._STATE_FIELDS, ker, ref), ref


def double_check(mods, phase, name, B, K):
    torch = mods[0]
    errs, ref = against_eager(mods, name, torch.float64, B, K)
    worst = max(rel for _, rel in errs.values())
    log(f"[{phase}] {name} f64 B={B} K={K}: worst abs-or-rel {worst:.3e}, "
        f"mean iterations {ref.iterations.double().mean():.2f}")
    if worst > 1e-9:
        raise AssertionError(f"f64 kernel vs eager {name} K={K}: {errs}")


def float_lockstep(mods, phase, name, B):
    torch = mods[0]
    for mi in (1, 2, 3):
        errs, _ = against_eager(mods, name, torch.float32, B, 1, max_iter=mi)
        log(f"[{phase}] {name} f32 B={B} max_iter={mi}: "
            + ", ".join(f"{k} {rel:.1e}" for k, (_, rel) in errs.items()))
        if max(rel for _, rel in errs.values()) > 1e-4:
            raise AssertionError(f"f32 lockstep {name} max_iter={mi}: {errs}")


def mixed_setup(lt, torch, dtype, Bg, check_interval, max_iter=200, device="cuda"):
    """Bg UR5 + Bg panda_arm as one padded super-batch: the prepared
    `MixedPadded`, the groups [(tree, seeded q, problem)] and the params.
    Each problem: one 6-D end-effector constraint, v_z = 0.2, box = the
    model's velocity limits capped at 4."""
    dev = torch.device(device)
    ds = str(dtype).removeprefix("torch.")
    gen = torch.Generator(device=dev).manual_seed(0)
    groups = []
    for robot in ("ur5", "panda_arm"):
        tree = lt.robots.get(robot, ds, device=dev)
        vl = torch.clamp(tree.velocity_limit, max=4.0)
        problem = lt.make_problem(
            tree, (tree.njoints - 1,), lb=-vl, ub=vl,
            b=torch.tensor([[0.0, 0.0, 0.2, 0.0, 0.0, 0.0]], dtype=dtype))
        groups.append((tree, tree.random_configuration((Bg,), generator=gen), problem))
    params = lt.SolverParams(
        max_iter=max_iter, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
        mu_equality_scale_factor=1e5, tail_solve=False,
        check_interval=check_interval,
    )
    mp = lt.parallel.prepare_mixed_padded([(t, Bg, p) for t, _, p in groups])
    return mp, groups, params


def mixed_against_eager(mods, dtype, Bg, K, max_iter=200):
    """The kernel on per-problem subspaces against the eager loop on the
    same `S_all`, and against the eager loop that derives S from the batched
    axis leaf, from the same initial state on the mixed chain."""
    torch, lt, fused_mod, sm, _, _ = mods
    mp, groups, params = mixed_setup(lt, torch, dtype, Bg, K, max_iter)
    q = mp.pack_q([q for _, q, _ in groups])
    prob, st = initial_state(sm, mp.chain, mp.problem, params, q)
    prob_S = fused_mod.with_S_all(mp.chain, prob, dtype)
    ker = fused_mod.fused_solve_loop(mp.chain, params, prob_S, st)
    ref = sm._solve_loop(mp.chain, prob_S, params, st)
    for field in ("nu", "z", "w", "stfw"):     # the padded joint of the UR5 rows
        for i, n in enumerate(mp.group_njoints):
            rows = slice(sum(mp.group_sizes[:i]), sum(mp.group_sizes[:i + 1]))
            if float(getattr(ker, field)[n:, :, rows].abs().sum()) != 0.0:
                raise AssertionError(f"mixed: {field} of a padded joint is not zero")
    in_loop = sm._solve_loop(mp.chain, prob, params, st)
    for name in fused_mod._STATE_FIELDS:
        if not torch.equal(getattr(ref, name), getattr(in_loop, name)):
            raise AssertionError(f"eager loop: S_all and in-loop S differ in {name}")
    return state_errors(torch, fused_mod._STATE_FIELDS, ker, ref), ref


def subspaces_check(mods, phase):
    """Phase 9: the per-problem-subspace instantiation against the eager
    loop, and against the shared-S instantiation on the flagship's inputs."""
    torch, lt, fused_mod, sm, _, _ = mods
    for K in (1, 4):
        errs, ref = mixed_against_eager(mods, torch.float64, 512, K)
        worst = max(rel for _, rel in errs.values())
        log(f"[{phase}] mixed f64 B={ref.iterations.shape[0]} K={K}: worst abs-or-rel {worst:.3e}, "
            f"mean iterations {ref.iterations.double().mean():.2f}, padded dofs zero")
        if worst > 1e-9:
            raise AssertionError(f"f64 kernel vs eager mixed K={K}: {errs}")
    for Bg in (512, 8192):
        for mi in (1, 2, 3):
            errs, _ = mixed_against_eager(mods, torch.float32, Bg, 1, max_iter=mi)
            log(f"[{phase}] mixed f32 B={2 * Bg} max_iter={mi}: "
                + ", ".join(f"{k} {rel:.1e}" for k, (_, rel) in errs.items()))
            if max(rel for _, rel in errs.values()) > 1e-4:
                raise AssertionError(f"f32 lockstep mixed max_iter={mi}: {errs}")

    # panda_arm: its shared S broadcast to S_all must give the shared-S bits
    B, K = PATHS["flagship"]["B"], PATHS["flagship"]["K"]
    tree, _, problem, params, q = config(lt, torch, "flagship", torch.float32,
                                         torch.device("cuda"), B, K)
    prob, st = initial_state(sm, tree, problem, params, q)
    S = fused_mod._subspace_operand(tree, torch.float32)           # (N, 6, 1)
    prob_S = dataclasses.replace(
        prob, S_all=S[..., None].expand(S.shape + (B,)).contiguous())
    shared = fused_mod.fused_solve_loop(tree, params, prob, st)
    per_problem = fused_mod.fused_solve_loop(tree, params, prob_S, st)
    for name in fused_mod._STATE_FIELDS:
        if not torch.equal(getattr(shared, name), getattr(per_problem, name)):
            raise AssertionError(f"panda_arm: S_all and shared S differ in {name}")
    ms = [kernel_device_ms(torch, lambda p=p: fused_mod.fused_solve_loop(tree, params, p, st))
          for p in (prob, prob_S, prob_S, prob)]
    log(f"[{phase}] panda_arm B={B} K={K} through S_all equals shared S on every field; "
        "kernel alone for one cold solve to tol 1e-6 (max_iter 200), shared / S_all / "
        "S_all / shared: "
        + " / ".join("not measured" if m is None else f"{m:.3f}" for m in ms) + " ms")


def mixed_path(mods, phase):
    """Phase 10: the mixed super-batch main path."""
    torch, lt, fused_mod, sm, rf, _ = mods
    B, K = PATHS["mixed"]["B"], PATHS["mixed"]["K"]
    mp, groups, params = mixed_setup(lt, torch, torch.float32, B // 2, K)
    qs = [q for _, q, _ in groups]

    def delta(fused):
        return lambda t, p, q, pr: rf.solve_delta_duals(t, p, q, pr, fused=fused)

    res, launches, captured = capture_launches(
        mods, lambda: mp.solve_packed(params, qs, solve_fn=delta("require")))
    fleet = " + ".join(f"{b} {t.name}" for (t, _, _), b in zip(groups, mp.group_sizes))
    log(f"[{phase}] mixed main path B={B} ({fleet}) check_interval={K} (padded chain "
        f"of {mp.chain.njoints} joints): kernel launches {launches}")
    if launches != 2 or len(captured) != 2:
        raise AssertionError(f"expected 2 kernel launches, got {launches}")
    if any(c[2].S_all is None for c in captured):
        raise AssertionError("a stage ran without per-problem subspaces")
    if float(res.nu[:B // 2, 6:].abs().sum()) != 0.0:
        raise AssertionError("a padded dof of the super-batch is not zero")

    outcome_budget(res, mp.solve_packed(params, qs, solve_fn=delta(False)), B, "eager")
    # the embedding is right if each group's result solves the group's own
    # problem on its own unpadded tree
    per_group = mp.unpack(res)
    for (tree, q, problem), rg in zip(groups, per_group):
        certify(mods, tree, problem, problem.constraint_links, q, rg,
                label=f"{tree.name} on its own tree: ")
    # one kernel solve per topology: the same optimum by another iterate path
    # (the padded link adds its own proximal term), so no equal counts
    alone = lt.parallel.solve_mixed(groups, params, solve_fn=delta("require"))
    for (tree, _, _), rg, ra in zip(groups, per_group, alone):
        outcome_budget(rg, ra, B // 2, f"solve_mixed ({tree.name} alone)", it_frac=None)

    ms_path = cuda_median_ms(torch, lambda: mp.solve_packed(params, qs, solve_fn=delta("require")))
    ms_eager = cuda_median_ms(torch, lambda: mp.solve_packed(params, qs, solve_fn=delta(False)),
                              reps=3)
    ms_groups = cuda_median_ms(
        torch, lambda: lt.parallel.solve_mixed(groups, params, solve_fn=delta("require")))
    log(f"    solve_packed: kernel path {ms_path:.3f} ms (median of 5), eager path "
        f"{ms_eager:.3f} ms (median of 3), solve_mixed (two kernel solves) "
        f"{ms_groups:.3f} ms, CUDA events")
    host_split(mods, lambda: mp.solve_packed(params, qs, solve_fn=delta("require")))
    rep = stage_report(mods, captured)

    # R staged super-batches back to back, nothing read between them
    R = 20
    gen = torch.Generator(device="cuda").manual_seed(1)
    q_packed = mp.pack_q_stacked(
        [t.random_configuration((R, B // 2), generator=gen) for t, _, _ in groups])
    scan = lambda: mp.solve_scan(params, q_packed=q_packed, solve_fn=delta("require"),
                                 light=True)
    fused_mod.LAUNCHES = 0
    (conv, _), syncs = count_syncs(torch, scan)
    torch.cuda.synchronize()
    if fused_mod.LAUNCHES != 2 * R:
        raise AssertionError(f"solve_scan: {fused_mod.LAUNCHES} launches for {R} reps")
    ms_scan = cuda_median_ms(torch, scan, reps=3) / R
    log(f"    solve_scan(q_packed, light) over {R} reps: {ms_scan:.3f} ms per rep, "
        f"{2 * R} launches, host synchronisations {len(syncs)}, converged "
        f"{float(conv.double().mean()):.4f}")
    if syncs:
        raise AssertionError("solve_scan synchronises the host: " + "; ".join(syncs[:5]))

    # once more at 8192 + 8192, so that there is kernel time to read
    big_B = 16384
    mp2, groups2, _ = mixed_setup(lt, torch, torch.float32, big_B // 2, K)
    qs2 = [q for _, q, _ in groups2]
    res2, launches2, captured2 = capture_launches(
        mods, lambda: mp2.solve_packed(params, qs2, solve_fn=delta("require")))
    ms2 = cuda_median_ms(torch, lambda: mp2.solve_packed(params, qs2, solve_fn=delta("require")))
    log(f"    B={big_B}: solve_packed {ms2:.3f} ms, launches {launches2}, converged "
        f"{float(res2.converged.double().mean()):.4f}, mean iterations "
        f"{float(res2.iterations.double().mean()):.2f}")
    stage_report(mods, captured2, eager_reps=1)
    return kernels_entry("mixed", launches, rep)


def count_syncs(torch, fn):
    """fn() under torch's sync debug mode: (fn's result, one line per
    operation that made the host wait for the device)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
                 if "synchronizing CUDA operation" in str(w.message)]


def tracking_path(mods, phase):
    """Phase 11: warm-started tracking through `DiffIkSolver`."""
    torch, lt, fused_mod, sm, _, _ = mods

    dev = torch.device("cuda")
    T, tol = TRACKING["T"], TRACKING["tol"]
    launch = fused_mod.fused_solve_loop

    def make(B, fused):
        tree, links, problem, params, q = config(lt, torch, "flagship", torch.float32,
                                                 dev, B, 1)
        params = params.replace(tol_abs=tol, tol_rel=tol, warm_start=True)
        return (lt.DiffIkSolver(tree, params, links, problem=problem, fused=fused),
                tree, links, problem, q)

    def sweep(n):
        b_seq = torch.zeros((n, 6), dtype=torch.float32, device=dev)
        b_seq[:, 2] = 0.2 * torch.cos(2 * torch.pi * torch.arange(n, device=dev) / n)
        return b_seq

    # the instrument first: a read of a device value must be counted
    if not count_syncs(torch, lambda: torch.ones(1, device=dev).item())[1]:
        raise AssertionError("torch's sync debug mode does not report a .item()")

    # ---- track_scan = eager ticks = calls of solve_tracking, T=10, B=1024
    n, B = 10, 1024
    kern, _, links, _, q = make(B, "require")
    ee = links[0]
    fused_mod.LAUNCHES = 0
    got = kern.track_scan(q, sweep(n))
    torch.cuda.synchronize()
    if fused_mod.LAUNCHES != n:
        raise AssertionError(f"track_scan: {fused_mod.LAUNCHES} launches for {n} ticks")
    want = make(B, False)[0].track_scan(q, sweep(n))
    errs = state_errors(torch, fused_mod._STATE_FIELDS, got.state, want.state)
    ticker = make(B, "require")[0]
    ticks = [ticker.solve_tracking(q, ee, b=b) for b in sweep(n)]
    for name in ("nu", "converged", "iterations", "primal_residual", "dual_residual"):
        a = getattr(got, name)
        if not torch.equal(a, getattr(want, name)):
            raise AssertionError(f"track_scan: kernel and eager ticks differ in {name}")
        if not torch.equal(a, torch.stack([getattr(r, name) for r in ticks])):
            raise AssertionError(f"track_scan and solve_tracking differ in {name}")
    worst = max(a for a, _ in errs.values())
    log(f"[{phase}] track_scan T={n} B={B}: equals {n} eager ticks (final state max abs "
        f"err {worst:.1e}) and {n} calls of solve_tracking; mean iterations per tick "
        + " ".join(f"{x:.1f}" for x in got.iterations.double().mean(1).tolist()))
    if worst != 0.0:
        raise AssertionError(f"tracking: kernel ticks against eager ticks: {errs}")

    entries = []
    for B in TRACKING["fleets"]:
        solver, tree, links, problem, q = make(B, "require")
        ee = links[0]
        for _ in range(TRACKING["settle"]):             # settle the duals
            solver.solve_tracking(q, ee, b=problem.b[0])
        b_seq = sweep(T)
        solver.track_scan(q, b_seq)                      # warm-up stream
        torch.cuda.synchronize()

        # the timed stream: launches, host synchronisations, CUDA events
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

        def timed():
            start.record()
            t0 = time.perf_counter()
            out = solver.track_scan(q, b_seq)
            host = (time.perf_counter() - t0) * 1e3
            end.record()
            return out, host

        fused_mod.LAUNCHES = 0
        (stream, host_ms), syncs = count_syncs(torch, timed)
        end.synchronize()
        launches = fused_mod.LAUNCHES
        tick_ms = start.elapsed_time(end) / T
        log(f"[{phase}] tracking B={B} T={T} tol {tol:g}: {launches} launches, host "
            f"synchronisations {len(syncs)}, {tick_ms:.4f} ms per tick (CUDA events "
            f"around the stream), host enqueue {host_ms / T:.4f} ms per tick")
        if launches != T:
            raise AssertionError(f"expected {T} launches, got {launches}")
        if syncs:
            raise AssertionError("the stream synchronises the host: " + "; ".join(syncs[:5]))

        # what came out: the last tick in float64, on the tree
        conv = stream.converged[-1]
        nu64 = stream.nu[-1].double()[conv]
        v = link_velocities(sm, mods[5], tree.astype(torch.float64), q.double()[conv], nu64)
        task = float((v[ee] - b_seq[-1].double()).abs().max())
        at_cap = float((stream.iterations >= solver.params.max_iter - 1).double().mean())
        log(f"    converged fraction {float(stream.converged.double().mean()):.4f} "
            f"(last tick {float(conv.double().mean()):.4f}), mean warm iterations "
            f"{float(stream.iterations.double().mean()):.2f} (max "
            f"{int(stream.iterations.max())}; share of (tick, problem) pairs that run "
            f"to the iteration cap {at_cap:.5f}), f64 task residual of the last "
            f"tick's converged problems {task:.3e}")
        if not (task <= 1e-3 and bool(torch.isfinite(stream.nu).all())):
            raise AssertionError("tracking: a converged problem misses its target")

        # synchronous per-tick latency through solve_tracking
        lat = []
        for b in b_seq:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.solve_tracking(q, ee, b=b)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        log(f"    solve_tracking, synchronous: p50 {statistics.median(lat):.4f} ms, "
            f"p90 {statistics.quantiles(lat, n=10)[-1]:.4f} ms per tick (host clock)")

        # one stream on the profiler: the kernel alone, device busy, idle share
        alone = idle_report("stream", profiled(torch, lambda: solver.track_scan(q, b_seq)), T)

        # the ticks of one more stream recorded: every launch again, timed,
        # with its bound (the ticks differ: one lasts as long as its slowest
        # problem); then kernel against plain version on three of them
        _, _, captured = capture_launches(mods, lambda: solver.track_scan(q, b_seq))
        nbytes = ops = 0
        call_ms = []
        for tree_, params_, prob_, st_, bt in captured:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = launch(tree_, params_, prob_, st_, bt)
            end.record()
            end.synchronize()
            call_ms.append(start.elapsed_time(end))
            nb, op = loop_bound(fused_mod, tree_, params_, prob_, st_, out)
            nbytes, ops = nbytes + nb, ops + op
        rep = stage_report(mods, [captured[0], captured[T // 2], captured[-1]], eager_reps=1,
                           what="tick")
        b_ms, b_by = bound_ms(nbytes / T, ops / T)
        log(f"    per tick: fused_solve_loop mean {statistics.mean(call_ms):.4f} ms over the "
            f"{T} ticks (min {min(call_ms):.4f}, max {max(call_ms):.4f}), eager loop "
            f"{rep['plain_ms'] / 3:.3f} ms (mean of the three ticks above); bound "
            f"{b_ms:.5f} ms per tick by {b_by}")
        entries.append({
            "name": f"fused_admm/tracking_B{B}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches, "max_abs_err": rep["err"],
            "ms": statistics.mean(call_ms), "plain_ms": rep["plain_ms"] / 3,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "kernel_alone_ms": alone, "stream_ms_per_tick": tick_ms,
        })
    return entries


def check_ranked(mods, tree, problem, links, batches, n_conv, k):
    """Every multistart batch: ranked, inf past num_converged, each finite
    slot's float64 task residual recomputed from (q, nu) at most 1e-5 and
    equal to its error within 1e-5."""
    torch, sm, bsp = mods[0], mods[3], mods[5]
    worst = worst_gap = 0.0
    tree64 = tree.astype(torch.float64)
    for r, nc in zip(batches, n_conv):
        err = r.error.double()
        fin = torch.isfinite(err)
        if int(fin.sum()) != min(k, nc) or not bool((err[1:] >= err[:-1]).all()):
            raise AssertionError("multistart: slots not ranked or not inf past num_converged")
        v = link_velocities(sm, bsp, tree64, r.q.double()[fin], r.nu.double()[fin])
        task = (v[links[0]] @ problem.A[0].double().T - problem.b[0].double()).abs().amax(-1)
        worst = max(worst, float(task.max()))
        worst_gap = max(worst_gap, float((task - err[fin]).abs().max()))
    log(f"    finite slots: f64 task residual max {worst:.3e}, |residual - error| max "
        f"{worst_gap:.3e}; best error of the last batch {float(batches[-1].error[0]):.3e}")
    if not (worst <= 1e-5 and worst_gap <= 1e-5):
        raise AssertionError("multistart: a ranked seed misses its task")


def multistart_path(mods, phase):
    """Phase 12: multistart over >= 1e5 seeds with the delta-duals solve_fn."""
    torch, lt, _, _, rf, _ = mods
    B, k = MULTISTART["B"], MULTISTART["k"]
    n_batches = -(-MULTISTART["seeds"] // B)
    dev = torch.device("cuda")
    tree, links, problem, params, _ = config(lt, torch, "flagship", torch.float32, dev, B,
                                             PATHS["flagship"]["K"])

    def delta(fused):
        return lambda t, p, q, pr: rf.solve_delta_duals(
            t, p, q, pr, stage1_max_iter=MULTISTART["stage1_max_iter"], fused=fused)

    gen = torch.Generator(device=dev).manual_seed(0)
    batches, launches, captured = capture_launches(mods, lambda: [
        lt.parallel.solve_multistart(tree, params, problem, gen, B, solve_fn=delta("require"),
                                     k=k) for _ in range(n_batches)])
    n_conv = [int(r.num_converged) for r in batches]
    log(f"[{phase}] multistart {n_batches} x {B} seeds (panda_arm, check_interval "
        f"{params.check_interval}, top {k}): kernel launches {launches}, converged seeds per "
        f"batch {n_conv} (fraction {sum(n_conv) / (n_batches * B):.4f})")
    if launches != 2 * n_batches or len(captured) != 2 * n_batches:
        raise AssertionError(f"expected {2 * n_batches} kernel launches, got {launches}")

    check_ranked(mods, tree, problem, links, batches, n_conv, k)

    # the first batch's seeds again: a prefix, kernel against eager
    n = MULTISTART["prefix"]
    qs = tree.random_configuration((B,), generator=torch.Generator(device=dev).manual_seed(0))[:n]
    res_k = lt.parallel.multistart_from_configs(tree, params, problem, qs, k, delta("require"))
    res_e = lt.parallel.multistart_from_configs(tree, params, problem, qs, k, delta(False))
    outcome_budget(res_k.result, res_e.result, n, f"eager ({n}-seed prefix)")
    if not torch.equal(res_k.result.nu, batches[0].result.nu[:n]):
        raise AssertionError("multistart: the prefix's solutions differ from the batch's")

    ms = cuda_median_ms(torch, lambda: lt.parallel.solve_multistart(
        tree, params, problem, gen, B, solve_fn=delta("require"), k=k))
    alone = kernel_device_ms(torch, lambda: lt.parallel.solve_multistart(
        tree, params, problem, gen, B, solve_fn=delta("require"), k=k))
    log(f"    {ms:.3f} ms per batch of {B} (CUDA events, median of 5): "
        f"{B / ms * 1e3:.0f} seeds/s, every seed counted; kernel alone "
        f"{'not measured' if alone is None else f'{alone:.3f} ms'} per batch")
    rep = stage_report(mods, captured[:2])
    entry = kernels_entry("multistart", launches, rep)
    entry["seeds_per_s"] = B / ms * 1e3
    return entry


def clik_inputs(lt, torch, B):
    """(tree, q0, target R, target p, link): float32 panda_arm from its
    neutral configuration to FK of neutral moved by CLIK["spread"] N(0, 1)
    tangent steps, seeded on the card (examples/07_position_ik.py's task)."""
    dev = torch.device("cuda")
    tree = lt.robots.panda_arm("float32", device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    dq = CLIK["spread"] * torch.randn((B, tree.nv), generator=gen, dtype=torch.float32,
                                      device=dev)
    q0 = tree.neutral().expand(B, tree.nq).contiguous()
    ee = tree.njoints - 1
    _, _, oR, op = tree.fwd_kinematics(tree.integrate(q0, dq))
    return tree, q0, oR[:, ee].contiguous(), op[:, ee].contiguous(), ee


def clik_path(mods, phase):
    """Phase 13: closed-loop position IK through `DiffIkSolver.reach`."""
    torch, lt, fused_mod, sm, _, _ = mods

    B, T = CLIK["B"], CLIK["steps"]
    tree, q0, tR, tp, ee = clik_inputs(lt, torch, B)
    params = lt.SolverParams(max_iter=CLIK["max_iter"], tol_abs=CLIK["tol"],
                             tol_rel=CLIK["tol"], check_interval=1)
    run = dict(dt=CLIK["dt"], gain=CLIK["gain"])
    solver = lt.DiffIkSolver(tree, params, (ee,), fused="require")
    eager = lt.DiffIkSolver(tree, params, (ee,), fused=False)
    launch = fused_mod.fused_solve_loop

    # the main path: launches and host synchronisations over the tick loop
    solver.reach(q0[:8], tR[:8], tp[:8], steps=2, **run)      # the build, off the count
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed():
        start.record()
        t0 = time.perf_counter()
        out = solver.reach(q0, tR, tp, steps=T, **run)
        host = (time.perf_counter() - t0) * 1e3
        end.record()
        return out, host

    fused_mod.LAUNCHES = 0
    (res, host_ms), syncs = count_syncs(torch, timed)
    end.synchronize()
    launches = fused_mod.LAUNCHES
    tick_ms = start.elapsed_time(end) / T
    log(f"[{phase}] clik reach B={B} T={T} tol {CLIK['tol']:g} (panda_arm, dt {run['dt']}, "
        f"gain {run['gain']}): {launches} launches, host synchronisations {len(syncs)}, "
        f"{tick_ms:.4f} ms per tick (CUDA events around the run), host enqueue "
        f"{host_ms / T:.4f} ms per tick")
    if launches != T:
        raise AssertionError(f"expected {T} launches, got {launches}")
    if syncs:
        raise AssertionError("the tick loop synchronises the host: " + "; ".join(syncs[:5]))

    # what came out: pose errors against a float64 FK of the returned q
    tree64 = tree.astype(torch.float64)
    _, _, oR, op = tree64.fwd_kinematics(res.q.double())
    Ri, pi = lt.spatial.se3_inverse(oR[:, ee], op[:, ee])
    e64 = lt.spatial.se3_log(*lt.spatial.se3_compose(Ri, pi, tR.double(), tp.double()))
    gap = max(float((res.pos_err.double() - e64[:, :3].norm(dim=-1)).abs().max()),
              float((res.rot_err.double() - e64[:, 3:].norm(dim=-1)).abs().max()))
    qs = torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=torch.float64, device=res.pos_err.device)
    pq = [f"{x:.2e}" for x in torch.quantile(res.pos_err.double(), qs).tolist()]
    rq = [f"{x:.2e}" for x in torch.quantile(res.rot_err.double(), qs).tolist()]
    hist = res.err_history.amax(-1)
    log(f"    reached {float(res.reached.double().mean()):.4f} (pos_tol 1e-4, rot_tol 1e-3); "
        f"float32 pose-error floor: pos_err p50/p90/p99/max {'/'.join(pq)} m, rot_err "
        f"{'/'.join(rq)} rad; batch max |err| per tick "
        + " -> ".join(f"{float(hist[t]):.1e}" for t in (0, T // 8, T // 4, T // 2, T - 1))
        + f"; last tick converged {float(res.converged.double().mean()):.4f}, mean "
        f"iterations {float(res.iterations.double().mean()):.2f}; |pos/rot err - float64 FK| "
        f"max {gap:.3e}")
    if gap > 1e-5 or not bool(torch.isfinite(res.q).all()):
        raise AssertionError("clik: the reported pose error disagrees with a float64 FK")

    # the kernel path against the eager path on a prefix: every field after
    # 10 ticks (B=1024), and the reached fraction after all T (B=64: every
    # eager tick with a problem at the iteration cap costs about a second)
    for steps, n in ((CLIK["short"], CLIK["prefix"]), (T, CLIK["reached_prefix"])):
        got = solver.reach(q0[:n], tR[:n], tp[:n], steps=steps, **run)
        want = eager.reach(q0[:n], tR[:n], tp[:n], steps=steps, **run)
        errs = state_errors(torch, ("q", "nu", "err_history", "pos_err", "rot_err", "reached",
                                    "converged", "iterations"), got, want)
        errs.update(state_errors(torch, fused_mod._STATE_FIELDS, got.state, want.state))
        worst = max(rel for _, rel in errs.values())
        r_k, r_e = float(got.reached.double().mean()), float(want.reached.double().mean())
        log(f"    B={n} T={steps}: kernel against eager, worst abs-or-rel {worst:.3e}; reached "
            f"{r_k:.4f} (eager {r_e:.4f})")
        if worst > 1e-4 or r_k < r_e - 0.01:
            raise AssertionError(f"clik: kernel path against eager path after {steps} ticks")

    # one run on the profiler: the kernel alone per tick, the device's idle share
    alone = idle_report("run", profiled(torch, lambda: solver.reach(q0, tR, tp, steps=T, **run)),
                        T)

    # every launch of one run again, timed, with its bound; kernel against
    # plain version on the last tick
    _, _, captured = capture_launches(mods, lambda: solver.reach(q0, tR, tp, steps=T, **run))
    nbytes = ops = 0
    call_ms = []
    for tree_, params_, prob_, st_, bt in captured:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = launch(tree_, params_, prob_, st_, bt)
        end.record()
        end.synchronize()
        call_ms.append(start.elapsed_time(end))
        nb, op_ = loop_bound(fused_mod, tree_, params_, prob_, st_, out)
        nbytes, ops = nbytes + nb, ops + op_
    rep = stage_report(mods, [captured[-1]], eager_reps=1, what="last tick")
    b_ms, b_by = bound_ms(nbytes / T, ops / T)
    log(f"    per tick: fused_solve_loop mean {statistics.mean(call_ms):.4f} ms (min "
        f"{min(call_ms):.4f}, max {max(call_ms):.4f}), eager loop {rep['plain_ms']:.3f} ms "
        f"(the last tick); bound {b_ms:.5f} ms per tick by {b_by}")
    return {
        "name": "fused_admm/clik", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": rep["err"], "ms": statistics.mean(call_ms),
        "plain_ms": rep["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "kernel_alone_ms": alone, "run_ms_per_tick": tick_ms,
    }


class StageSplit:
    """Synced host-clock time of each `_solve_impl` call of a refinement, in
    call order (stage 1, stage 2)."""

    def __init__(self, torch, rf):
        self.torch, self.rf, self.ms = torch, rf, []

    def __enter__(self):
        self.fn = self.rf._solve_impl

        def wrapper(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.fn(*a, **kw)
            self.torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        self.rf._solve_impl = wrapper
        return self

    def __exit__(self, *exc):
        self.rf._solve_impl = self.fn


def two_stage_path(mods, phase):
    """Phase 14: the two-stage solve on the flagship's inputs (one launch),
    then on mobile_ur5 (no launch: q-dependent subspaces)."""
    import warnings

    torch, lt, fused_mod, sm, rf, _ = mods
    B, K = PATHS["flagship"]["B"], PATHS["flagship"]["K"]
    dev = torch.device("cuda")
    tree, links, problem, params, q = config(lt, torch, "flagship", torch.float32, dev, B, K)
    solver = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")
    kw = dict(method="two-stage", stage1_max_iter=TWO_STAGE["stage1_max_iter"],
              stage2_max_iter=TWO_STAGE["stage2_max_iter"])
    res, launches, captured = capture_launches(mods, lambda: solver.solve_refined(q, **kw))
    log(f"[{phase}] two-stage main path B={B} check_interval={K} (panda_arm, stage 1 cap "
        f"{kw['stage1_max_iter']}, stage 2 cap {kw['stage2_max_iter']}): kernel launches "
        f"{launches}, nu {res.nu.dtype}")
    if launches != 1 or len(captured) != 1:
        raise AssertionError(f"expected 1 kernel launch, got {launches}")
    certify(mods, tree, problem, links, q, res)
    delta = solver.solve_refined(q, method="delta")
    ms = cuda_median_ms(torch, lambda: solver.solve_refined(q, **kw))
    ms_delta = cuda_median_ms(torch, lambda: solver.solve_refined(q, method="delta"))
    with StageSplit(torch, rf) as split:
        solver.solve_refined(q, **kw)
    log(f"    converged {float(res.converged.double().mean()):.4f} (delta path "
        f"{float(delta.converged.double().mean()):.4f}); solve_refined {ms:.3f} ms (delta "
        f"path {ms_delta:.3f} ms), CUDA events, median of 5; synced split: stage 1 (FK, "
        f"prepare, kernel) {split.ms[0]:.3f} ms, stage 2 (float64 eager loop) "
        f"{split.ms[1]:.3f} ms")
    rep = stage_report(mods, captured)

    # a tree the kernel cannot take: the eager two-stage path, silently
    Bm = TWO_STAGE["mobile_B"]
    mtree = lt.robots.mobile_ur5("float32", device=dev)
    mlinks = (mtree.joint_names.index("wrist_3_joint"),)
    mproblem = lt.make_problem(
        mtree, mlinks, b=torch.tensor([[0.0, 0.0, 0.2, 0.0, 0.0, 0.0]]),
        lb=-4.0 * torch.ones(mtree.nv), ub=4.0 * torch.ones(mtree.nv))
    mq = mtree.random_configuration((Bm,), generator=torch.Generator(device=dev).manual_seed(0))
    msolver = lt.DiffIkSolver(mtree, params, mlinks, problem=mproblem)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mres, mlaunches, _ = capture_launches(mods, lambda: msolver.solve_refined(mq))
    noisy = [str(w.message) for w in caught if "fused" in str(w.message)]
    t0 = time.perf_counter()
    msolver.solve_refined(mq)
    torch.cuda.synchronize()
    m_ms = (time.perf_counter() - t0) * 1e3
    log(f"    mobile_ur5 B={Bm} ({mtree.njoints} joints, {mtree.nv} dof, q-dependent S): "
        f"solve_refined() took the two-stage path with {mlaunches} launches and "
        f"{len(noisy)} kernel warnings, {m_ms:.1f} ms (host clock, synced)")
    if mlaunches or noisy:
        raise AssertionError(f"mobile_ur5: {mlaunches} launches, warnings {noisy}")
    certify(mods, mtree, mproblem, mlinks, mq, mres, label="mobile_ur5: ")
    return kernels_entry("two_stage", launches, rep)


def unrolled_path(mods, phase):
    """Phase 15: the differentiable solve (`solve_unrolled`, the eager body
    under autograd with a checkpoint per call) on the card."""
    torch, lt, fused_mod, sm, _, _ = mods
    B, n, B2 = UNROLLED["B"], UNROLLED["num_iters"], UNROLLED["B_second"]
    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64

    def setup(dtype, B):
        tree, links, problem, params, q = config(lt, torch, "flagship", dtype, dev, B, 1)
        return tree, problem, params, q

    def with_bz(problem, bz):
        """The problem with b[0, 2] = bz, a 0-d tensor (differentiable); the
        mask is made on the device (an element assignment would copy from
        the host)."""
        mask = (torch.arange(6, device=dev) == 2).to(problem.b.dtype)
        return problem.replace(b=problem.b * (1 - mask) + bz * mask)

    def loss(tree, params, q, problem, bz):
        res = lt.solve_unrolled(tree, params, q, with_bz(problem, bz), num_iters=n)
        return (res.nu ** 2).sum()

    def grad_bz(tree, params, q, problem, bz0, create_graph=False):
        bz = torch.tensor(bz0, dtype=q.dtype, device=dev, requires_grad=True)
        g, = torch.autograd.grad(loss(tree, params, q, problem, bz), bz,
                                 create_graph=create_graph)
        return g, bz

    # ---- forward parity in float64: the while loop with the same budget
    tree, problem, params, q = setup(f64, B)
    fused_mod.LAUNCHES = 0
    res_u = lt.solve_unrolled(tree, params, q, problem, num_iters=n)
    torch.cuda.synchronize()
    launches = fused_mod.LAUNCHES
    # max_iter n + 1 runs at most n iterations, as n body calls do
    res_w = lt.solve(tree, params.replace(max_iter=n + 1), q, problem)
    both = res_u.converged & res_w.converged
    nu_err = float((res_u.nu - res_w.nu)[both].abs().max())
    flags = int((res_u.converged != res_w.converged).sum())
    log(f"[{phase}] solve_unrolled panda_arm B={B} num_iters={n} check_interval 1 f64: "
        f"{launches} kernel launches; converged {float(res_u.converged.double().mean()):.4f}; "
        f"against solve (max_iter {n + 1}): nu max |diff| {nu_err:.3e} on the "
        f"{int(both.sum())} problems both converged, converged flags differ on {flags}")
    if launches or not (nu_err <= 1e-8 and flags == 0):
        raise AssertionError("solve_unrolled: forward parity against solve not met")

    # ---- first derivatives against central differences, float64
    bz0 = 0.2
    g, _ = grad_bz(tree, params, q, problem, bz0)
    with torch.no_grad():
        eps = 1e-5
        fd = (loss(tree, params, q, problem, torch.tensor(bz0 + eps, dtype=f64, device=dev))
              - loss(tree, params, q, problem, torch.tensor(bz0 - eps, dtype=f64, device=dev))
              ) / (2 * eps)
    bz_c = torch.tensor(bz0, dtype=f64, device=dev)
    log(f"    d loss/d b_z {float(g):.12e}, central difference (eps 1e-5) {float(fd):.12e}, "
        f"rel gap {abs(float(g - fd)) / abs(float(fd)):.3e} (bound 1e-4)")
    if not abs(float(g - fd)) <= 1e-4 * abs(float(fd)):
        raise AssertionError("d loss/d b_z misses its central difference")
    qg = q.clone().requires_grad_(True)
    gq, = torch.autograd.grad(loss(tree, params, qg, problem, bz_c), qg)
    eps = 1e-6
    for bi, ji in ((0, 1), (B // 2, 4)):
        dq = torch.zeros_like(q)
        dq[bi, ji] = eps
        with torch.no_grad():
            fdq = (loss(tree, params, q + dq, problem, bz_c)
                   - loss(tree, params, q - dq, problem, bz_c)) / (2 * eps)
        gap = abs(float(gq[bi, ji] - fdq))
        log(f"    d loss/d q[{bi}, {ji}] {float(gq[bi, ji]):.12e}, central difference "
            f"(eps 1e-6) {float(fdq):.12e}, gap {gap:.3e} (bound 1e-8 + 5e-4 x |fd|)")
        if not gap <= 1e-8 + 5e-4 * abs(float(fdq)):
            raise AssertionError(f"d loss/d q[{bi}, {ji}] misses its central difference")
    if not bool(torch.isfinite(gq).all()):
        raise AssertionError("d loss/d q is not finite")

    # ---- the second derivative, B2 problems
    tree2, problem2, params2, q2 = setup(f64, B2)
    g2, bz = grad_bz(tree2, params2, q2, problem2, bz0, create_graph=True)
    h, = torch.autograd.grad(g2, bz)
    eps = 1e-5
    fdh = (grad_bz(tree2, params2, q2, problem2, bz0 + eps)[0]
           - grad_bz(tree2, params2, q2, problem2, bz0 - eps)[0]) / (2 * eps)
    gap = abs(float(h - fdh)) / abs(float(fdh))
    log(f"    B={B2}: d2 loss/d b_z2 {float(h):.10e}, central difference of the first "
        f"derivative (eps 1e-5) {float(fdh):.10e}, rel gap {gap:.3e} (bound 1e-4)")
    if not gap <= 1e-4:
        raise AssertionError("the second derivative misses its central difference")

    # ---- float32 against float64
    t32, p32, pr32, q32 = setup(f32, B)
    g32, _ = grad_bz(t32, pr32, q32, p32, bz0)
    rel32 = abs(float(g32.double() - g)) / abs(float(g))
    log(f"    float32 d loss/d b_z {float(g32):.8e}, relative gap to float64 {rel32:.3e} "
        f"(bound {UNROLLED['f32_rel_bound']:g})")
    if not (bool(torch.isfinite(g32)) and rel32 <= UNROLLED["f32_rel_bound"]):
        raise AssertionError("float32 gradient not finite or too far from float64")

    # ---- timings and memory per dtype; host synchronisations of a forward
    for dtype, (t_, p_, pa_, q_) in ((f32, (t32, p32, pr32, q32)),
                                     (f64, (tree, problem, params, q))):
        bz = torch.tensor(bz0, dtype=dtype, device=dev, requires_grad=True)
        _, syncs = count_syncs(torch, lambda: loss(t_, pa_, q_, p_, bz))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fwd, step = [], []
        for rep in range(6):        # a warm-up, then 5 steps, each timed at
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()          # the end of its forward and of its backward
            value = loss(t_, pa_, q_, p_, bz)
            ev[1].record()
            torch.autograd.grad(value, bz)
            ev[2].record()
            ev[2].synchronize()
            if rep:
                fwd.append(ev[0].elapsed_time(ev[1]))
                step.append(ev[0].elapsed_time(ev[2]))
        peak = torch.cuda.max_memory_allocated() - base
        log(f"    {str(dtype).removeprefix('torch.')} B={B}: forward "
            f"{statistics.median(fwd):.3f} ms, forward + backward "
            f"{statistics.median(step):.3f} ms (CUDA events, median of 5 steps after a "
            f"warm-up), peak memory of a step {peak / 2**30:.3f} GiB above the inputs, "
            f"host synchronisations in a warm forward {len(syncs)}")
        if syncs:
            raise AssertionError("solve_unrolled synchronises the host: " + "; ".join(syncs[:5]))


def mirror_path(mods, phase):
    """Phase 16: per-iteration logging and `debug_mirror` held against the
    kernel at atol 0, the logging cost, `no_recompile_guard` and `trace`."""
    import tempfile

    torch, lt, fused_mod, sm, _, _ = mods
    from loik_tpu_torch.kernels.fused import solve_fused
    from loik_tpu_torch.utils import debug_mirror, no_recompile_guard, trace

    B, K = PATHS["flagship"]["B"], PATHS["flagship"]["K"]
    dev = torch.device("cuda")
    tree, links, problem, params, q = config(lt, torch, "flagship", torch.float32, dev, B, K)

    def last_logged_rp(mirror):
        rows = (mirror.iterations.long() - 1).clamp(min=0)
        return mirror.log_rp.gather(0, rows[None])[0]

    def mirrored(what, res, params_, problem_, warm=None, sample=None):
        t0 = time.perf_counter()
        m = debug_mirror(tree, params_, q, problem_, warm_state=warm, result=res,
                         sample=sample, atol=0.0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = res.primal_residual if sample is None else res.primal_residual[sample]
        ran = (m.iterations > 0)
        if not torch.equal(last_logged_rp(m)[ran], want[ran]):
            raise AssertionError(f"{what}: the last logged log_rp is not the reported residual")
        log(f"    {what}: debug_mirror(atol=0.0) passed on {m.iterations.shape[0]} problems "
            f"(flags, iterations, both residuals bit for bit; last log_rp = reported "
            f"residual), logs {tuple(m.log_rp.shape)}, {ms:.1f} ms (host clock, synced)")
        return m

    # ---- the kernel's history: flagship float32 solve_fused
    fused_mod.LAUNCHES = 0
    res = solve_fused(tree, params, q, problem)
    torch.cuda.synchronize()
    log(f"[{phase}] flagship solve_fused B={B} check_interval={K}: {fused_mod.LAUNCHES} "
        f"launch, mean iterations {float(res.iterations.double().mean()):.2f}")
    if fused_mod.LAUNCHES != 1:
        raise AssertionError("solve_fused did not launch the kernel once")
    mirrored("flagship", res, params, problem)
    longest = torch.topk(res.iterations, 64).indices
    mirrored("the 64 longest-running problems (sample=)", res, params, problem,
             sample=longest)

    # ---- a warm tracking tick
    tol = TRACKING["tol"]
    pw = params.replace(tol_abs=tol, tol_rel=tol, warm_start=True, check_interval=1)
    first = solve_fused(tree, pw, q, problem)
    tick = problem.update_constraint(0, b=problem.b[0] * torch.cos(
        torch.tensor(2 * torch.pi / TRACKING["T"], device=dev)))
    warm = solve_fused(tree, pw, q, tick, warm_state=first.state)
    mirrored("a warm tracking tick (tol 1e-4, check_interval 1)", warm, pw, tick,
             warm=first.state)

    # ---- the cost of logging on the eager loop, in turns (host-bound: the
    # eager loop's time moves by tens of percent from call to call)
    times = {False: [], True: []}
    for turn in range(4):
        for logging in ((False, True) if turn % 2 else (True, False)):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            lt.solve(tree, params.replace(logging=logging), q, problem)
            end.record()
            end.synchronize()
            times[logging].append(start.elapsed_time(end))
    plain_ms, logged_ms = (statistics.median(times[f][1:]) for f in (False, True))
    log(f"    eager solve B={B}, in turns after a warm-up of each: "
        f"{plain_ms:.3f} ms without logging, {logged_ms:.3f} ms with (CUDA events, "
        f"median of 3): logging costs {logged_ms - plain_ms:.3f} ms "
        f"({(logged_ms / plain_ms - 1) * 100:.1f}%); all: without "
        + " ".join(f"{t:.1f}" for t in times[False]) + ", with "
        + " ".join(f"{t:.1f}" for t in times[True]))

    # ---- no_recompile_guard: silent on warm solves, fires on a new batch size
    # the cache emptied first, so that what the guard sees at the new batch
    # size is not served by segments earlier phases left behind
    solver = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")
    torch.cuda.empty_cache()
    for _ in range(UNROLLED["guard_warmup"]):
        solver.solve_refined(q, method="delta")
    with no_recompile_guard() as events:
        for _ in range(3):
            solver.solve_refined(q, method="delta")
        torch.cuda.synchronize()
    q_big = tree.random_configuration(
        (UNROLLED["guard_B"],), generator=torch.Generator(device=dev).manual_seed(1))
    try:
        with no_recompile_guard() as big:
            solver.solve_refined(q_big, method="delta")
            torch.cuda.synchronize()
        raise AssertionError("no_recompile_guard did not fire on a new batch size")
    except RuntimeError as err:
        if "no_recompile_guard" not in str(err):
            raise
    log(f"    no_recompile_guard: {events.count} events over three warm solve_refined calls "
        f"after {UNROLLED['guard_warmup']} warm-up calls; "
        f"{big.count} ({sorted(set(big.names))}) over a first solve at "
        f"B={UNROLLED['guard_B']}: fired")
    if events.count:
        raise AssertionError(f"no_recompile_guard: warm solves made events {events.names}")

    # ---- trace(): every counted launch in the trace of a whole solve (the
    # delta path, two-stage); the launches' device time read from it
    kw = dict(method="two-stage", stage1_max_iter=TWO_STAGE["stage1_max_iter"],
              stage2_max_iter=TWO_STAGE["stage2_max_iter"])
    with tempfile.TemporaryDirectory() as tmp:
        for what, fn in (("delta", lambda: solver.solve_refined(q, method="delta")),
                         ("two-stage", lambda: solver.solve_refined(q, **kw))):
            d = os.path.join(tmp, what)
            fused_mod.LAUNCHES = 0
            with trace(d):
                fn()
            launches = fused_mod.LAUNCHES
            files = os.listdir(d)
            found, us, _ = trace_device_us(os.path.join(d, files[0]))
            log(f"    trace() around one {what} solve_refined: {len(files)} file, {launches} "
                f"launches counted, {found} fused_admm_kernel events in the trace, "
                f"{us / 1e3:.3f} ms on the device")
            if len(files) != 1 or not found:
                raise AssertionError(f"trace(): the {what} trace does not name the kernel")
    # the same two-stage launch re-run alone on the profiler, five sessions:
    # the kernel's time from each session's trace and from key_averages()
    _, _, captured = capture_launches(mods, lambda: solver.solve_refined(q, **kw))
    tree_, params_, prob_, st_, bt = captured[0]
    runs = [profiled(torch, lambda: fused_mod.fused_solve_loop(tree_, params_, prob_, st_, bt))
            for _ in range(5)]
    log("    the two-stage stage 1 launch re-run alone, 5 profiler sessions: launches in "
        "the trace " + " ".join(str(r["launches"]) for r in runs) + ", kernel alone from "
        "the trace " + " ".join(f"{r['kernel_us'] / 1e3:.3f}" for r in runs)
        + " ms, from key_averages() " + " ".join(f"{r['kernel_avg_us'] / 1e3:.3f}" for r in runs)
        + " ms")


def scale_out_path(mods, phase):
    """Phase 17: the sharded solve, the sharded multistart (the kernel
    path), one-rank NCCL, the oracle against the kernel's float64
    instantiation, the native URDF loader, the entry points and the
    examples (run beside `surface_checks`).  Returns the `kernels` entry of
    the sharded multistart."""
    import numpy as np

    from loik_tpu_torch.parallel import sharding

    torch, lt, fused_mod, _, rf, _ = mods
    t_phase = time.time()
    B, k = SCALE_OUT["B"], SCALE_OUT["k"]
    dev = torch.device("cuda")
    tree, links, problem, params, q = config(lt, torch, "flagship", torch.float32, dev, B,
                                             PATHS["flagship"]["K"])

    def once_ms(fn):
        """(fn(), its CUDA-event time in ms): one run, no warm-up."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    # ---- solve_sharded on one card and on repetitions of it --------------
    fused_mod.LAUNCHES = 0
    ref = lt.solve(tree, params, q, problem)        # also the warm-up
    _, ms_whole = once_ms(lambda: lt.solve(tree, params, q, problem))
    launches = fused_mod.LAUNCHES
    log(f"[{phase}] solve (the eager loop, {launches} launches) flagship B={B} float32: "
        f"{ms_whole:.3f} ms (CUDA events, one run after a warm-up)")
    for mesh in (sharding.make_mesh(), sharding.make_mesh(["cuda:0"] * SCALE_OUT["shards"])):
        res, ms_mesh = once_ms(lambda: sharding.solve_sharded(tree, params, q, problem, mesh))
        same = all(torch.equal(getattr(res, n), getattr(ref, n))
                   for n in ("nu", "converged", "iterations", "primal_residual"))
        log(f"[{phase}] solve_sharded over {mesh.size} shard(s) "
            f"{[str(d) for d in mesh.devices]}: {ms_mesh:.3f} ms ({ms_mesh / ms_whole:.3f}x "
            f"solve; one run), result on {res.nu.device}, equal to solve bit for bit: {same}")
        outcome_budget(res, ref, B, "solve on the same inputs")
        m = sharding.convergence_metrics(res)
        conv = res.converged.cpu().numpy()
        it = res.iterations.cpu().numpy().astype(np.float64)
        want = {"num_converged": int(conv.sum()),
                "num_primal_infeasible": int(res.primal_infeasible.cpu().numpy().sum()),
                "mean_iterations": it.sum() / it.size, "max_iterations": int(it.max()),
                "mean_iterations_converged": it[conv].sum() / max(int(conv.sum()), 1)}
        got = {key: m[key].item() for key in want}
        if got != want:
            raise AssertionError(f"convergence_metrics {got} != numpy {want}")
    log(f"    convergence_metrics equal their numpy recomputation: {got}")

    # ---- multistart over a mesh: the kernel path --------------------------
    def delta(fused):
        return lambda t, p, q_, pr: rf.solve_delta_duals(
            t, p, q_, pr, stage1_max_iter=MULTISTART["stage1_max_iter"], fused=fused)

    mesh2 = sharding.make_mesh(["cuda:0"] * SCALE_OUT["ms_shards"])

    def multistart(mesh_, seed=0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return lt.parallel.solve_multistart(tree, params, problem, gen, B, mesh=mesh_,
                                            solve_fn=delta("require"), k=k)

    res_m, launches_m, captured = capture_launches(mods, lambda: multistart(mesh2))
    n_conv = int(res_m.num_converged)
    n_dev = len(set(mesh2.devices))
    log(f"[{phase}] multistart {B} seeds over {mesh2.size} shards on {n_dev} device(s) "
        f"(delta-duals solve_fn, fused='require', top {k}): kernel launches {launches_m}, "
        f"converged {n_conv}")
    if launches_m != 2 * n_dev or len(captured) != 2 * n_dev:
        raise AssertionError(f"expected {2 * n_dev} kernel launches, got {launches_m}")
    check_ranked(mods, tree, problem, links, [res_m], [n_conv], k)
    res_u = multistart(None)
    err_m, err_u = res_m.error.double(), res_u.error.double()
    fin = torch.isfinite(err_u)
    gap = float((err_m[fin] - err_u[fin]).abs().max())
    log(f"    against the unsharded call on the same generator seed: converged "
        f"{int(res_u.num_converged)}, top-{k} errors max |diff| {gap:.3e}, same seeds "
        f"ranked: {torch.equal(res_m.q, res_u.q)}")
    if not (torch.equal(torch.isfinite(err_m), fin) and gap <= 2e-5):
        raise AssertionError("sharded multistart: top-k errors differ from the unsharded call")
    ms_m = cuda_median_ms(torch, lambda: multistart(mesh2))
    ms_u = cuda_median_ms(torch, lambda: multistart(None))
    log(f"    per batch of {B}: over {mesh2.size} shards {ms_m:.3f} ms, unsharded "
        f"{ms_u:.3f} ms (CUDA events, median of 5)")
    rep = stage_report(mods, captured, what="launch")
    entry_ms = kernels_entry("multistart_sharded", launches_m, rep)
    entry_ms["seeds_per_s"] = B / ms_m * 1e3
    # the launches alone from the trace of a whole sharded call (the
    # profiler loses launches in sessions of one launch)
    whole = profiled(torch, lambda: multistart(mesh2))
    seen_all = whole["launches"] == launches_m
    entry_ms["kernel_alone_ms"] = whole["kernel_us"] / 1e3 if seen_all else None
    log(f"    the {launches_m} launches alone from the trace of one whole sharded call: "
        + (f"{whole['kernel_us'] / 1e3:.3f} ms" if seen_all else
           f"not measured (the profiler saw {whole['launches']} of them)"))

    # ---- the examples, as a user runs them: concurrent subprocesses, -----
    # started here so that they run beside the untimed checks below
    root = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(os.path.join(root, "examples", "torch", f)
                   for f in os.listdir(os.path.join(root, "examples", "torch"))
                   if f.startswith("0") and f.endswith(".py"))
    if len(paths) != 7:
        raise AssertionError(f"expected examples 01-07, found {paths}")
    t_ex = time.perf_counter()
    procs = [(p, subprocess.Popen([sys.executable, p], cwd=root, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)) for p in paths]
    try:
        surface_checks(mods, phase, tree, params, problem, q, ref)
        failed = []
        for p, proc in procs:
            out = proc.communicate(timeout=SCALE_OUT["example_timeout"])[0]
            last = out.strip().splitlines()[-1] if out.strip() else ""
            log(f"    {os.path.relpath(p, root)}: exit {proc.returncode} at "
                f"{time.perf_counter() - t_ex:.1f} s; {last}")
            if proc.returncode != 0:
                failed.append((p, out[-3000:]))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise AssertionError("examples failed:\n" + "\n".join(f"{p}:\n{o}" for p, o in failed))
    log(f"    phase {phase} took {time.time() - t_phase:.1f} s")
    return entry_ms


def surface_checks(mods, phase, tree, params, problem, q, ref):
    """Phase 17's untimed checks: one-rank NCCL, the oracle against the
    kernel's float64 instantiation, the native loader, the entry points."""
    import socket

    import numpy as np

    from loik_tpu_torch.entry import dryrun_multichip, entry
    from loik_tpu_torch.model.native import load_urdf_native
    from loik_tpu_torch.oracle import OracleSolver
    from loik_tpu_torch.parallel import distributed as dist
    from loik_tpu_torch.parallel import sharding

    torch, lt, fused_mod = mods[:3]
    dev = torch.device("cuda")

    # ---- one-rank NCCL --------------------------------------------------
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    dist.initialize(f"localhost:{port}", num_processes=1, process_id=0)
    try:
        init_s = time.perf_counter() - t0
        backend = torch.distributed.get_backend()
        res_g = dist.solve_global(tree, params, q, problem)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gm = dist.global_metrics(res_g)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dist.global_metrics(res_g)
        second_s = time.perf_counter() - t0
        cm = {key: v.item() for key, v in sharding.convergence_metrics(res_g).items()}
        log(f"[{phase}] torch.distributed world 1 ({backend}, tcp://localhost:{port}): "
            f"initialize {init_s:.3f} s, first global_metrics (its collectives make the "
            f"communicator) {first_s:.3f} s, second {second_s:.3f} s (host clock); "
            f"solve_global rows {tuple(res_g.nu.shape)} equal to solve: "
            f"{torch.equal(res_g.nu, ref.nu)}; global_metrics {gm}")
        if backend != "nccl" or gm != cm:
            raise AssertionError(f"NCCL: backend {backend}, global {gm} != local {cm}")
    finally:
        dist.shutdown()

    # ---- the oracle against the kernel's float64 instantiation -----------
    cases = []
    rng = np.random.default_rng(1)
    for robot, b3, qs in (("panda", 0.5, [PANDA_Q]), ("ur5", 0.5, None),
                          ("panda_arm", 0.2, rng.uniform(-np.pi, np.pi,
                                                         (SCALE_OUT["oracle_random"], 7)))):
        t = lt.robots.get(robot, device=dev)
        qs = t.neutral()[None] if qs is None else torch.tensor(qs, dtype=torch.float64)
        b = torch.zeros((1, 6), dtype=torch.float64)
        b[0, 2] = b3
        prob = lt.make_problem(t, (t.njoints - 1,), b=b, lb=-4.0 * torch.ones(t.nv),
                               ub=4.0 * torch.ones(t.nv))
        cases.append((robot, t, prob, qs.to(dev)))
    oparams = lt.SolverParams(max_iter=200, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
                              mu_equality_scale_factor=1e5)
    worst, n_prob, n_launch = 0.0, 0, 0
    for robot, t, prob, qs in cases:
        fused_mod.LAUNCHES = 0
        res = fused_mod._fused_body(oparams, None, t, qs, prob, None)
        torch.cuda.synchronize()
        n_launch += fused_mod.LAUNCHES
        for i in range(qs.shape[0]):
            orc = OracleSolver(t, oparams).solve(qs[i], prob)
            if (bool(res.converged[i]) != orc.converged
                    or bool(res.primal_infeasible[i]) != orc.primal_infeasible
                    or int(res.iterations[i]) != orc.iterations):
                raise AssertionError(
                    f"oracle vs kernel f64, {robot} problem {i}: converged "
                    f"{bool(res.converged[i])}/{orc.converged}, iterations "
                    f"{int(res.iterations[i])}/{orc.iterations}")
            worst = max(worst, float(np.abs(res.nu[i].cpu().numpy() - orc.nu).max()))
            n_prob += 1
    log(f"[{phase}] oracle vs the kernel's float64 instantiation ({n_launch} launches): "
        f"{n_prob} problems (panda at the fixture q, ur5 neutral, "
        f"{SCALE_OUT['oracle_random']} random panda_arm), flags and iterations equal, nu "
        f"max |diff| {worst:.3e}")
    if n_launch != len(cases) or worst > 1e-9:
        raise AssertionError(f"oracle vs kernel: {n_launch} launches, nu {worst}")

    # ---- the native URDF loader ------------------------------------------
    talos_urdf = os.path.join(os.path.dirname(lt.model.robots.__file__), "assets", "talos.urdf")
    t0 = time.perf_counter()
    t_nat = load_urdf_native(talos_urdf, dtype=torch.float32, floating_base=True, device=dev)
    load_s = time.perf_counter() - t0
    t_py = lt.robots.talos("float32", device=dev)
    for name in ("placement_R", "placement_p", "axis", "velocity_limit"):
        if not torch.equal(getattr(t_nat, name), getattr(t_py, name)):
            raise AssertionError(f"native talos: leaf {name} differs from load_urdf's")
    if (t_nat.parents, t_nat.jtypes, t_nat.joint_names) != (
            t_py.parents, t_py.jtypes, t_py.joint_names):
        raise AssertionError("native talos: topology differs from load_urdf's")
    tb, tK = PATHS["talos"]["B"], PATHS["talos"]["K"]
    _, tlinks, tproblem, tparams, tq = config(lt, torch, "talos", torch.float32, dev, tb, tK)
    outs = []
    for t in (t_py, t_nat):
        solver = lt.DiffIkSolver(t, tparams, tlinks, problem=tproblem, fused="require")
        outs.append(capture_launches(mods, lambda: solver.solve_refined(tq, method="delta")))
    bits = all(torch.equal(getattr(outs[0][0], n), getattr(outs[1][0], n))
               for n in ("nu", "converged", "iterations", "primal_residual", "dual_residual"))
    log(f"[{phase}] load_urdf_native(talos, floating base) on {t_nat.device} in "
        f"{load_s:.3f} s (build included): every leaf equal to load_urdf's; the talos main "
        f"path (B={tb}) on the native tree equals the Python tree's bit for bit: {bits} "
        f"({outs[0][1]} + {outs[1][1]} launches)")
    if not bits or outs[0][1] != 2 or outs[1][1] != 2:
        raise AssertionError("native talos: the main path differs from the Python tree's")

    # ---- the entry points -------------------------------------------------
    fn, (qs,) = entry()
    (nu, conv, iters), launches_e, _ = capture_launches(mods, lambda: fn(qs))
    log(f"[{phase}] entry(): B={qs.shape[0]} on {qs.device}, {launches_e} launch(es), "
        f"converged {int(conv.sum())}, iterations max {int(iters.max())}")
    if launches_e != 1 or not bool(torch.isfinite(nu).all()):
        raise AssertionError("entry(): expected one launch and finite nu")
    summary = dryrun_multichip(torch.cuda.device_count())
    log(f"    dryrun_multichip({torch.cuda.device_count()}): {json.dumps(summary)}")


def leaves(x):
    """The tensors of a result, in field order (`utils.graphs`' order)."""
    from loik_tpu_torch.utils import graphs

    out = []
    graphs._flatten(x, out)
    return out


def bits_equal(torch, got, want):
    """Names (by position) of the tensors of ``got`` that differ from
    ``want`` in any bit (NaNs in the same places count as equal)."""
    a, b = leaves(got), leaves(want)
    if len(a) != len(b):
        return [f"{len(a)} tensors against {len(b)}"]
    return [str(i) for i, (x, y) in enumerate(zip(a, b))
            if x.shape != y.shape or x.dtype != y.dtype
            or not torch.equal(x.nan_to_num(), y.nan_to_num())
            or not torch.equal(x.isnan(), y.isnan())]


def in_turns(torch, fns, reps=5, warm=True):
    """Median CUDA-event time of each of ``fns`` over ``reps`` rounds, the
    functions run in turns within a round (one warm-up round first, unless
    not ``warm``: the functions ran before)."""
    times = [[] for _ in fns]
    for r in range(1 - int(warm), reps + 1):
        for i, fn in enumerate(fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            if r:
                times[i].append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def first_call(torch, what, fn):
    """fn() as the first call of its key: (result, host-clock seconds,
    the capture's record)."""
    from loik_tpu_torch.utils import graphs

    n = len(graphs.CAPTURES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if len(graphs.CAPTURES) != n + 1:
        raise AssertionError(f"{what}: {len(graphs.CAPTURES) - n} captures, expected 1")
    cap = graphs.CAPTURES[-1]
    log(f"    {what}: first call {secs:.3f} s ({cap.tag}: warm-up and capture "
        f"{cap.seconds:.3f} s), graph pool {cap.pool_bytes / 2**20:.1f} MiB "
        f"(memory_reserved across the capture), static inputs "
        f"{cap.static_bytes / 2**20:.2f} MiB, {cap.launches} kernel launch(es) a replay")
    return res, secs, cap


def repeated(torch, fused_mod, what, fn, want_launches):
    """fn() as a repeated call: its launches and host synchronisations."""
    torch.cuda.synchronize()
    fused_mod.LAUNCHES = 0
    res, syncs = count_syncs(torch, fn)
    torch.cuda.synchronize()
    launches = fused_mod.LAUNCHES
    log(f"    {what}: a repeated call launched the kernel {launches} times (replayed), "
        f"host synchronisations {len(syncs)}")
    if launches != want_launches:
        raise AssertionError(f"{what}: {launches} launches, expected {want_launches}")
    if syncs:
        raise AssertionError(f"{what} synchronises the host: " + "; ".join(syncs[:5]))
    return res, launches


def same_bits(torch, what, got, want):
    bad = bits_equal(torch, got, want)
    log(f"    {what}: graphed against eager-launched, {len(leaves(got))} tensors, "
        f"{len(bad)} differ")
    if bad:
        raise AssertionError(f"{what}: graphed and eager-launched results differ in "
                             f"tensors {bad[:10]}")


def unaliased(torch, what, first, again):
    """``first`` (a result already cloned into ``kept``) is unchanged
    after ``again()``, a call with other inputs, whose result differs."""
    kept = [t.clone() for t in leaves(first)]
    second = again()
    torch.cuda.synchronize()
    moved = [i for i, (a, b) in enumerate(zip(leaves(first), kept))
             if not torch.equal(a.nan_to_num(), b.nan_to_num())]
    differs = bool(bits_equal(torch, first, second))
    log(f"    {what}: a second call with other inputs left the first result unchanged: "
        f"{not moved}; its result differs: {differs}")
    if moved or not differs:
        raise AssertionError(f"{what}: results alias between calls ({moved[:5]})")


def graph_path(mods, phase):
    """Phase 18: the compiled entry points as captured CUDA graphs (the
    default on the card) against the same calls launched eagerly under
    `disable_graphs()`.  Returns, per `kernels` entry name, its graph
    numbers."""
    from loik_tpu_torch.utils import graphs

    torch, lt, fused_mod, sm, _, bsp = mods
    dev = torch.device("cuda")
    t_phase = time.time()
    out = {}

    def graph_idle(what, fn, T):
        """The device's idle share over ONE traced, replayed run of T ticks:
        the gaps between its kernels, copies and sets over the span from the
        first one's start to the last one's end."""
        prof = profiled(torch, fn)
        if not prof["span_us"]:
            log(f"    {what}: the profiler saw no device time: idle share not measured")
            return None
        busy, span = prof["busy_us"] / 1e3, prof["span_us"] / 1e3
        log(f"    {what}: on the profiler's trace of one replayed run the device was busy "
            f"{busy / T:.4f} ms a tick of a {span / T:.4f} ms span (first device operation "
            f"to last; the block's wall {prof['wall_ms'] / T:.4f} ms a tick): idle share "
            f"{1 - busy / span:.4f}; kernel alone "
            + ("not measured" if not prof["kernel_us"] else
               f"{prof['kernel_us'] / 1e3 / T:.4f} ms a tick"))
        return 1 - busy / span

    def held(name, what, fn, other, launches, eager=None):
        """One path as a graph: its first call, a repeated call (launches
        counted, no host synchronisation), the eager-launched call's bits
        (``eager`` or ``fn`` under `disable_graphs()`), a second call with
        other inputs (``other``) that leaves the first result alone, and the
        graphed and eager-launched times in turns.  Returns the repeated
        call's result."""
        eager = eager or fn
        _, cap_s, cap = first_call(torch, what, fn)
        res, n = repeated(torch, fused_mod, what, fn, launches)
        with graphs.disable_graphs():
            want = eager()
        same_bits(torch, what, res, want)
        unaliased(torch, what, res, other)

        def eager_launched():
            with graphs.disable_graphs():
                eager()

        g_ms, e_ms = in_turns(torch, [fn, eager_launched])
        log(f"    {what}: graphed {g_ms:.3f} ms, eager-launched {e_ms:.3f} ms (CUDA events, "
            "median of 5, in turns)")
        out[name] = dict(graph_ms=g_ms, eager_launched_ms=e_ms, capture_s=cap_s,
                         pool_bytes=cap.pool_bytes, graph_launches=n)
        return res

    # ---- the flagship, solve_refined(method="delta") --------------------
    B, K = PATHS["flagship"]["B"], PATHS["flagship"]["K"]
    tree, links, problem, params, q = config(lt, torch, "flagship", torch.float32, dev, B, K)
    solver = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")

    def flagship(qq=q):
        return solver.solve_refined(qq, method="delta")

    log(f"[{phase}] flagship B={B} check_interval={K}, solve_refined(method='delta'):")
    res = held("flagship", "flagship", flagship, lambda: flagship(q.flip(0)), 2)
    certify(mods, tree, problem, links, q, res)
    log(f"    flagship: {B * float(res.converged.double().mean()) / out['flagship']['graph_ms'] * 1e3:.0f} "
        "converged solves/s graphed")

    # ---- the legged robots, the mixed super-batch, a multistart batch ----
    for name in ("solo12", "talos"):
        B, K = PATHS[name]["B"], PATHS[name]["K"]
        tree, links, problem, params, q = config(lt, torch, name, torch.float32, dev, B, K)
        legged = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")
        log(f"[{phase}] {name} B={B} check_interval={K}, solve_refined(method='delta'):")
        held(name, name, lambda qq=q: legged.solve_refined(qq, method="delta"),
             lambda: legged.solve_refined(q.flip(0), method="delta"), 2)

    def delta(**kw):
        return lambda t, p, qq, pr: lt.solve_delta_duals(t, p, qq, pr, fused="require", **kw)

    B, K = PATHS["mixed"]["B"], PATHS["mixed"]["K"]
    mp, groups, params = mixed_setup(lt, torch, torch.float32, B // 2, K)
    qs = [g[1] for g in groups]
    log(f"[{phase}] mixed {B // 2} ur5 + {B // 2} panda_arm check_interval={K}, "
        "MixedPadded.solve_packed with the delta-duals solve:")
    held("mixed", "mixed", lambda qq=qs: mp.solve_packed(params, qq, solve_fn=delta()),
         lambda: mp.solve_packed(params, [x.flip(0) for x in qs], solve_fn=delta()), 2)

    B, k = MULTISTART["B"], MULTISTART["k"]
    tree, links, problem, params, _ = config(lt, torch, "flagship", torch.float32, dev, B,
                                             PATHS["flagship"]["K"])

    def multistart(seed=0):
        return lt.parallel.solve_multistart(
            tree, params, problem, torch.Generator(device=dev).manual_seed(seed), B, k=k,
            solve_fn=delta(stage1_max_iter=MULTISTART["stage1_max_iter"]))

    # the flagship's graph has the batch's key (tree, params, B): drop it, so
    # that the batch's first call captures
    graphs.clear_graphs()
    log(f"[{phase}] multistart one batch of {B} seeds (top {k}), the delta-duals solve:")
    held("multistart", "multistart", multistart, lambda: multistart(1), 2)

    # ---- the tracking stream, track_scan ---------------------------------
    T, tol = TRACKING["T"], TRACKING["tol"]
    sweep = torch.zeros((T, 6), dtype=torch.float32, device=dev)
    sweep[:, 2] = 0.2 * torch.cos(2 * torch.pi * torch.arange(T, device=dev) / T)
    for B in TRACKING["fleets"]:
        tree, links, problem, params, q = config(lt, torch, "flagship", torch.float32, dev,
                                                 B, 1)
        params = params.replace(tol_abs=tol, tol_rel=tol, warm_start=True)
        ticker = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")
        for _ in range(TRACKING["settle"]):            # settle the duals (graphed ticks)
            ticker.solve_tracking(q, links[0], b=problem.b[0])
        warm = ticker.state

        def stream(b_seq=sweep):
            return lt.solve_stream(tree, params, q, problem, 0, b_seq, warm_state=warm,
                                   fused="require")

        log(f"[{phase}] tracking stream B={B} T={T} tol {tol:g}, solve_stream from a "
            "settled warm state:")
        _, cap_s, cap = first_call(torch, f"stream B={B}", stream)
        res, launches = repeated(torch, fused_mod, f"stream B={B}", stream, T)
        with graphs.disable_graphs():
            want = stream()
        same_bits(torch, f"stream B={B}", res, want)
        unaliased(torch, f"stream B={B}", res, lambda: stream(0.5 * sweep))

        def eager_stream():
            with graphs.disable_graphs():
                stream()

        t0 = time.perf_counter()
        stream()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        g_ms, e_ms = in_turns(torch, [stream, eager_stream])
        log(f"    stream B={B}: graphed {g_ms / T:.4f} ms a tick (host enqueue "
            f"{host / T:.4f}), eager-launched {e_ms / T:.4f} ms a tick (CUDA events around "
            "the stream, median of 5, in turns)")
        out[f"tracking_B{B}"] = dict(
            graph_ms_per_tick=g_ms / T, eager_launched_ms_per_tick=e_ms / T,
            host_enqueue_ms_per_tick=host / T, capture_s=cap_s, pool_bytes=cap.pool_bytes,
            graph_launches=launches,
            idle_share=graph_idle(f"stream B={B}", stream, T))

        if B != TRACKING["fleets"][0]:
            continue
        # ---- solve_tracking, one graphed tick per call ------------------
        n = 10
        kern = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")
        eager = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")
        got = [kern.solve_tracking(q, links[0], b=b) for b in sweep[:n]]
        with graphs.disable_graphs():
            want = [eager.solve_tracking(q, links[0], b=b) for b in sweep[:n]]
        same_bits(torch, f"solve_tracking B={B}, {n} ticks", got, want)
        _, launches = repeated(torch, fused_mod, f"solve_tracking B={B}",
                               lambda: kern.solve_tracking(q, links[0], b=sweep[n]), 1)
        lat = {"graphed": [], "eager-launched": []}
        for b in sweep[n + 1:n + 41]:
            for label, solver_, off in (("graphed", kern, False), ("eager-launched", eager, True)):
                with graphs.disable_graphs(off):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    solver_.solve_tracking(q, links[0], b=b)
                    torch.cuda.synchronize()
                    lat[label].append((time.perf_counter() - t0) * 1e3)
        log(f"    solve_tracking B={B}, synchronous p50 over 40 ticks in turns: graphed "
            f"{statistics.median(lat['graphed']):.4f} ms, eager-launched "
            f"{statistics.median(lat['eager-launched']):.4f} ms (host clock)")
        out[f"tracking_B{B}"]["solve_tracking_p50_ms"] = statistics.median(lat["graphed"])
        out[f"tracking_B{B}"]["eager_launched_solve_tracking_p50_ms"] = statistics.median(
            lat["eager-launched"])

    # ---- the closed loop, reach -----------------------------------------
    B, T = CLIK["B"], CLIK["steps"]
    tree, q0, tR, tp, ee = clik_inputs(lt, torch, B)
    params = lt.SolverParams(max_iter=CLIK["max_iter"], tol_abs=CLIK["tol"],
                             tol_rel=CLIK["tol"], check_interval=1)
    run = dict(dt=CLIK["dt"], gain=CLIK["gain"])
    solver = lt.DiffIkSolver(tree, params, (ee,), fused="require")

    def reach(target_p=tp):
        return solver.reach(q0, tR, target_p, steps=T, **run)

    log(f"[{phase}] clik reach B={B} T={T} tol {CLIK['tol']:g}:")
    _, cap_s, cap = first_call(torch, "clik", reach)
    res, launches = repeated(torch, fused_mod, "clik", reach, T)
    with graphs.disable_graphs():
        want = reach()
    same_bits(torch, "clik", res, want)
    unaliased(torch, "clik", res, lambda: reach(tp + 0.01))

    def eager_reach():
        with graphs.disable_graphs():
            reach()

    t0 = time.perf_counter()
    reach()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    g_ms, e_ms = in_turns(torch, [reach, eager_reach])
    log(f"    clik: graphed {g_ms / T:.4f} ms a tick (host enqueue {host / T:.4f}), "
        f"eager-launched {e_ms / T:.4f} ms a tick (CUDA events around the run, median of 5, "
        f"in turns); reached {float(res.reached.double().mean()):.4f}")
    out["clik"] = dict(
        graph_ms_per_tick=g_ms / T, eager_launched_ms_per_tick=e_ms / T,
        host_enqueue_ms_per_tick=host / T, capture_s=cap_s, pool_bytes=cap.pool_bytes,
        graph_launches=launches, idle_share=graph_idle("clik", reach, T))

    held = graphs.cached_graphs()
    graphs.clear_graphs()
    torch.cuda.empty_cache()
    log(f"    {len(graphs.CAPTURES)} captures in this process, {held} graphs held before "
        f"clear_graphs(); phase {phase} took {time.time() - t_phase:.1f} s")
    return out


def while_path(mods, phase):
    """Phase 19: the entry points whose CUDA graphs hold the masked while
    loop as a WHILE node (`utils.graphs.while_loop`), each against the same
    call launched eagerly under `disable_graphs()`, where the loop reads the
    running mask on the host every body execution.  Returns, per path, its
    graph numbers."""
    import warnings

    from loik_tpu_torch.utils import graphs

    torch, lt, fused_mod, sm, _, bsp = mods
    dev = torch.device("cuda")
    t_phase = time.time()
    out = {}

    def body_runs(fn):
        """fn()'s result and the loop body executions it ran."""
        torch.cuda.synchronize()
        graphs.reset_body_executions()
        res = fn()
        torch.cuda.synchronize()
        return res, graphs.body_executions()

    def copy_share(what, cap, trips, graph_ms):
        """The share of a replayed call spent copying the carry back: the
        CUDA-event time of one body execution's copies (a graph of
        device-to-device copies of the sizes `Loop.copies` records, replayed
        20 times), the largest loop's, times the body executions, over the
        call's time.  Exact for one loop or loops of equal carries (two
        float64 stages of a float32 one: at most)."""
        ms = 0.0
        for lp in cap.loops:
            src = [torch.empty(b, dtype=torch.uint8, device=dev) for b in lp.copies if b]
            dst = [torch.empty_like(x) for x in src]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for d, x in zip(dst, src):
                    d.copy_(x)
            ms = max(ms, cuda_median_ms(torch, lambda: [graph.replay() for _ in range(20)]) / 20)
        share = ms * trips / graph_ms
        log(f"    {what}: the carry copy-back takes {ms * 1e3:.2f} us a body execution "
            f"({max(sum(lp.copies) for lp in cap.loops) / 2**20:.3f} MiB, CUDA events), "
            f"{share:.4f} of the graphed call")
        return share

    def timed(fn):
        """fn()'s result and its CUDA-event time, ms."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        return res, start.elapsed_time(end)

    def held(name, what, fn, other, launches=0, eager=None, eager_before=0, ticks=None):
        """One path as a graph: its first call (capture time, pool, nodes),
        a repeated call (launches counted, no host synchronisation, body
        executions on the device), the eager-launched call (``eager``, run
        ``eager_before`` times first, or ``fn`` under `disable_graphs()`):
        the same bits after as many body executions; a second call with
        other inputs (``other``) that leaves the first result alone; the
        graphed and eager-launched times in turns (an eager-launched call
        that takes more than `WHILE["eager_reps_below_ms"]` is timed once,
        the call compared), and the share of the graphed call spent
        copying the carry back."""
        eager = eager or fn

        def eager_launched():
            with graphs.disable_graphs():
                return eager()

        _, first_s, cap = first_call(torch, what, fn)
        graphs.reset_body_executions()
        res, n = repeated(torch, fused_mod, what, fn, launches)
        torch.cuda.synchronize()
        trips = graphs.body_executions()
        for _ in range(eager_before):
            eager_launched()
        (want, e_first), eager_trips = body_runs(lambda: timed(eager_launched))
        log(f"    {what}: {cap.nodes} graph nodes, {len(cap.loops)} WHILE node(s) with "
            f"{[lp.body_nodes for lp in cap.loops]} body nodes; body executions graphed "
            f"{trips}, eager-launched {eager_trips}")
        if trips != eager_trips:
            raise AssertionError(f"{what}: {trips} body executions graphed, "
                                 f"{eager_trips} eager-launched")
        same_bits(torch, what, res, want)
        unaliased(torch, what, res, other)
        if e_first < WHILE["eager_reps_below_ms"]:
            g_ms, e_ms = in_turns(torch, [fn, eager_launched], warm=False)
            e_n, e_how = 5, "median of 5"
        else:
            (g_ms,), e_ms = in_turns(torch, [fn], warm=False), e_first
            e_n, e_how = 1, "a single reading"
        per = f" ({g_ms / ticks:.4f} and {e_ms / ticks:.4f} ms a tick)" if ticks else ""
        log(f"    {what}: graphed {g_ms:.3f} ms (median of 5), eager-launched {e_ms:.3f} ms "
            f"({e_how}){per}, CUDA events, in turns")
        out[name] = dict(graph_ms=g_ms, eager_launched_ms=e_ms, eager_launched_reps=e_n,
                         eager_launched_timing=e_how,
                         first_call_s=first_s, capture_s=cap.seconds,
                         pool_bytes=cap.pool_bytes, nodes=cap.nodes,
                         while_nodes=len(cap.loops), body_executions=trips,
                         copy_back_bytes_per_body=max(sum(lp.copies) for lp in cap.loops),
                         copy_share=copy_share(what, cap, trips, g_ms), graph_launches=n)
        return res

    # ---- solve() on the three delta-duals main paths' trees and inputs ----
    for name in ("flagship", "solo12", "talos"):
        B, K = PATHS[name]["B"], PATHS[name]["K"]
        tree, links, problem, params, q = config(lt, torch, name, torch.float32, dev, B, K)
        log(f"[{phase}] {name} B={B} check_interval={K}, solve():")
        held(f"solve_{name}", f"solve {name}",
             lambda tree=tree, params=params, q=q, problem=problem:
                 lt.solve(tree, params, q, problem),
             lambda: lt.solve(tree, params, q.flip(0), problem))

    # ---- the two-stage path on mobile_ur5 and on the flagship ------------
    Bm = TWO_STAGE["mobile_B"]
    B, K = PATHS["flagship"]["B"], PATHS["flagship"]["K"]
    tree, links, problem, params, q = config(lt, torch, "flagship", torch.float32, dev, B, K)
    mtree = lt.robots.mobile_ur5("float32", device=dev)
    mlinks = (mtree.joint_names.index("wrist_3_joint"),)
    mproblem = lt.make_problem(
        mtree, mlinks, b=torch.tensor([[0.0, 0.0, 0.2, 0.0, 0.0, 0.0]]),
        lb=-4.0 * torch.ones(mtree.nv), ub=4.0 * torch.ones(mtree.nv))
    mq = mtree.random_configuration((Bm,), generator=torch.Generator(device=dev).manual_seed(0))
    msolver = lt.DiffIkSolver(mtree, params, mlinks, problem=mproblem)
    log(f"[{phase}] mobile_ur5 B={Bm} check_interval={K}, solve_refined(): the two-stage "
        "path, both stages while loops")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mres = held("two_stage_mobile_ur5", "two-stage mobile_ur5",
                    lambda qq=mq: msolver.solve_refined(qq),
                    lambda: msolver.solve_refined(mq.flip(0)))
    noisy = [str(w.message) for w in caught if "fused" in str(w.message)]
    if noisy:
        raise AssertionError(f"mobile_ur5: kernel warnings {noisy}")
    certify(mods, mtree, mproblem, mlinks, mq, mres, label="mobile_ur5: ")

    solver = lt.DiffIkSolver(tree, params, links, problem=problem, fused="require")
    kw = dict(method="two-stage", stage1_max_iter=TWO_STAGE["stage1_max_iter"],
              stage2_max_iter=TWO_STAGE["stage2_max_iter"])
    log(f"[{phase}] flagship B={B} two-stage (stage caps {kw['stage1_max_iter']} / "
        f"{kw['stage2_max_iter']}): the kernel, then the float64 while loop")
    res = held("two_stage", "two-stage flagship",
               lambda qq=q: solver.solve_refined(qq, **kw),
               lambda: solver.solve_refined(q.flip(0), **kw), launches=1)
    certify(mods, tree, problem, links, q, res)

    log(f"[{phase}] flagship B={B} check_interval={K}, solve_delta_refined():")
    held("delta_refined", "delta-refined flagship",
         lambda qq=q: lt.solve_delta_refined(tree, params, qq, problem),
         lambda: lt.solve_delta_refined(tree, params, q.flip(0), problem))

    # ---- the mixed super-batch: one solve, and a scan over R reps --------
    B, K = PATHS["mixed"]["B"], PATHS["mixed"]["K"]
    mp, groups, mparams = mixed_setup(lt, torch, torch.float32, B // 2, K)
    qs = [g[1] for g in groups]
    log(f"[{phase}] mixed {B // 2} ur5 + {B // 2} panda_arm check_interval={K}, "
        "MixedPadded.solve_packed with the default solve:")
    held("mixed", "mixed solve_packed", lambda qq=qs: mp.solve_packed(mparams, qq),
         lambda: mp.solve_packed(mparams, [x.flip(0) for x in qs]))
    R = WHILE["mixed_reps"]
    stacked = [torch.stack([x.roll(r, 0) for r in range(R)]) for x in qs]
    log(f"[{phase}] mixed solve_scan over R={R} staged super-batches (graphs.scan):")
    held("mixed_scan", "mixed solve_scan", lambda st=stacked: mp.solve_scan(mparams, st),
         lambda: mp.solve_scan(mparams, [x.flip(1) for x in stacked]), ticks=R)

    # ---- one multistart batch with the default solve ---------------------
    B, k = MULTISTART["B"], MULTISTART["k"]
    tree, links, problem, params, _ = config(lt, torch, "flagship", torch.float32, dev, B,
                                             PATHS["flagship"]["K"])
    gen, twin = (torch.Generator(device=dev).manual_seed(7) for _ in range(2))

    def multistart(g=gen):
        return lt.parallel.solve_multistart(tree, params, problem, g, B, k=k)

    log(f"[{phase}] multistart one batch of {B} seeds (top {k}), the default solve "
        "(sampler, solve, scoring and top k as one graph):")
    held("multistart", "multistart", multistart, multistart,
         eager=lambda: multistart(twin), eager_before=1)

    # ---- the tracking tick and stream on the plain loop -------------------
    B, T, tol = WHILE["tracking_B"], WHILE["tracking_T"], TRACKING["tol"]
    n, T_long = WHILE["ticks"], WHILE["tracking_T_long"]
    sweep = torch.zeros((max(T_long, n + 1 + WHILE["p50_ticks"]), 6), dtype=torch.float32,
                        device=dev)
    sweep[:, 2] = 0.2 * torch.cos(2 * torch.pi * torch.arange(sweep.shape[0], device=dev) / T)
    tree, links, problem, params, q = config(lt, torch, "flagship", torch.float32, dev, B, 1)
    params = params.replace(tol_abs=tol, tol_rel=tol, warm_start=True)
    ticker = lt.DiffIkSolver(tree, params, links, problem=problem, fused=False)
    for _ in range(TRACKING["settle"]):                # settle the duals (graphed ticks)
        ticker.solve_tracking(q, links[0], b=problem.b[0])
    warm, settled = ticker.state, ticker.problem

    def scan(b_seq=sweep[:T]):
        ticker._state, ticker.problem = warm, settled
        return ticker.track_scan(q, b_seq, links[0])

    log(f"[{phase}] track_scan on the plain loop B={B} T={T} tol {tol:g}, from a settled "
        "warm state (a WHILE node in each replayed tick):")
    short = held(f"tracking_B{B}", f"track_scan B={B}", scan, lambda: scan(0.5 * sweep[:T]),
                 ticks=T)

    # the long stream graphed: an eager-launched tick takes about ten times a
    # graphed one, so the eager stream above is its first T ticks; its time
    # is a single reading (five would add 20-25 s to the script's budget)
    def long_scan(b_seq=sweep[:T_long]):
        return scan(b_seq)

    def first_ticks(r):
        return [r.nu[:T], r.converged[:T], r.iterations[:T], r.primal_residual[:T],
                r.dual_residual[:T]]

    what = f"track_scan B={B} T={T_long}"
    log(f"[{phase}] {what} graphed, its first {T} ticks against the eager-launched "
        f"stream of {T} ticks:")
    _, first_s, cap = first_call(torch, what, long_scan)
    res, n_long = repeated(torch, fused_mod, what, long_scan, 0)
    same_bits(torch, f"{what}, its first {T} ticks", first_ticks(res), first_ticks(short))
    _, g_ms = timed(long_scan)
    log(f"    {what}: graphed {g_ms:.3f} ms (a single reading, {g_ms / T_long:.4f} ms a "
        f"tick), CUDA events; {cap.nodes} graph nodes")
    out[f"tracking_B{B}_T{T_long}"] = dict(
        graph_ms=g_ms, graph_timing="a single reading", graph_ms_per_tick=g_ms / T_long,
        first_call_s=first_s,
        capture_s=cap.seconds, pool_bytes=cap.pool_bytes, nodes=cap.nodes,
        while_nodes=len(cap.loops), graph_launches=n_long)

    kern = lt.DiffIkSolver(tree, params, links, problem=settled, fused=False)
    eager = lt.DiffIkSolver(tree, params, links, problem=settled, fused=False)
    kern._state = eager._state = warm
    got, trips = body_runs(lambda: [kern.solve_tracking(q, links[0], b=b) for b in sweep[:n]])
    with graphs.disable_graphs():
        want, eager_trips = body_runs(
            lambda: [eager.solve_tracking(q, links[0], b=b) for b in sweep[:n]])
    log(f"    solve_tracking B={B}, {n} ticks: body executions graphed {trips}, "
        f"eager-launched {eager_trips}")
    if trips != eager_trips:
        raise AssertionError(f"solve_tracking: {trips} body executions graphed, "
                             f"{eager_trips} eager-launched")
    same_bits(torch, f"solve_tracking B={B}, {n} ticks", got, want)
    repeated(torch, fused_mod, f"solve_tracking B={B}",
             lambda: kern.solve_tracking(q, links[0], b=sweep[n]), 0)
    lat = {"graphed": [], "eager-launched": []}
    for b in sweep[n + 1:n + 1 + WHILE["p50_ticks"]]:
        for label, solver_, off in (("graphed", kern, False), ("eager-launched", eager, True)):
            with graphs.disable_graphs(off):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solver_.solve_tracking(q, links[0], b=b)
                torch.cuda.synchronize()
                lat[label].append((time.perf_counter() - t0) * 1e3)
    p50 = {k_: statistics.median(v) for k_, v in lat.items()}
    log(f"    solve_tracking B={B}, synchronous p50 over {WHILE['p50_ticks']} ticks in turns: "
        f"graphed {p50['graphed']:.4f} ms, eager-launched {p50['eager-launched']:.4f} ms "
        "(host clock)")
    out[f"tracking_B{B}"].update(solve_tracking_p50_ms=p50["graphed"],
                                 eager_launched_solve_tracking_p50_ms=p50["eager-launched"])

    held_n = graphs.cached_graphs()
    graphs.clear_graphs()
    torch.cuda.empty_cache()
    log(f"    {held_n} graphs held before clear_graphs(); phase {phase} took "
        f"{time.time() - t_phase:.1f} s")
    return out


def frame_report(mods):
    """Per path: the shared memory of one problem's frame and of the block's
    copy of S, and the problems per block at the default tile."""
    torch, lt, fused_mod, _, rf, _ = mods
    chain = ((1,) * 7, 1, True)          # the mixed super-batch's padded chain
    shapes = {"mixed": chain}
    for name, nc in (("flagship", 1), ("solo12", 5), ("talos", 2)):
        robot = "panda_arm" if name == "flagship" else name
        shapes[name] = (lt.robots.get(robot, "float32").nvs, nc, False)
    for name, (nvs, nc, s_all) in shapes.items():
        frame, block = fused_mod.frame_words(nvs, nc, s_all)
        tile = rf.default_batch_tile(len(nvs))
        per = {dt: fused_mod.problems_per_block(nvs, nc, dt, tile, s_all)
               for dt in (torch.float32, torch.float64)}
        log(f"    {name}: {len(nvs)} joints, {sum(nvs)} dofs, {nc} constraints: frame "
            f"{frame * 4} B per problem in float32 ({frame * 8} B in float64), S "
            f"{block * 4} B per block; problems per block {per[torch.float32]} "
            f"({per[torch.float64]}), x {fused_mod.LANES} lanes")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs on a CUDA card only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import loik_tpu_torch as lt
    from loik_tpu_torch.kernels import _build
    from loik_tpu_torch.kernels import fused as fused_mod
    from loik_tpu_torch.solver import batched_spatial as bsp
    from loik_tpu_torch.solver import refine as rf
    from loik_tpu_torch.utils import graphs
    import loik_tpu_torch.solver.solve  # noqa: F401  (the module, not the function)

    sm = sys.modules["loik_tpu_torch.solver.solve"]
    mods = (torch, lt, fused_mod, sm, rf, bsp)
    t_start = time.time()

    def clock():
        log(f"    -- {time.time() - t_start:.1f} s since the start")

    # ---- 1. the card ----------------------------------------------------
    card = card_line()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    log(card)

    # phases 2-17 launch eagerly, as they did before the entry points ran
    # as CUDA graphs: several hook Python functions that a replay never calls
    with graphs.disable_graphs():
        # ---- 2. build -------------------------------------------------------
        fresh = not os.path.exists(_build.library_path())
        t0 = time.time()
        path = _build.build()
        build_s = time.time() - t0
        log(f"[2] kernel library {os.path.relpath(path)} "
            f"({'built' if fresh else 'cached'} in {build_s:.1f} s, "
            f"nvcc {' '.join(_build.NVCC_FLAGS)})")
        for line in _build.build_log().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("    " + line.strip())
        frame_report(mods)
        clock()

        # ---- 3, 4. the flagship's instantiation vs the eager loop ------------
        for K in (1, 8):
            double_check(mods, 3, "flagship", 1024, K)
        float_lockstep(mods, 4, "flagship", PATHS["flagship"]["B"])
        clock()

        # ---- 5. the flagship main path ---------------------------------------
        kernels = [main_path(mods, "flagship", 5)]
        clock()

        # ---- 6. multi-dof joints and tall trees vs the eager loop ------------
        double_check(mods, 6, "solo12", 1024, 1)
        double_check(mods, 6, "solo12", 1024, 4)
        double_check(mods, 6, "talos", 256, 1)
        float_lockstep(mods, 6, "solo12", PATHS["solo12"]["B"])
        float_lockstep(mods, 6, "talos", PATHS["talos"]["B"])
        clock()

        # ---- 7, 8. the legged robots' main paths -----------------------------
        kernels.append(main_path(mods, "solo12", 7))
        kernels.append(main_path(mods, "talos", 8))
        clock()

        # ---- 9, 10. per-problem subspaces and the mixed super-batch ----------
        subspaces_check(mods, 9)
        kernels.append(mixed_path(mods, 10))
        clock()

        # ---- 11. warm-started tracking ---------------------------------------
        kernels += tracking_path(mods, 11)
        clock()

        # ---- 12-14. the planner and position-level paths --------------------
        kernels.append(multistart_path(mods, 12))
        clock()
        kernels.append(clik_path(mods, 13))
        clock()
        kernels.append(two_stage_path(mods, 14))
        clock()

        # ---- 15, 16. the differentiable solve; logging and the mirror -------
        unrolled_path(mods, 15)
        clock()
        mirror_path(mods, 16)
        clock()

        # ---- 17. scale-out, the oracle, the native loader, entry, examples ---
        kernels.append(scale_out_path(mods, 17))

    # ---- 18. the compiled entry points as CUDA graphs -------------------
    for name, extra in graph_path(mods, 18).items():
        entry = next(e for e in kernels if e["name"] == f"fused_admm/{name}")
        entry["graph"] = extra
    clock()

    # ---- 19. the masked while loop as a WHILE node in the graphs ---------
    loops = while_path(mods, 19)
    entry = next(e for e in kernels if e["name"] == "fused_admm/two_stage")
    entry["graph"] = loops["two_stage"]
    clock()
    log("    phase 19 (graphed against eager-launched): " + json.dumps(loops))

    log(f"done in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
