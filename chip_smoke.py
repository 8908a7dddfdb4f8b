#!/usr/bin/env python3
"""Drive loik_tpu_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root, one GPU

The main path is the flagship tight-tolerance solve: `panda_arm` (7 revolute
joints), one 6-D end-effector constraint, box bounds +-4, B = 16384
problems, tol 1e-6, through `DiffIkSolver.solve_refined(method="delta")`
with `fused="require"`.  Both float32 stages of that solve run the fused
ADMM kernel (`loik_tpu_torch/kernels/csrc/fused_admm.cu`).

Phases (any failure raises, so the script exits nonzero):
  1. a CUDA device, and the card's name and power limit from nvidia-smi;
  2. the kernel library built with nvcc from the sources in the checkout,
     with the build time and ptxas' register and spill report;
  3. the double instantiation against the eager float64 loop at B=1024,
     check_interval 1 and 8: every state field within 1e-9 abs-or-rel,
     iterations and flags equal;
  4. the float instantiation against the eager float32 loop at B=16384 for
     max_iter 1, 2, 3 at check_interval 1, within 1e-4 abs-or-rel.  The
     kernel sums in the eager loop's order without FMA contraction, so the
     expected error is 0; 1e-4 is the bound for float32 reassociation;
  5. the main path: the launch count rises by 2, the outcome budget against
     the eager path (nu within 2e-5 where both converged, converged flags
     differing on at most max(1, B/100) problems, equal iteration counts on
     at least 99%), and, for every problem flagged converged, the task
     residual |A v - b|_inf and the box violation recomputed in float64 from
     (q, nu) at most 1e-5.  Then the kernel and the eager loop are run again
     on the inputs the main path gave each stage, compared and timed with
     CUDA events (median of 5 after a warm-up; the kernel's own device time
     from torch.profiler beside it).

The line before the last reports the kernel as JSON; the last line is the
run's verdict as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

FLAGSHIP_B = 16384
LINK = 6                   # panda_arm's end-effector joint
TARGET = (0.0, 0.0, 0.2, 0.0, 0.0, 0.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def flagship(lt, torch, dtype, device, B, check_interval, max_iter=200):
    """The flagship tree, problem, params and a seeded q batch."""
    tree = lt.robots.panda_arm(str(dtype).removeprefix("torch."), device=device)
    b = torch.tensor([TARGET], dtype=dtype)
    problem = lt.make_problem(
        tree, (LINK,), b=b, lb=-4.0 * torch.ones(tree.nv, dtype=dtype),
        ub=4.0 * torch.ones(tree.nv, dtype=dtype),
    )
    params = lt.SolverParams(
        max_iter=max_iter, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
        mu_equality_scale_factor=1e5, tail_solve=False,
        check_interval=check_interval,
    )
    gen = torch.Generator(device=device).manual_seed(0)
    q = tree.random_configuration((B,), generator=gen)
    return tree, problem, params, q


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


def kernel_device_ms(torch, fn):
    """Device time of the fused kernel itself in one call of fn, from
    torch.profiler (the CUDA-event times above also hold the wrapper's
    operand copies and host work); None if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
             if "fused_admm_kernel" in e.key)
    return us / 1e3 if us else None


def link_velocity(torch, sm, bsp, tree, q, nu, link):
    """Local-frame spatial velocity of `link` for joint velocities nu (B, nv):
    the kinematic recursion v_i = X_i^-1 v_parent + S_i nu_i from FK."""
    R, p = sm.fwd_pass_init(tree, q)                 # (N,3,3,B), (N,3,B)
    nu_t = nu.movedim(0, -1)                           # (nv, B)
    v = []
    for i in range(tree.njoints):
        par = tree.parents[i]
        v_par = v[par] if par >= 0 else nu_t.new_zeros((6, nu_t.shape[-1]))
        iv, k = tree.idx_v[i], tree.nvs[i]
        S = tree.joint_S(i)[:, :, None]                # (6, k, 1)
        v.append(bsp.act_inv_motion(R[i], p[i], v_par) + bsp.mv(S, nu_t[iv:iv + k]))
    return v[link].movedim(-1, 0)                      # (B, 6)


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
    import loik_tpu_torch.solver.solve  # noqa: F401  (the module, not the function)

    sm = sys.modules["loik_tpu_torch.solver.solve"]
    dev = torch.device("cuda")
    t_start = time.time()

    # ---- 1. the card ----------------------------------------------------
    card = card_line()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    log(card)

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

    # ---- 3. double instantiation vs eager float64 -------------------------
    for K in (1, 8):
        tree, problem, params, q = flagship(lt, torch, torch.float64, dev, 1024, K)
        prob, st = initial_state(sm, tree, problem, params, q)
        ker = fused_mod.fused_solve_loop(tree, params, prob, st)
        ref = sm._solve_loop(tree, prob, params, st)
        errs = state_errors(torch, fused_mod._STATE_FIELDS, ker, ref)
        worst = max(rel for _, rel in errs.values())
        log(f"[3] f64 B=1024 K={K}: worst abs-or-rel {worst:.3e}, "
            f"mean iterations {ref.iterations.double().mean():.2f}")
        if worst > 1e-9:
            raise AssertionError(f"f64 kernel vs eager K={K}: {errs}")

    # ---- 4. float instantiation vs eager float32, lockstep ------------------
    for mi in (1, 2, 3):
        tree, problem, params, q = flagship(lt, torch, torch.float32, dev,
                                            FLAGSHIP_B, 1, max_iter=mi)
        prob, st = initial_state(sm, tree, problem, params, q)
        ker = fused_mod.fused_solve_loop(tree, params, prob, st)
        ref = sm._solve_loop(tree, prob, params, st)
        errs = state_errors(torch, fused_mod._STATE_FIELDS, ker, ref)
        log(f"[4] f32 B={FLAGSHIP_B} max_iter={mi}: "
            + ", ".join(f"{k} {rel:.1e}" for k, (_, rel) in errs.items()))
        if max(rel for _, rel in errs.values()) > 1e-4:
            raise AssertionError(f"f32 lockstep max_iter={mi}: {errs}")

    # ---- 5. the main path ----------------------------------------------
    tree, problem, params, q = flagship(lt, torch, torch.float32, dev, FLAGSHIP_B, 8)
    solver = lt.DiffIkSolver(tree, params, (LINK,), problem=problem, fused="require")
    eager = lt.DiffIkSolver(tree, params, (LINK,), problem=problem, fused=False)

    captured = []                      # the kernel's inputs, stage by stage
    launch = fused_mod.fused_solve_loop

    def recording(tree_, params_, prob_, st_, batch_tile=None):
        captured.append((tree_, params_, prob_, st_, batch_tile))
        return launch(tree_, params_, prob_, st_, batch_tile)

    fused_mod.fused_solve_loop = recording
    fused_mod.LAUNCHES = 0
    res = solver.solve_refined(q, method="delta")
    torch.cuda.synchronize()
    launches = fused_mod.LAUNCHES
    fused_mod.fused_solve_loop = launch
    log(f"[5] main path B={FLAGSHIP_B}: kernel launches {launches}")
    if launches != 2 or len(captured) != 2:
        raise AssertionError(f"expected 2 kernel launches, got {launches}")

    res_e = eager.solve_refined(q, method="delta")
    conv, conv_e = res.converged, res_e.converged
    both = conv & conv_e
    nu_err = float((res.nu - res_e.nu)[both].abs().max())
    flag_diff = int((conv != conv_e).sum())
    it_eq = float((res.iterations == res_e.iterations).double().mean())
    log(f"    vs eager: nu max |diff| {nu_err:.3e} (converged in both), "
        f"flag diffs {flag_diff}, equal iteration counts {it_eq:.4f}, "
        f"all-problem nu max |diff| {float((res.nu - res_e.nu).abs().max()):.3e}")
    if not (nu_err <= 2e-5 and flag_diff <= max(1, FLAGSHIP_B // 100) and it_eq >= 0.99):
        raise AssertionError("outcome budget against the eager path not met")

    # certification honesty: recompute the task residual in float64 from (q, nu)
    tree64 = tree.astype(torch.float64)
    nu64 = res.nu.double()[conv]
    v = link_velocity(torch, sm, bsp, tree64, q.double()[conv], nu64, LINK)
    A = problem.A[0].double()
    b = problem.b[0].double()
    task = float((v @ A.T - b).abs().max())
    box = float(torch.clamp(torch.maximum(problem.lb.double() - nu64,
                                          nu64 - problem.ub.double()), min=0).max())
    log(f"    converged {float(conv.double().mean()):.4f}, mean iterations "
        f"{float(res.iterations.double().mean()):.2f}, f64 task residual "
        f"{task:.3e}, box violation {box:.3e} (max over converged)")
    if not (task <= 1e-5 and box <= 1e-5):
        raise AssertionError("a converged problem misses the task or the box")

    ms_path = cuda_median_ms(torch, lambda: solver.solve_refined(q, method="delta"))
    ms_eager_path = cuda_median_ms(torch, lambda: eager.solve_refined(q, method="delta"))
    log(f"    solve_refined: kernel path {ms_path:.3f} ms, eager path "
        f"{ms_eager_path:.3f} ms (median of 5, CUDA events)")

    # each stage's kernel against its plain version on the same inputs
    kernel_ms = plain_ms = 0.0
    worst_err = 0.0
    for stage, (tree_, params_, prob_, st_, bt) in enumerate(captured, 1):
        ker = launch(tree_, params_, prob_, st_, bt)
        ref = sm._solve_loop(tree_, prob_, params_, st_)
        err = max(a for a, _ in state_errors(torch, fused_mod._STATE_FIELDS,
                                             ker, ref).values())
        k_ms = cuda_median_ms(torch, lambda: launch(tree_, params_, prob_, st_, bt))
        p_ms = cuda_median_ms(torch, lambda: sm._solve_loop(tree_, prob_, params_, st_))
        dev_ms = kernel_device_ms(torch, lambda: launch(tree_, params_, prob_, st_, bt))
        log(f"    stage {stage}: fused_solve_loop {k_ms:.3f} ms (kernel alone "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'} on the "
            f"profiler), eager loop {p_ms:.3f} ms, max abs err {err:.3e}")
        kernel_ms, plain_ms, worst_err = kernel_ms + k_ms, plain_ms + p_ms, max(worst_err, err)
    if worst_err > 2e-5:
        raise AssertionError(f"kernel vs eager loop at the main path's inputs: {worst_err}")

    log(f"done in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "fused_admm",
        "route": "cuda",
        "source": "loik_tpu_torch/kernels/csrc/fused_admm.cu",
        "replaces": "loik_tpu/kernels/fused.py:62",
        "launches": launches,
        "max_abs_err": worst_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
