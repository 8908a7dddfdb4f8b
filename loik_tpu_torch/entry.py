"""Entry points of the port: a one-device solve check and a multi-device
dry run, the counterparts of the repository's `__graft_entry__.py`
(`entry`, `dryrun_multichip`), on the card unless a device is given.

    python -c "from loik_tpu_torch.entry import dryrun_multichip; dryrun_multichip(1)"
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch

from .kernels.fused import solve_fused
from .model import robots
from .model.tree import resolve_device
from .params import SolverParams
from .parallel.sharding import (convergence_metrics, gather_shards, make_mesh,
                                shard_problem_batch, solve_sharded)
from .problem import make_problem
from .solver import solve
from .solver.stream import solve_stream


def _flagship(device, dtype_str="float32"):
    """The flagship task: panda_arm, one 6-D end-effector constraint
    (v_z = 0.2), box +-4, tol 1e-6, max_iter 100."""
    tree = robots.panda_arm(dtype_str, device=device)
    b = np.zeros((1, 6))
    b[0, 2] = 0.2
    problem = make_problem(tree, (tree.njoints - 1,), b=b,
                           lb=-4 * np.ones(tree.nv), ub=4 * np.ones(tree.nv))
    params = SolverParams(max_iter=100, tol_abs=1e-6, tol_rel=1e-6)
    return tree, params, problem


def _seeds(tree, B: int, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=tree.device).manual_seed(seed)
    return tree.random_configuration((B,), generator=gen)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def entry(device=None):
    """(fn, example_args): the batched flagship solve at B=128.  ``fn(q)``
    returns (nu, converged, iterations); on the card the ADMM loop is the
    fused CUDA kernel (`solve_fused`), on the CPU its eager loop."""
    tree, params, problem = _flagship(resolve_device(device))
    qs = _seeds(tree, 128, 0)

    def fn(q):
        res = solve_fused(tree, params, q, problem)
        return res.nu, res.converged, res.iterations

    return fn, (qs,)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The flagship solve over an n-device 1-D batch mesh, held against one
    device: `solve_sharded` parity (nu atol 2e-5, at most max(1, B/100)
    converged-flag differences, no iteration count off by more than 1),
    three warm `solve_stream` ticks on the sharded fleet against the
    unsharded stream (2e-5), and an equal-work timing check (median of 5
    interleaved runs: the mesh within 2x of one solve of the whole batch
    on one device).  Prints and returns the JSON summary.

    device=None meshes the first ``n_devices`` CUDA cards and raises when
    fewer are visible; a device given (e.g. "cpu") is repeated
    ``n_devices`` times."""
    if device is None:
        have = torch.cuda.device_count()
        if have < n_devices:
            raise ValueError(f"need {n_devices} devices, have {have}")
        mesh = make_mesh([torch.device("cuda", i) for i in range(n_devices)])
    else:
        mesh = make_mesh([device] * n_devices)
    dev0 = mesh.devices[0]
    tree, params, problem = _flagship(dev0)
    params = params.replace(max_iter=8)  # tiny: one step of the whole path
    B = 2 * n_devices
    qs = _seeds(tree, B, 1)
    res = solve_sharded(tree, params, qs, problem, mesh)
    m = convergence_metrics(res)
    nu = res.nu.cpu().numpy()
    if nu.shape != (B, tree.nv) or not np.all(np.isfinite(nu)):
        raise AssertionError(f"sharded nu: shape {nu.shape}, finite {np.isfinite(nu).all()}")
    if res.nu.device != dev0:
        raise AssertionError(f"sharded result on {res.nu.device}, not {dev0}")

    # sharding cannot change the math: every solver reduction is per problem
    ref = solve(tree, params, qs, problem)
    np.testing.assert_allclose(nu, ref.nu.cpu().numpy(), rtol=2e-5, atol=2e-5)
    conv_diff = int((res.converged != ref.converged).sum())
    it_diff = (res.iterations.long() - ref.iterations.long()).abs()
    if conv_diff > max(1, B // 100):
        raise AssertionError(
            f"sharded vs single-device converged flags differ on {conv_diff}/{B}")
    if int((it_diff > 1).sum()):
        raise AssertionError(
            f"sharded vs single-device iteration counts differ by >1 on "
            f"{int((it_diff > 1).sum())}/{B} problems")
    print(f"dryrun_multichip OK: {n_devices} devices, B={B}, "
          f"converged={int(m['num_converged'])}, "
          f"mean_iters={float(m['mean_iterations']):.1f}, parity vs single-device: "
          f"nu atol 2e-5, flags/iters within budget ({conv_diff} flag diffs, "
          f"{int(it_diff.max())} max iter delta)", flush=True)

    # ---- a tracking stream on the sharded fleet: 3 warm ticks ------------
    b_seq = np.zeros((3, 6))
    b_seq[:, 2] = [0.2, 0.15, 0.1]
    sp = params.replace(warm_start=True)
    stream_ref = solve_stream(tree, sp, qs, problem, 0, b_seq)
    parts = [solve_stream(tree.to(q_i.device), sp, q_i, prob_i, 0, b_seq)
             for q_i, prob_i in shard_problem_batch(mesh, qs, problem)]
    stream_sh = gather_shards(parts, dev0, lambda name: 1)
    np.testing.assert_allclose(stream_sh.nu.cpu().numpy(), stream_ref.nu.cpu().numpy(),
                               atol=2e-5)
    print(f"stream OK: 3 ticks x B={B} over {n_devices} devices, parity vs "
          "unsharded at 2e-5", flush=True)

    # ---- equal work on the mesh and on one device ------------------------
    # The same problems on the mesh and in one solve on its first device,
    # median of 5 interleaved runs.  The gate is loik_tpu's: the sharded
    # path adds no serialization point (mesh within 2x of one device).  The
    # shards solved one after another on the first device, which a mesh of
    # repeated devices would cost if each shard were its own solve, are
    # timed beside them and reported, not gated.
    B_per = 256
    qsn = _seeds(tree, B_per * n_devices, 3)
    shards = [(q_i.to(dev0), prob_i) for q_i, prob_i in
              shard_problem_batch(make_mesh([dev0] * n_devices), qsn, problem)]

    def timed(fn):
        _sync(dev0)
        t0 = time.perf_counter()
        fn()
        _sync(dev0)
        return time.perf_counter() - t0

    runs = {
        "whole": lambda: solve(tree, params, qsn, problem),
        "mesh": lambda: solve_sharded(tree, params, qsn, problem, mesh),
        "shards": lambda: [solve(tree, params, q_i, p_i) for q_i, p_i in shards],
    }
    times = {k: [] for k in runs}
    for fn in runs.values():
        fn()
    for _ in range(5):  # interleaved, so that all three share transient noise
        for k, fn in runs.items():
            times[k].append(timed(fn))
    t1, tn, ts = (statistics.median(times[k]) for k in ("whole", "mesh", "shards"))
    scaling = {
        "devices": n_devices,
        "device": str(dev0),
        "total_problems": B_per * n_devices,
        "t_single_device_median_s": t1,
        "t_mesh_median_s": tn,
        "t_shards_one_after_another_median_s": ts,
        "no_serialization_ok": bool(tn <= 2.0 * t1),
    }
    if not scaling["no_serialization_ok"]:
        raise AssertionError(f"equal-work check: {scaling}")
    summary = {
        "ok": True,
        "parity": {"nu_atol": 2e-5, "converged_flag_diffs": conv_diff,
                   "max_iter_delta": int(it_diff.max())},
        "scaling": scaling,
    }
    print(json.dumps(summary), flush=True)
    return summary
