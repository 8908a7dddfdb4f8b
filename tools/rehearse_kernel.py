#!/usr/bin/env python3
"""Rehearse the fused ADMM CUDA kernel on the host, without a card.

    python3 tools/rehearse_kernel.py [--paths panda_arm mixed solo12 talos]
                                     [--B 8] [--tiles 4 3] [--dtypes float32 float64]

Compiles `loik_tpu_torch/kernels/csrc/fused_admm.cu` with g++
(`-ffp-contract=off`, so no multiply-add is fused, like nvcc's
`-fmad=false`) against the stand-in `tools/rehearse/cuda_runtime.h`, which
turns every phase of a group into a loop over the group's lanes.  The
library is loaded through the real ctypes wrapper
(`loik_tpu_torch.kernels.fused._launch`) on CPU tensors and compared with
the eager loop `solver.solve._solve_loop` on every state field, bit for
bit, in float32 and float64, with the lanes of a phase run in ascending and
in descending order (a phase that is right in one order only is missing a
synchronisation), at check_interval 1 and one larger, and with a block
size that leaves a ragged last block; then a warm second tick, and the
delta-duals solve with both of its stages through the build.

What it cannot show: that nvcc accepts the source, how the card schedules
the lanes, or any time.  Prints one line per case and exits nonzero on the
first difference.  Needs g++.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB_DIR = os.path.join(ROOT, "tools", "rehearse")
GXX_FLAGS = ("-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-x", "c++")
# the host compiler (None: no rehearsal here)
GXX = shutil.which("g++")
PATHS = ("panda_arm", "mixed", "solo12", "talos")


def build(out_dir: str, source: str = "fused_admm.cu") -> str:
    """Compile ``source``, a file of `loik_tpu_torch/kernels/csrc/`, for the
    host against the stand-in `cuda_runtime.h`; returns the library's
    path.  The tests bind it through the kernel's wrapper (`fk._bind`,
    `kkt64._bind`) as `rehearse` binds the fused kernel's."""
    if GXX is None:
        raise RuntimeError("rehearse_kernel: g++ not found")
    src = os.path.join(ROOT, "loik_tpu_torch", "kernels", "csrc", source)
    out = os.path.join(out_dir, f"lib{os.path.splitext(source)[0]}_rehearsal.so")
    cmd = [GXX, *GXX_FLAGS, f"-I{STUB_DIR}", "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return out


def case(name: str, dtype, B: int, check_interval: int, max_iter: int = 200):
    """(tree, params, prepared problem, reset state with FK) of one of
    chip_smoke.py's configurations at batch B on the CPU, q from a seed."""
    import torch

    import chip_smoke
    import loik_tpu_torch as lt
    import loik_tpu_torch.solver.solve  # noqa: F401  (the module, not the function)
    from loik_tpu_torch.kernels import fused

    sm = sys.modules["loik_tpu_torch.solver.solve"]
    dev = torch.device("cpu")
    if name == "mixed":
        mp, groups, params = chip_smoke.mixed_setup(
            lt, torch, dtype, B // 2, check_interval, max_iter, device=dev)
        q = mp.pack_q([q for _, q, _ in groups])
        prob, st = chip_smoke.initial_state(sm, mp.chain, mp.problem, params, q)
        return mp.chain, params, fused.with_S_all(mp.chain, prob, dtype), st
    cfg = "flagship" if name == "panda_arm" else name
    tree, _, problem, params, q = chip_smoke.config(
        lt, torch, cfg, dtype, dev, B, check_interval, max_iter)
    prob, st = chip_smoke.initial_state(sm, tree, problem, params, q)
    return tree, params, prob, st


def compare(lib, name: str, dtype, B: int, check_interval: int, tile: int,
            descending: bool, warm: bool = False) -> str:
    """One launch of the host build against the eager loop; returns a
    report line, raises AssertionError naming the first field that differs.
    ``warm``: a second launch from the first one's state with the target
    changed, as a tracking tick does."""
    import torch

    from loik_tpu_torch.kernels import fused

    sm = sys.modules["loik_tpu_torch.solver.solve"]
    tree, params, prob, st = case(name, dtype, B, check_interval)
    os.environ["LOIK_REHEARSAL_DESCENDING"] = "1" if descending else "0"
    if warm:
        params = params.replace(tol_abs=1e-4, tol_rel=1e-4, warm_start=True)
    got = want = None
    for tick in range(2 if warm else 1):
        if tick:
            # the next tick: the last state, running again, a moved target
            prob = dataclasses.replace(prob, b=prob.b * 0.9, Atb=prob.Atb * 0.9)
            st_k = sm._reset_state(tree, params, got, dtype)
            st_e = sm._reset_state(tree, params, want, dtype)
        else:
            st_k = st_e = st
        got = fused._launch(tree, params, prob, st_k, tile, lib=lib)
        want = sm._solve_loop(tree, prob, params, st_e)
        for field in fused._STATE_FIELDS:
            a, b = getattr(got, field), getattr(want, field)
            if not torch.equal(a, b):
                n = int((a != b).sum())
                raise AssertionError(
                    f"{name} {dtype} B={B} K={check_interval} tile={tile} "
                    f"{'descending' if descending else 'ascending'} tick {tick}: "
                    f"{field} differs on {n} of {a.numel()} entries")
    its = want.iterations
    return (f"{name:9s} {str(dtype).removeprefix('torch.'):7s} B={B} K={check_interval} "
            f"tile={tile} {'desc' if descending else 'asc '}{' warm' if warm else ''}: "
            f"equal on {len(fused._STATE_FIELDS)} fields, iterations "
            f"{int(its.min())}..{int(its.max())}, converged "
            f"{float(want.converged.double().mean()):.2f}")


def compare_delta(lib, name: str, B: int, check_interval: int, tile: int) -> str:
    """The delta-duals solve with both float32 stages through the host build
    (stage 2 carries r_offset and the tolerance floors) against the same
    solve through the eager loop; every state field equal."""
    import torch

    import chip_smoke
    import loik_tpu_torch as lt
    from loik_tpu_torch.kernels import fused

    os.environ["LOIK_REHEARSAL_DESCENDING"] = "0"
    tree, _, problem, params, q = chip_smoke.config(
        lt, torch, "flagship" if name == "panda_arm" else name, torch.float32,
        torch.device("cpu"), B, check_interval)
    want = lt.solve_delta_duals(tree, params, q, problem, fused=False)
    eager, calls = fused._solve_loop, []

    def through_the_build(tree_, prob_, params_, st_):
        calls.append(prob_.r_offset is not None)
        return fused._launch(tree_, params_, prob_, st_, tile, lib=lib)

    fused._solve_loop = through_the_build     # what fused_solve_loop runs on CPU tensors
    try:
        got = lt.solve_delta_duals(tree, params, q, problem, fused="require")
    finally:
        fused._solve_loop = eager
    if calls != [False, True]:
        raise AssertionError(f"expected stage 1 and stage 2 through the build, got {calls}")
    for field in fused._STATE_FIELDS:
        if not torch.equal(getattr(got.state, field), getattr(want.state, field)):
            raise AssertionError(f"{name} delta-duals B={B} K={check_interval}: {field} differs")
    if not torch.equal(got.nu, want.nu):
        raise AssertionError(f"{name} delta-duals B={B} K={check_interval}: nu differs")
    return (f"{name:9s} delta-duals B={B} K={check_interval} tile={tile}: both stages equal, "
            f"converged {float(want.converged.double().mean()):.2f}")


def rehearse(paths=PATHS, B=8, tiles=(4, 3), dtypes=("float32", "float64"),
             log=print) -> int:
    """Build once, run every case; returns the number of cases compared."""
    import torch

    sys.path.insert(0, ROOT)
    from loik_tpu_torch.kernels import fused

    intervals = {"panda_arm": (1, 8), "mixed": (1, 4), "solo12": (1, 4), "talos": (1,)}
    n = 0
    with tempfile.TemporaryDirectory() as tmp:
        lib = fused._bind(ctypes.CDLL(build(tmp)))
        for name in paths:
            for ds in dtypes:
                dtype = getattr(torch, ds)
                for K in intervals[name]:
                    for tile in tiles:
                        for descending in (False, True):
                            log(compare(lib, name, dtype, B, K, tile, descending))
                            n += 1
                if name == "panda_arm":
                    log(compare(lib, name, dtype, B, 1, tiles[0], False, warm=True))
                    n += 1
            if name != "mixed" and "float32" in dtypes:
                log(compare_delta(lib, name, B, intervals[name][-1], tiles[0]))
                n += 1
    return n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", nargs="+", default=list(PATHS), choices=PATHS)
    ap.add_argument("--B", type=int, default=8)
    ap.add_argument("--tiles", nargs="+", type=int, default=[4, 3])
    ap.add_argument("--dtypes", nargs="+", default=["float32", "float64"])
    args = ap.parse_args()
    n = rehearse(args.paths, args.B, tuple(args.tiles), tuple(args.dtypes))
    print(f"rehearsal: {n} cases equal to the eager loop bit for bit")


if __name__ == "__main__":
    main()
