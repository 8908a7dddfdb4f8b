"""Multi-device scale-out over a 1-D batch mesh.

Port of `loik_tpu.parallel.sharding`.  Problems are independent, so the
scale-out is a split of the problem batch: each device of the mesh solves
its contiguous block of rows, and the blocks are gathered in mesh order on
the mesh's first device.  loik_tpu gets the same from `jax.sharding` (one
SPMD program, XLA's collectives); torch has no global array, so here each
distinct device of the mesh runs its own solve of all its rows, on a host
thread of its own when there are several, and the results are joined
before the gather.

A mesh may repeat a device: ``make_mesh(["cpu"] * 8)`` is the port's
analog of `--xla_force_host_platform_device_count=8`, and
``make_mesh(["cuda:0"] * 4)`` splits a batch four ways on one card.  A
repeated device holds several blocks of rows and solves them as one batch,
so that such a mesh costs what one solve of the whole batch costs.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import torch

from ..params import SolverParams
from ..problem import IkProblem
from ..solver import solve
from ..solver.state import LOG_FIELDS, SolveResult, SolverState


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: the devices in mesh order and the axis name."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "batch"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (self.axis_name,)


def _indexed(device: torch.device) -> torch.device:
    """"cuda" as the current card's index, so that equal devices compare
    equal (a tensor made on "cuda" reports "cuda:0")."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(devices=None, axis_name: str = "batch") -> Mesh:
    """1-D mesh over every visible CUDA device, or over ``devices`` (names
    or `torch.device`s, repeats allowed).  No probing and no CPU fallback:
    with no argument and no card it raises."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "make_mesh(): no CUDA device is visible; pass devices "
                "explicitly (e.g. make_mesh(['cpu'] * 8)) to run elsewhere")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(_indexed(torch.device(d)) for d in devices)
    if not devices:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(devices, axis_name)


def _check_divisible(B: int, mesh: Mesh) -> None:
    if B % mesh.size:
        raise ValueError(f"batch {B} not divisible by mesh size {mesh.size}")


def _device_blocks(mesh: Mesh):
    """{device: its mesh positions}, devices in order of first appearance."""
    out: dict = {}
    for i, d in enumerate(mesh.devices):
        out.setdefault(d, []).append(i)
    return out


def _rows(x: torch.Tensor, blocks, n: int, dim: int = 0) -> torch.Tensor:
    """The mesh blocks ``blocks`` (``n`` rows each) of ``x`` along ``dim``,
    joined in order; consecutive blocks are one slice (a view)."""
    runs: list = []
    for i in blocks:
        if runs and runs[-1][1] == i * n:
            runs[-1][1] += n
        else:
            runs.append([i * n, (i + 1) * n])
    parts = [x.narrow(dim, a, b - a) for a, b in runs]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def split_rows(mesh: Mesh, x: torch.Tensor):
    """Row blocks of ``x`` (leading axis B, divisible by the mesh size), one
    per mesh device, in mesh order."""
    _check_divisible(x.shape[0], mesh)
    n = x.shape[0] // mesh.size
    return [_rows(x, [i], n).to(d) for i, d in enumerate(mesh.devices)]


def _problem_rows(problem: IkProblem, B: int, blocks, n: int, dev, copies: dict):
    """``problem`` for the mesh blocks ``blocks`` on ``dev``: a leaf with a
    leading batch axis B is split like q (`P("batch")` in loik_tpu); a
    shared leaf is copied to each device once (`P()`), through ``copies``."""

    def place(leaf, core_ndim):
        if leaf.ndim > core_ndim and leaf.shape[0] == B:
            return _rows(leaf, blocks, n).to(dev)
        if (id(leaf), dev) not in copies:
            copies[id(leaf), dev] = leaf.to(dev)
        return copies[id(leaf), dev]

    return IkProblem(
        H_ref=place(problem.H_ref, 3), v_ref=place(problem.v_ref, 2),
        A=place(problem.A, 3), b=place(problem.b, 2),
        lb=place(problem.lb, 1), ub=place(problem.ub, 1),
        constraint_links=problem.constraint_links)


def shard_problem_batch(mesh: Mesh, q, problem: IkProblem):
    """Per mesh device, in mesh order, that shard's ``(q rows, problem)``."""
    q = torch.as_tensor(q)
    rows = split_rows(mesh, q)
    n, copies = q.shape[0] // mesh.size, {}
    return [(rows[i], _problem_rows(problem, q.shape[0], [i], n, dev, copies))
            for i, dev in enumerate(mesh.devices)]


def _state_rows(st: SolverState, blocks, n: int, dev) -> SolverState:
    """A warm state's per-problem fields (batch on the LAST axis) for the
    mesh blocks ``blocks`` on ``dev``; the scalar loop counter as it is."""
    upd = {}
    for f in dataclasses.fields(st):
        x = getattr(st, f.name)
        if isinstance(x, torch.Tensor):
            upd[f.name] = (_rows(x, blocks, n, -1) if x.ndim else x).to(dev)
    return dataclasses.replace(st, **upd)


def _map_batched(obj, fn, batch_dim):
    """``obj`` (a result or state) with ``fn(x, dim)`` applied to every
    field that has a batch axis (``batch_dim(name)``; a nested state's is
    the last)."""
    upd = {}
    for f in dataclasses.fields(obj):
        x = getattr(obj, f.name)
        if isinstance(x, SolverState):
            upd[f.name] = _map_batched(x, fn, lambda name: -1)
        elif isinstance(x, torch.Tensor) and x.ndim:
            upd[f.name] = fn(x, batch_dim(f.name))
    return dataclasses.replace(obj, **upd)


def gather_shards(parts, device: torch.device, batch_dim):
    """The shards' results (or states) joined along the batch axis on
    ``device``: ``batch_dim(name)`` gives each field's batch axis; a scalar
    (the loop counter) is the largest shard's."""
    upd = {}
    for f in dataclasses.fields(parts[0]):
        xs = [getattr(p, f.name) for p in parts]
        if xs[0] is None:
            continue
        if isinstance(xs[0], SolverState):
            upd[f.name] = gather_shards(xs, device, lambda name: -1)
            continue
        xs = [x.to(device) for x in xs]
        upd[f.name] = (torch.stack(xs).amax(0) if xs[0].ndim == 0
                       else torch.cat(xs, batch_dim(f.name)))
    return dataclasses.replace(parts[0], **upd)


def _result_batch_dim(name: str) -> int:
    """A SolveResult field's batch axis: leading, except the (max_iter, B)
    logs."""
    return -1 if name in LOG_FIELDS else 0


def _on_device(dev: torch.device, fn, args):
    """``fn(*args)`` with ``dev`` the current card (when it is one)."""
    if dev.type != "cuda":
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def run_sharded(tree, params: SolverParams, q, problem: IkProblem, mesh: Mesh,
                warm_state: Optional[SolverState] = None, solve_fn=None) -> SolveResult:
    """``solve_fn(tree, params, q, problem[, warm_state])`` (default
    `solve`) over the mesh, the results gathered in mesh order on the first
    device.

    Each distinct device solves the rows of all its mesh blocks as one
    batch (a device the mesh repeats holds several blocks, as a device of
    a global array holds all its rows), with the device current and on its
    current stream.  With more than one distinct device each runs on a host
    thread of its own, so that one card's host work (its graph's copies
    and replay, or, launched eagerly, the loop that reads `running.any()`
    after every body call) does not hold back the others' launches; all
    are joined before the gather."""
    run = solve_fn or solve
    q = torch.as_tensor(q)
    B = q.shape[0]
    _check_divisible(B, mesh)
    if warm_state is not None and warm_state.vis.shape[-1] != B:
        raise ValueError(
            f"warm state of batch {warm_state.vis.shape[-1]} for a batch of {B}")
    n, copies = B // mesh.size, {}
    groups = _device_blocks(mesh)
    jobs = []
    for dev, blocks in groups.items():
        args = [tree.to(dev), params, _rows(q, blocks, n).to(dev),
                _problem_rows(problem, B, blocks, n, dev, copies)]
        if warm_state is not None:
            args.append(_state_rows(warm_state, blocks, n, dev))
        jobs.append((dev, args))
    if len(jobs) == 1:
        parts = [_on_device(jobs[0][0], run, jobs[0][1])]
    else:
        with ThreadPoolExecutor(len(jobs)) as pool:
            futures = [pool.submit(_on_device, dev, run, args) for dev, args in jobs]
            parts = [f.result() for f in futures]
    out = gather_shards(parts, mesh.devices[0], _result_batch_dim)
    # `out` holds the blocks device by device; put them back in mesh order
    order = [i for blocks in groups.values() for i in blocks]
    if order != sorted(order):
        pos = {i: p for p, i in enumerate(order)}
        idx = torch.cat([torch.arange(pos[i] * n, (pos[i] + 1) * n)
                         for i in range(mesh.size)]).to(mesh.devices[0])
        out = _map_batched(out, lambda x, dim: x.index_select(dim % x.ndim, idx),
                           _result_batch_dim)
    return out


def solve_sharded(tree, params: SolverParams, q, problem: IkProblem,
                  mesh: Optional[Mesh] = None,
                  warm_state: Optional[SolverState] = None,
                  axis_name: str = "batch") -> SolveResult:
    """Batch-data-parallel solve across a device mesh.

    The batch must be divisible by the mesh size.  Each device solves its
    blocks of rows with `solver.solve` (`run_sharded`); returns ONE SolveResult with the rows
    in mesh order on the mesh's first device (the port's reading of
    loik_tpu's global array).  A warm state is split the same way."""
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    return run_sharded(tree, params, q, problem, mesh, warm_state)


def metric_totals(result: SolveResult):
    """What `convergence_metrics` is formed from, on the result's device:
    float64 sums (exact for integer counts) [converged, primal infeasible,
    iterations, problems, iterations of the converged] and the int64
    largest iteration count."""
    conv = result.converged
    it = result.iterations.to(torch.float64)
    sums = torch.stack([conv.to(torch.float64).sum(),
                        result.primal_infeasible.to(torch.float64).sum(),
                        it.sum(), it.new_tensor(float(it.numel())),
                        torch.where(conv, it, 0.0).sum()])
    return sums, result.iterations.max().to(torch.int64)


def convergence_metrics(result: SolveResult):
    """Aggregate per-problem outcomes, computed on the result's device.
    The means are float64: a sum of iteration counts is exact there, so the
    mean is one rounding of the exact quotient (loik_tpu's are float32)."""
    return metrics_from_totals(*metric_totals(result))


def metrics_from_totals(sums: torch.Tensor, top: torch.Tensor):
    """`convergence_metrics` from `metric_totals` (of one result, or
    reduced over several)."""
    n_conv, n_pinf, it_sum, count, it_conv_sum = sums.unbind()
    return {
        "num_converged": n_conv.to(torch.int64),
        "num_primal_infeasible": n_pinf.to(torch.int64),
        "mean_iterations": it_sum / count,
        "max_iterations": top,
        "mean_iterations_converged": it_conv_sum / n_conv.clamp_min(1),
    }
