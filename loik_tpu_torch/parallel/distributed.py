"""Multi-process scale-out over `torch.distributed`.

Port of `loik_tpu.parallel.distributed`.  Every process (rank) holds its
block of one global problem batch and solves it on its own devices with
`sharding.solve_sharded`; problems are independent, so the only
communication is the reduction of the outcome metrics (`global_metrics`,
an `all_reduce` over the process group).  loik_tpu federates its processes
into one JAX runtime with global arrays; torch has none, so `solve_global`
returns this rank's rows.

The backend follows the device: NCCL for CUDA, gloo for the CPU.  That is a
choice, not a fallback: NCCL failing on the card raises.  Tested on the CPU
with N gloo processes (tests/test_torch_distributed.py).
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..model.tree import resolve_device
from ..params import SolverParams
from ..problem import IkProblem
from ..solver.state import SolveResult, SolverState
from .sharding import (Mesh, _indexed, make_mesh, metric_totals, metrics_from_totals,
                       solve_sharded, split_rows)

# how long the rendezvous and each collective may wait for the other ranks
# before they fail: a rank that never arrives raises instead of hanging
TIMEOUT = datetime.timedelta(seconds=120)

# this process's devices, set by `initialize`
_devices: Optional[tuple] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               device=None) -> None:
    """Join the process group (idempotent).

    coordinator_address: ``"host:port"`` of rank 0's rendezvous
      (``tcp://`` init); None reads torchrun's environment variables
      (``env://``).
    device: this process's device type (None: CUDA, with NCCL; "cpu": gloo).
    local_device_ids: this process's devices: the CUDA cards of those
      indices, or on the CPU that many repetitions of the CPU device (the
      analog of loik_tpu's virtual host devices).  None: the one ``device``.
    """
    global _devices
    if dist.is_initialized():
        return
    dev = _indexed(resolve_device(device))
    if local_device_ids is None:
        devices = (dev,)
    elif dev.type == "cuda":
        devices = tuple(torch.device("cuda", int(i)) for i in local_device_ids)
    else:
        devices = (dev,) * len(local_device_ids)
    backend = "nccl" if devices[0].type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=init, timeout=TIMEOUT, **kwargs)
    _devices = devices


def shutdown() -> None:
    """Leave the process group (end of program)."""
    global _devices
    if dist.is_initialized():
        dist.destroy_process_group()
    _devices = None


def process_count() -> int:
    """The world size (1 outside a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(axis_name: str = "batch") -> Mesh:
    """The mesh of this process's devices; the process group is the world
    around it (the global batch is the ranks' blocks in rank order)."""
    return make_mesh(_devices or (resolve_device(None),), axis_name)


def _tensor(x) -> torch.Tensor:
    """A tensor as it is; host data (numpy, lists) as a CPU tensor."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))


def from_local_batch(mesh: Mesh, local):
    """This rank's rows ``(B_local, ...)`` placed on its devices: one row
    block per mesh device, in mesh order."""
    return split_rows(mesh, _tensor(local))


def replicated(mesh: Mesh, arr):
    """Identical per-process host data, one copy per distinct mesh device
    (as a list in mesh order)."""
    x = _tensor(arr)
    copies = {d: x.to(d) for d in dict.fromkeys(mesh.devices)}
    return [copies[d] for d in mesh.devices]


def local_shard(x) -> np.ndarray:
    """Host numpy of this rank's rows: a tensor, or row blocks in mesh
    order."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.concatenate([t.detach().cpu().numpy() for t in x], axis=0)


def solve_global(tree, params: SolverParams, q_local, problem: IkProblem,
                 mesh: Optional[Mesh] = None,
                 warm_state: Optional[SolverState] = None,
                 axis_name: str = "batch") -> SolveResult:
    """Solve this rank's block of one global batch.

    Args:
      q_local: this process's ``(B_local, nq)`` configurations (the global
        batch is every rank's block in rank order).
      problem: leaves either unbatched (shared) or with a leading
        ``B_local`` batch axis (split like ``q_local``).

    The global batch, B_local x the world size, must divide by the global
    mesh size, this mesh's size x the world size, that is B_local by this
    mesh's size (`solve_sharded` raises ValueError otherwise).  Returns a
    SolveResult of THIS RANK'S ROWS on the mesh's first device, not a
    gathered global array: torch has no global array.  `global_metrics` aggregates over
    the ranks."""
    if mesh is None:
        mesh = global_mesh(axis_name)
    return solve_sharded(tree, params, _tensor(q_local), problem, mesh, warm_state)


def global_metrics(result: SolveResult):
    """`convergence_metrics` over every rank's rows, as host scalars that
    are identical on every rank: the totals of `metric_totals` (float64
    sums of integers, exact) reduced by one `all_reduce`, the maximum by
    another, then formed into the metrics as `convergence_metrics` does."""
    sums, top = metric_totals(result)
    top = top.reshape(1)
    if dist.is_initialized():
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
    m = metrics_from_totals(sums, top[0])
    return {k: v.item() for k, v in m.items()}
