"""Checkpoint / resume for solver state.

Port of `loik_tpu.utils.checkpoint`.  The reference has no serialization in
active use (its data structs inherit `pinocchio::serialization::Serializable`
but nothing in-repo calls it, loik-loid-data.hpp:61).  Here the solver state
is a dataclass of tensors, so a checkpoint is a field -> tensor dict written
with `torch.save`: save mid-run (e.g. a long multi-start campaign), restore
on another host or device, and continue via warm start.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..solver.state import SolverState


def save_state(path: str, state: SolverState) -> None:
    """Write every non-None field of ``state`` (as CPU tensors) to ``path``."""
    fields = {f.name: getattr(state, f.name).detach().cpu()
              for f in dataclasses.fields(state) if getattr(state, f.name) is not None}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(fields, path)


def load_state(path: str, like: SolverState) -> SolverState:
    """Restore a state saved by `save_state`, on ``like``'s device.  ``like``
    (e.g. from `init_state` with the same shapes) gives the field names,
    shapes and dtypes the file must have; a mismatch raises ValueError."""
    want = {f.name: getattr(like, f.name) for f in dataclasses.fields(like)
            if getattr(like, f.name) is not None}
    data = torch.load(path, map_location=like.mu.device, weights_only=True)
    if set(data) != set(want):
        raise ValueError(
            f"load_state: {path} has fields {sorted(set(data) - set(want))} that "
            f"`like` lacks and lacks {sorted(set(want) - set(data))}")
    for name, x in data.items():
        if x.shape != want[name].shape or x.dtype != want[name].dtype:
            raise ValueError(
                f"load_state: field {name} is {x.dtype} {tuple(x.shape)} in {path}, "
                f"{want[name].dtype} {tuple(want[name].shape)} in `like`")
    return dataclasses.replace(like, **data)
