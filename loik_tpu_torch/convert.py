"""Carry trees, problems and solver states across from `loik_tpu`.

The arguments are the JAX package's objects, taken duck-typed: every array
leaf goes through `np.asarray` and static fields are copied, so this module
(like the whole package) never imports jax.  The tests use it so that both
packages compute on the same tree, problem and warm state; `state_to_numpy`
goes the other way for comparisons.  ``device=None`` is the CUDA device,
as everywhere in the package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .model.tree import KinematicTree, resolve_device
from .parallel.mixed import MixedPadded
from .problem import IkProblem
from .solver.state import SolverState

_EXACT_DTYPES = {np.dtype(bool): torch.bool, np.dtype(np.int32): torch.int32}


def _tensor(x, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    device = resolve_device(device)
    a = np.array(x)  # a writable copy (jax arrays export read-only buffers)
    if a.dtype in _EXACT_DTYPES:
        return torch.as_tensor(a, dtype=_EXACT_DTYPES[a.dtype], device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def tree_from_arrays(tree, device=None, dtype: Optional[torch.dtype] = None) -> KinematicTree:
    """A port tree from a `loik_tpu` KinematicTree: same topology, leaves
    (batched (N, B, ...) geometry leaves included), joint codes and static
    extras (pitches, mimic metadata)."""
    def leaf(x):
        return None if x is None else _tensor(x, device, dtype)

    return KinematicTree(
        placement_R=leaf(tree.placement_R),
        placement_p=leaf(tree.placement_p),
        axis=leaf(tree.axis),
        velocity_limit=leaf(tree.velocity_limit),
        parents=tuple(int(p) for p in tree.parents),
        jtypes=tuple(int(t) for t in tree.jtypes),
        idx_v=tuple(int(i) for i in tree.idx_v),
        idx_q=tuple(int(i) for i in tree.idx_q),
        joint_names=tuple(tree.joint_names),
        name=tree.name,
        axis2=leaf(tree.axis2),
        pitches=None if tree.pitches is None else tuple(float(h) for h in tree.pitches),
        mimic=None if tree.mimic is None else tuple(
            None if m is None else (int(m[0]), int(m[1]), float(m[2]), float(m[3]))
            for m in tree.mimic),
        placement2_R=leaf(tree.placement2_R),
        placement2_p=leaf(tree.placement2_p),
    )


def problem_from_arrays(problem, device=None,
                        dtype: Optional[torch.dtype] = None) -> IkProblem:
    """A port IkProblem from a `loik_tpu` IkProblem."""
    return IkProblem(
        H_ref=_tensor(problem.H_ref, device, dtype),
        v_ref=_tensor(problem.v_ref, device, dtype),
        A=_tensor(problem.A, device, dtype),
        b=_tensor(problem.b, device, dtype),
        lb=_tensor(problem.lb, device, dtype),
        ub=_tensor(problem.ub, device, dtype),
        constraint_links=tuple(int(c) for c in problem.constraint_links),
    )


def mixed_from_arrays(mp, device=None,
                      dtype: Optional[torch.dtype] = None) -> MixedPadded:
    """A port MixedPadded from a `loik_tpu` MixedPadded: its batched-geometry
    chain, its combined problem and the group bookkeeping."""
    return MixedPadded(
        chain=tree_from_arrays(mp.chain, device, dtype),
        problem=problem_from_arrays(mp.problem, device, dtype),
        group_sizes=tuple(int(b) for b in mp.group_sizes),
        group_njoints=tuple(int(n) for n in mp.group_njoints),
    )


def state_from_arrays(state, device=None,
                      dtype: Optional[torch.dtype] = None) -> SolverState:
    """A port SolverState from a `loik_tpu` SolverState: every field the
    port has, the per-iteration logs of a logged state included, bool and
    int32 fields kept exact, floating fields in ``dtype`` (default: as
    given)."""
    vals = {}
    for f in dataclasses.fields(SolverState):
        x = getattr(state, f.name, None)
        if x is not None:
            vals[f.name] = _tensor(x, device, dtype)
    return SolverState(**vals)


def state_to_numpy(st: SolverState) -> Dict[str, np.ndarray]:
    """Every non-None field of a port state (the logs of a logged one
    included) as a numpy array."""
    return {f.name: getattr(st, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(st) if getattr(st, f.name) is not None}
