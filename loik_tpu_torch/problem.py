"""Problem specification: the port of `loik_tpu.problem`.

Per-link tracking weights/targets, hard 6-D task equality constraints at a
static set of links, and joint-velocity box bounds (`IkProblemFormulation`,
ik-id-description.hpp:16-338).  Constraint *links* are static metadata;
constraint *values* (A, b) are tensors that per-tick updates replace.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class IkProblem:
    """One constrained diff-IK problem (batch via one leading dim on leaves).

    minimize   sum_i 1/2 (v_i - v_ref_i)^T H_ref_i (v_i - v_ref_i)
    over       v_i (link spatial velocities, local frames), nu (joint vel)
    s.t.       v_i = iXp v_parent(i) + S_i nu_i        (kinematics)
               A_c v_{c} = b_c   for c in constraint_links
               lb <= nu <= ub
    """

    H_ref: torch.Tensor  # (..., N, 6, 6)
    v_ref: torch.Tensor  # (..., N, 6)
    A: torch.Tensor      # (..., NC, 6, 6)
    b: torch.Tensor      # (..., NC, 6)
    lb: torch.Tensor     # (..., nv)
    ub: torch.Tensor     # (..., nv)
    constraint_links: Tuple[int, ...]  # static: moving-joint indices (0-based)

    @property
    def num_constraints(self) -> int:
        return len(self.constraint_links)

    def replace(self, **kw) -> "IkProblem":
        return dataclasses.replace(self, **kw)

    def update_constraint(self, slot: int, A=None, b=None) -> "IkProblem":
        """Tailored single-constraint update (`UpdateEqConstraint`,
        ik-id-description-optimized.hpp:178-238): a new problem with the
        same shapes; the old one is left unchanged."""
        new = self
        if A is not None:
            A_new = new.A.clone()
            A_new[..., slot, :, :] = torch.as_tensor(A, dtype=A_new.dtype,
                                                     device=A_new.device)
            new = new.replace(A=A_new)
        if b is not None:
            b_new = new.b.clone()
            b_new[..., slot, :] = torch.as_tensor(b, dtype=b_new.dtype,
                                                  device=b_new.device)
            new = new.replace(b=b_new)
        return new


# id(lb) -> (weak reference to lb, weak reference to ub) of bound tensors
# already found consistent
_BOUNDS_CHECKED: dict = {}


def _check_bounds(lb: torch.Tensor, ub: torch.Tensor) -> None:
    """Raise if lb > ub anywhere.  Reading the answer waits for the device,
    so each pair of bound tensors is read once: a stream of solves on one
    problem (tracking ticks, staged super-batches, `update_constraint`, which
    keeps the bound tensors) then enqueues without a host synchronisation.
    The bounds of a problem are not to be written in place afterwards."""
    key = id(lb)
    hit = _BOUNDS_CHECKED.get(key)
    if hit is not None and hit[0]() is lb and hit[1]() is ub:
        return
    if bool((lb > ub).any()):
        raise ValueError("lb > ub: box bounds are contradictory")
    _BOUNDS_CHECKED[key] = (
        weakref.ref(lb, lambda _: _BOUNDS_CHECKED.pop(key, None)),
        weakref.ref(ub))


def validate_problem(tree, problem: IkProblem) -> None:
    """Input validation — the `checkIkIdData` analog
    (loik-loid-data.hpp:244-321): reject out-of-range or duplicate constraint
    links, mis-shaped leaves, and lb > ub with clear errors instead of
    silently mis-solving."""
    N, nv, nc = tree.njoints, tree.nv, problem.num_constraints
    for c in problem.constraint_links:
        if not (0 <= c < N):
            raise ValueError(
                f"constraint link {c} out of range [0, {N}) for model "
                f"'{tree.name}'"
            )
    if len(set(problem.constraint_links)) != nc:
        raise ValueError(
            f"duplicate constraint links {problem.constraint_links}: each "
            "link may carry at most one 6-D equality constraint (matching "
            "the reference's one-slot-per-link formulation)"
        )

    def chk(name, arr, core):
        shape = tuple(arr.shape)
        if len(shape) < len(core) or shape[len(shape) - len(core):] != core:
            raise ValueError(
                f"{name} has shape {shape}; expected trailing dims {core} "
                f"(optionally with one leading batch dim)"
            )
        if len(shape) > len(core) + 1:
            raise ValueError(
                f"{name} has shape {shape}: at most one leading batch dim "
                f"over core shape {core}"
            )

    chk("H_ref", problem.H_ref, (N, 6, 6))
    chk("v_ref", problem.v_ref, (N, 6))
    chk("A", problem.A, (nc, 6, 6))
    chk("b", problem.b, (nc, 6))
    chk("lb", problem.lb, (nv,))
    chk("ub", problem.ub, (nv,))
    _check_bounds(problem.lb, problem.ub)


def make_problem(tree, constraint_links, A=None, b=None, H_ref=None,
                 v_ref=None, lb=None, ub=None, dtype=None, device=None) -> IkProblem:
    """Convenience constructor with the reference test-fixture defaults
    (tests/loik-loid.cpp:121-130): H_ref = I6 on every link, v_ref = 0,
    A = I6, b = 0 per constraint, bounds from the model's velocity limits.
    Array arguments may be numpy arrays or tensors; leaves land on
    ``device`` (default: the tree's) in ``dtype`` (default: the tree's)."""
    N = tree.njoints
    dt = dtype or tree.dtype
    dev = torch.device(device) if device is not None else tree.device
    nc = len(constraint_links)

    def t(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    eye6 = torch.eye(6, dtype=dt, device=dev)
    vl = t(tree.velocity_limit)
    vl = torch.where(torch.isfinite(vl), vl, torch.full_like(vl, 1e3))
    problem = IkProblem(
        H_ref=eye6.expand(N, 6, 6).clone() if H_ref is None else t(H_ref),
        v_ref=torch.zeros((N, 6), dtype=dt, device=dev) if v_ref is None else t(v_ref),
        A=eye6.expand(nc, 6, 6).clone() if A is None else t(A),
        b=torch.zeros((nc, 6), dtype=dt, device=dev) if b is None else t(b),
        lb=-vl if lb is None else t(lb),
        ub=vl.clone() if ub is None else t(ub),
        constraint_links=tuple(int(c) for c in constraint_links),
    )
    validate_problem(tree, problem)
    return problem
