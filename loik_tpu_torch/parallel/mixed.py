"""Mixed-topology batches (e.g. "UR5 + Panda mixed batch", BASELINE.json
configs[1]).

Port of `loik_tpu.parallel.mixed`.  Two strategies:

- :func:`solve_mixed` — one solve per distinct topology, enqueued
  back-to-back (general: any mix of trees/constraints).
- :func:`solve_mixed_padded` — heterogeneous serial-chain robots are
  embedded into ONE common padded chain and solved as ONE combined batch:
  one set of kernel launches whatever the number of robot types.

The embedding behind the padded path: a chain of ``N`` 1-dof joints is
extended to ``N_max`` joints whose extra joints have IDENTITY placements and
a ZERO motion subspace (zero axis).  A zero-subspace joint is structurally
frozen: ``U = H S = 0`` in the Riccati sweep, so its ``nu`` is identically
zero and it transmits its parent's spatial velocity unchanged
(``v_child = X^-1 v_parent = v_parent``).  The original end-effector
constraint moves to the padded chain TIP with its value unchanged, and the
padded program runs the ORIGINAL problem's ADMM trajectory (padded dofs never
enter BoxProj/DualUpdate or the residual norms — their every term is exactly
zero).  Freezing via ``lb = ub = 0`` box constraints instead provably
reaches the same optimum but damages the trajectory: the degenerate
constraints accumulate duals that drag the iteration counts up.
Per-problem geometry (each robot's placements and joint axes) rides in
BATCHED tree leaves (`KinematicTree.has_batched_geometry`), and the fused
kernel reads each problem's motion subspaces as data
(`PreparedProblem.S_all`).  There is no reference analog (the C++ solver
binds one Model per instance, loik-loid-optimized.hpp:762); this is the
batching story a heterogeneous robot fleet needs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..model.tree import PRISMATIC, REVOLUTE, KinematicTree, resolve_device
from ..params import SolverParams
from ..problem import IkProblem, validate_problem
from ..solver import solve
from ..solver.state import SolveResult
from ..utils import graphs


def solve_mixed(
    groups: Sequence[Tuple[object, object, IkProblem]],
    params: SolverParams,
    solve_fn=None,
) -> List[SolveResult]:
    """Solve [(tree, q_batch, problem), ...] — one solve per topology,
    enqueued back-to-back.  Returns results in group order.

    solve_fn(tree, params, q, problem) overrides the solver backend
    (`solve` by default)."""
    run = solve_fn or solve
    return [run(tree, params, q, problem) for tree, q, problem in groups]


def _is_1dof_chain(tree: KinematicTree) -> bool:
    return all(t in (REVOLUTE, PRISMATIC) for t in tree.jtypes) and all(
        p == i - 1 for i, p in enumerate(tree.parents)
    )


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _np_b(x, B, core_ndim):
    """Broadcast a possibly-unbatched problem leaf to a leading (B, ...)."""
    x = _np(x)
    if x.ndim == core_ndim:
        return np.broadcast_to(x, (B,) + x.shape).copy()
    assert x.shape[0] == B, (x.shape, B)
    return x


def _pack_q(chain, group_njoints, qs):
    """Pad + concat of per-group q tensors into the (..., B, N) super-batch
    (leading rep dims, if any, are kept)."""
    N = chain.njoints
    cols = [
        F.pad(torch.as_tensor(q, dtype=chain.dtype, device=chain.device), (0, N - n))
        for q, n in zip(qs, group_njoints)
    ]
    return torch.cat(cols, dim=-2)


def _scan_outputs(res, light):
    if light:
        return (res.converged, res.iterations)
    return (res.nu, res.converged, res.iterations,
            res.primal_residual, res.dual_residual)


@dataclasses.dataclass(frozen=True)
class MixedPadded:
    """Pre-assembled padded super-batch: the batched-geometry chain and the
    combined problem are built ONCE (host-side numpy assembly + one device
    transfer); per-solve work is just packing the configurations — a few
    device-side pads/concats.  A fleet controller re-solving every tick pays
    only for its q, not for a super-batch rebuild."""

    chain: KinematicTree
    problem: IkProblem
    group_sizes: Tuple[int, ...]
    group_njoints: Tuple[int, ...]

    def pack_q(self, qs: Sequence[object]) -> torch.Tensor:
        """[(Bg, nq_g)...] group configurations -> (B, N) super-batch q
        (device-side pad + concat; padded joints sit at q = 0 = identity)."""
        return _pack_q(self.chain, self.group_njoints, qs)

    def _tensors(self, qs):
        """The group configurations as tensors on the chain's device (a
        graph's inputs are tensors)."""
        return [torch.as_tensor(q, device=self.chain.device) for q in qs]

    def solve(self, params: SolverParams, qs: Sequence[object],
              solve_fn=None) -> List[SolveResult]:
        return self.unpack(self.solve_packed(params, qs, solve_fn))

    def solve_packed(self, params: SolverParams, qs: Sequence[object],
                     solve_fn=None) -> SolveResult:
        """Solve and return the RAW super-batch result (rows in group order,
        padded dofs included).  Latency-sensitive loops should defer `unpack`
        (its per-group slicing is a few dozen small device operations).

        On CUDA tensors the packing and the solve (the default one's masked
        while loop a WHILE node) run as ONE captured CUDA graph per key
        (`utils.graphs`, the counterpart of loik_tpu's `_packed_solve_jit`);
        a ``solve_fn`` runs after an eager packing, as its own graph where
        it is one (a new function object would be a new key every call)."""
        run, chain, problem = solve_fn or solve, self.chain, self.problem
        validate_problem(chain, problem)
        return graphs.run("solve_packed", chain, (params,),
                          lambda qs: run(chain, params, self.pack_q(qs), problem),
                          (self._tensors(qs),),
                          capture=solve_fn is None and not params.verbose)

    def pack_q_stacked(self, qs_stacked: Sequence[object]) -> torch.Tensor:
        """[(R, Bg, nq_g)...] staged group configurations -> (R, B, N)
        prepacked super-batch q.  Staging the packing once lets
        `solve_scan(q_packed=...)` run the solves alone.  On CUDA tensors a
        captured CUDA graph per key (loik_tpu's `_pack_stacked_jit`)."""
        chain, nj = self.chain, self.group_njoints
        return graphs.run("pack_q_stacked", chain, (nj,), lambda qs: _pack_q(chain, nj, qs),
                          (self._tensors(qs_stacked),))

    def solve_scan(self, params: SolverParams,
                   qs_stacked: Optional[Sequence[object]] = None, solve_fn=None,
                   q_packed=None, light: bool = False):
        """Solve R staged super-batches back to back: `qs_stacked` is
        [(R, Bg, nq_g) ...] per group, or pass `q_packed` (R, B, N) from
        `pack_q_stacked` to run over prepacked configurations (packing
        hoisted out).  Returns per-rep leading-R tensors (nu, converged,
        iterations, primal/dual residuals), stacked once at the end.  The R
        solves are enqueued on the current stream one after the other; with
        a solver that runs the fused kernel nothing synchronises the host
        between reps, which separates the device rate from the latency of a
        synchronous call.  light=True stacks only (converged, iterations).

        On CUDA tensors the R solves are `utils.graphs.scan` over the reps
        (loik_tpu's `lax.scan` in `_packed_scan_jit` /
        `_prepacked_scan_jit`): one captured tick (the packing of
        ``qs_stacked``'s rep, and the default solve with its masked while
        loop a WHILE node), replayed R times with nothing read on the host.
        A ``solve_fn`` runs eagerly once per rep, as its own graph where it
        is one."""
        if (qs_stacked is None) == (q_packed is None):
            raise ValueError("pass exactly one of qs_stacked / q_packed")
        run, chain, problem, nj = solve_fn or solve, self.chain, self.problem, self.group_njoints
        validate_problem(chain, problem)
        light, packed = bool(light), q_packed is not None
        xs = (torch.as_tensor(q_packed, device=chain.device) if packed
              else self._tensors(qs_stacked))

        def tick(carry, x, _):
            q = x if packed else _pack_q(chain, nj, x)
            return carry, _scan_outputs(run(chain, params, q, problem), light)

        R = (xs if packed else xs[0]).shape[0]
        _, ys = graphs.scan("solve_scan", chain, (params, light, nj), tick, (), xs, None, R,
                            capture=solve_fn is None and not params.verbose)
        return ys

    def unpack(self, res: SolveResult) -> List[SolveResult]:
        """Split a super-batch result per group (strip padded dofs/links)."""
        out = []
        off = 0
        for n, Bg in zip(self.group_njoints, self.group_sizes):
            sl = slice(off, off + Bg)
            out.append(
                dataclasses.replace(
                    res,
                    nu=res.nu[sl, :n],
                    z=res.z[sl, :n],
                    vis=res.vis[sl, :n],
                    converged=res.converged[sl],
                    primal_infeasible=res.primal_infeasible[sl],
                    dual_infeasible=res.dual_infeasible[sl],
                    iterations=res.iterations[sl],
                    tail_iterations=res.tail_iterations[sl],
                    primal_residual=res.primal_residual[sl],
                    dual_residual=res.dual_residual[sl],
                    state=None,
                )
            )
            off += Bg
        return out


def prepare_mixed_padded(
    groups: Sequence[Tuple[KinematicTree, int, IkProblem]],
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> MixedPadded:
    """Assemble the padded super-batch for [(tree, batch_size, problem)...].

    Requirements (else use :func:`solve_mixed`): every tree is a serial
    chain of 1-dof joints (revolute/prismatic), and every problem has ONE
    equality constraint at its end-effector (the last joint) — the shape of
    BASELINE configs[1].  ``dtype`` and ``device`` default to the first
    tree's."""
    trees = [g[0] for g in groups]
    for t in trees:
        if not _is_1dof_chain(t):
            raise ValueError(
                f"solve_mixed_padded needs serial 1-dof chains; '{t.name}' "
                "is not (use solve_mixed)"
            )
    for tree, _, problem in groups:
        validate_problem(tree, problem)
        if problem.constraint_links != (tree.njoints - 1,):
            raise ValueError(
                "solve_mixed_padded supports one end-effector constraint "
                f"per problem; got links {problem.constraint_links} for "
                f"'{tree.name}'"
            )
    if dtype is None:
        dtype = trees[0].dtype
    dev = trees[0].device if device is None else resolve_device(device)
    N = max(t.njoints for t in trees)
    Bs = [int(g[1]) for g in groups]
    B = sum(Bs)

    # ---- batched-geometry padded chain ---------------------------------
    # leaves gain a batch dim: (N, B, ...); padded joints are identity
    # placements with ZERO axes -> zero motion subspace -> structurally
    # frozen dofs (see module docstring; rotation_about_axis(0, 0) = I so FK
    # is exact, and D = S'HS + mu = mu stays invertible)
    pR = np.zeros((N, B, 3, 3))
    pR[:] = np.eye(3)
    pp = np.zeros((N, B, 3))
    ax = np.zeros((N, B, 3))
    off = 0
    for (tree, _, _), Bg in zip(groups, Bs):
        n = tree.njoints
        pR[:n, off: off + Bg] = _np(tree.placement_R)[:, None]
        pp[:n, off: off + Bg] = _np(tree.placement_p)[:, None]
        ax[:n, off: off + Bg] = _np(tree.axis)[:, None]
        off += Bg
    # per-slot joint TYPE must agree across groups (type is static; the
    # batched-leaf trick moves axes/placements per problem, not S layout)
    jtypes = []
    for slot in range(N):
        types = {t.jtypes[slot] for t in trees if t.njoints > slot}
        if len(types) > 1:
            raise ValueError(
                f"joint slot {slot} mixes types {types}; groups must agree "
                "per slot (pad order or use solve_mixed)"
            )
        jtypes.append(types.pop() if types else REVOLUTE)

    def tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    chain = KinematicTree(
        placement_R=tensor(pR),
        placement_p=tensor(pp),
        axis=tensor(ax),
        velocity_limit=torch.zeros((N,), dtype=dtype, device=dev),
        parents=tuple(range(-1, N - 1)),
        jtypes=tuple(jtypes),
        idx_v=tuple(range(N)),
        idx_q=tuple(range(N)),
        joint_names=tuple(f"j{i}" for i in range(N)),
        name=f"mixed_chain_{N}",
    )

    # ---- combined problem ----------------------------------------------
    # padded links: H_ref = 0 (no tracking cost); padded dofs keep lb=ub=0
    # but are inert either way — the zero subspace already pins nu = z = w =
    # 0 exactly.  The EE constraint moves to the tip, where v_tip == v_EE
    H = np.zeros((B, N, 6, 6))
    v = np.zeros((B, N, 6))
    A = np.zeros((B, 1, 6, 6))
    b = np.zeros((B, 1, 6))
    lb = np.zeros((B, N))
    ub = np.zeros((B, N))
    off = 0
    for (tree, _, problem), Bg in zip(groups, Bs):
        n = tree.njoints
        sl = slice(off, off + Bg)
        H[sl, :n] = _np_b(problem.H_ref, Bg, 3)
        v[sl, :n] = _np_b(problem.v_ref, Bg, 2)
        A[sl] = _np_b(problem.A, Bg, 3)
        b[sl] = _np_b(problem.b, Bg, 2)
        lb[sl, :n] = _np_b(problem.lb, Bg, 1)
        ub[sl, :n] = _np_b(problem.ub, Bg, 1)
        off += Bg
    sup = IkProblem(
        H_ref=tensor(H), v_ref=tensor(v), A=tensor(A), b=tensor(b),
        lb=tensor(lb), ub=tensor(ub), constraint_links=(N - 1,),
    )
    return MixedPadded(
        chain=chain, problem=sup, group_sizes=tuple(Bs),
        group_njoints=tuple(t.njoints for t in trees),
    )


def solve_mixed_padded(
    groups: Sequence[Tuple[KinematicTree, object, IkProblem]],
    params: SolverParams,
    dtype: Optional[torch.dtype] = None,
    solve_fn=None,
) -> List[SolveResult]:
    """One combined batch over heterogeneous serial-chain robots:
    `prepare_mixed_padded` + `MixedPadded.solve` in one call (re-solving
    loops should hold on to the prepared object instead — the assembly is
    the expensive part).  Returns per-group SolveResults with each group's
    own nv (padded dofs stripped).

    solve_fn(tree, params, q, problem) overrides the solver backend (e.g.
    `refine.solve_delta_duals` for tol-1e-6 runs).  The fused kernel supports
    the batched geometry leaves used here via precomputed per-problem motion
    subspaces (PreparedProblem.S_all), so the delta-duals backend runs both
    its stages in the kernel.  The chain is new on every call, so a
    solve_fn that runs as a CUDA graph runs uncaptured here
    (`utils.graphs.inline`): its capture would never be replayed.
    """
    mp = prepare_mixed_padded(
        [(t, q.shape[0], p) for t, q, p in groups], dtype
    )
    with graphs.inline():
        return mp.solve(params, [q for _, q, _ in groups], solve_fn=solve_fn)
