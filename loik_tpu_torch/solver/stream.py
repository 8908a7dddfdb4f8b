"""Tracking streams: T warm-started ticks enqueued as one call.

Port of `loik_tpu.solver.stream`.  The reference's 1 kHz control-loop
surface is the tailored `Solve(q, c_id, Ai, bi)` overload
(loik-loid-optimized.hpp:596-695): every tick updates one constraint target
and re-solves warm-started from the last tick's duals.  `loik_tpu` runs a
horizon of ticks as one `lax.scan` program (`_stream_jit`); here the
counterpart is `utils.graphs.scan`: on CUDA tensors ONE tick (the
constraint update, FK, prepare, reset, the kernel launch or the masked
while loop as a WHILE node) is captured as a CUDA graph and replayed T
times, the warm state carried in the graph's own buffers, each tick's
target read on the device at a tick counter and its outputs written into
(T, ...) buffers.  The host never waits for the device and enqueues one
graph launch a tick.  Under `utils.disable_graphs()`, on the CPU and with
``params.verbose`` the same tick runs as a host loop, which enqueues every
operator of every tick (and off the kernel path reads the running mask on
the host every body call).

A controller that must react to sensors each tick uses
`DiffIkSolver.solve_tracking`; one that can stage a horizon of targets (or
replay a trajectory) uses `solve_stream` / `DiffIkSolver.track_scan`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..params import SolverParams
from ..problem import IkProblem
from .solve import _solve_impl
from .state import SolverState, init_state


@dataclasses.dataclass(frozen=True)
class StreamResult:
    """Per-tick outputs of a tracking stream (leading tick axis T)."""

    nu: torch.Tensor                 # (T, B, nv) flat joint velocities
    converged: torch.Tensor          # (T, B)
    iterations: torch.Tensor         # (T, B)
    primal_residual: torch.Tensor    # (T, B)
    dual_residual: torch.Tensor      # (T, B)
    state: SolverState               # final state (warm start for the next
                                     # stream / tick)


def solve_stream(tree, params: SolverParams, q, problem: IkProblem,
                 slot: int, b_seq, A_seq=None,
                 warm_state: Optional[SolverState] = None,
                 fused=None,
                 batch_tile: Optional[int] = None,
                 refine: Optional[str] = None) -> StreamResult:
    """Run T tracking ticks back to back.

    Each tick t updates constraint ``slot`` to ``b_seq[t]`` (and
    ``A_seq[t]`` when given), then re-solves warm-started from the previous
    tick's state — the batched analog of the reference's tailored control
    overload `Solve(q, c_id, Ai, bi)` (loik-loid-optimized.hpp:596-695).

    Args:
      q: (B, nq) configurations held fixed across ticks, or (T, B, nq) for a
        per-tick configuration stream (the reference overload re-reads q
        every tick; pass the measured-state horizon here).
      b_seq: (T, ...) per-tick constraint targets, shaped like one
        ``problem.b[slot]`` entry per tick.
      A_seq: optional (T, ...) per-tick constraint matrices.
      warm_state: state threaded into tick 0 (e.g. from a previous stream or
        a settling `solve`); None starts cold.  With ``params.warm_start``
        every subsequent tick warm-starts from its predecessor either way —
        warm_start=False resets each tick (rarely what a tracker wants).
      refine: None (default) solves each tick in q's dtype at params.tol
        (the float32 floor is ~1e-5), or "delta" to run the delta-duals
        tol-1e-6 path per tick (float32 stages + one float64 KKT
        evaluation); a full-space float32 warm state threads between ticks.
      fused: None (auto, warns once naming the blocker when the kernel cannot
        run), True/False to force, or "require" to raise instead
        (`kernels.fused.resolve_fused`).

    On CUDA tensors each tick runs the fused kernel when eligible (float32 —
    except refine="delta", whose stages cast to float32 internally — motion
    subspaces independent of q, no logging/verbose) and the masked while
    loop otherwise, and the stream replays one captured tick T times
    (`utils.graphs.scan`); with ``params.verbose`` the ticks run eagerly,
    the loop synchronising the host every body call.  Per-iteration logging
    is unsupported (use `solve_tracking` per tick).
    """
    if params.logging:
        raise ValueError(
            "solve_stream does not support per-iteration logging (the stream "
            "would stack T full log arrays); use solve_tracking per tick"
        )
    q = torch.as_tensor(q, device=tree.device)
    if q.ndim not in (2, 3):
        raise ValueError(f"q must be (B, nq) or (T, B, nq); got {tuple(q.shape)}")
    # moved to the device once; ticks index them there
    b_seq = torch.as_tensor(b_seq, dtype=q.dtype, device=q.device)
    A_seq = None if A_seq is None else torch.as_tensor(
        A_seq, dtype=q.dtype, device=q.device)
    B = q.shape[-2]
    from .refine import _cast_state, default_batch_tile, solve_delta_duals

    if batch_tile is None:
        batch_tile = default_batch_tile(tree.njoints)
    if refine not in (None, "delta"):
        raise ValueError(f"refine must be None or 'delta'; got {refine!r}")
    from ..kernels.fused import _fused_body, resolve_fused

    # the delta path's float32 stages fuse regardless of q dtype (it casts
    # internally): skip the dtype gate for it
    fused = resolve_fused(
        fused, tree, params, B, batch_tile,
        dtype=None if refine == "delta" else q.dtype,
        where="solve_stream", num_constraints=problem.num_constraints,
    )
    # the delta path's returned state is float32 whatever q's dtype; the
    # state carried from tick to tick keeps one dtype
    if warm_state is None:
        warm_state = init_state(
            tree, B, problem.num_constraints,
            torch.float32 if refine == "delta" else q.dtype, q.device)
    elif refine == "delta":
        warm_state = _cast_state(warm_state, torch.float32)

    def tick(tree, st, x, consts):
        b_t, A_t, q_t = x
        q_fixed, problem_ = consts
        prob = problem_.update_constraint(slot, A=A_t, b=b_t)
        qt = q_fixed if q_t is None else q_t
        if refine == "delta":
            res = solve_delta_duals(tree, params, qt, prob, warm_state=st,
                                    fused=fused, batch_tile=batch_tile)
        elif fused:
            res = _fused_body(params, batch_tile, tree, qt, prob, st)
        else:
            res = _solve_impl(tree, params, qt, prob, st)
        return res.state, (res.nu, res.converged, res.iterations,
                           res.primal_residual, res.dual_residual)

    from ..utils import graphs

    per_tick_q = q.ndim == 3
    st, (nu, conv, iters, rp, rd) = graphs.scan(
        "solve_stream", tree, (params, slot, refine, bool(fused), batch_tile), tick,
        warm_state, (b_seq, A_seq, q if per_tick_q else None),
        (None if per_tick_q else q, problem), b_seq.shape[0], capture=not params.verbose)
    return StreamResult(nu=nu, converged=conv, iterations=iters,
                        primal_residual=rp, dual_residual=rd, state=st)
