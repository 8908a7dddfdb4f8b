"""Observability: profiling traces, a steady-state allocation guard, NaN
checks, the logged mirror of a production solve, and timing.

Port of `loik_tpu.utils.observability`, whose rigor mechanisms stand in for
the reference's:

- `PinocchioTicToc` timing (tests/loik-loid.cpp:1004) -> `trace()`, a
  `torch.profiler` context writing a Chrome trace (chrome://tracing,
  Perfetto), and `Timer`.
- `CHECK_RUNTIME_MALLOC` / `LOIK_EIGEN_MALLOC_NOT_ALLOWED` (macros.hpp:7-15;
  CMakeLists.txt:93-97) -> `no_recompile_guard()`.  What a steady-state
  loop must not do is capture a CUDA graph (the port's counterpart of a jit
  compile, `utils.graphs`), build the kernel library again or make the
  CUDA caching allocator reserve new device memory.
- `INITIALIZE_WITH_NAN` (CMakeLists.txt:88-91) -> `debug_nans()`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import _build
from ..kernels import fused as _fused
from ..solver.state import LOG_FIELDS
from . import graphs as _graphs


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile a block with `torch.profiler` (CPU ops, and the CUDA kernels
    when a card is present) and write a Chrome trace file under
    ``log_dir`` (default: ``loik_tpu_torch_trace`` in the temporary
    directory); yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "loik_tpu_torch_trace")

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"loik_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


class _NanCheck(TorchDispatchMode):
    """Raises FloatingPointError on the first operator whose floating
    output holds a NaN, while `fused.CHECK_NANS` is set."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _fused.CHECK_NANS:
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(t.isnan().any()):
                    raise FloatingPointError(f"debug_nans: NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise FloatingPointError at the first NaN produced inside the block
    (the analog of jax's ``jax_debug_nans``): every eager operator's output
    (a dispatch mode), every fused kernel launch's output state, and the
    backward pass (`torch.autograd.set_detect_anomaly` with check_nan).
    ``enable=False`` turns the checks off inside an enabled block.  The
    previous settings are restored on exit.  Every check reads the device,
    so the block synchronises after each operator, and the entry points run
    uncaptured inside it (no CUDA graph, `utils.graphs`)."""
    old_flag = _fused.CHECK_NANS
    _fused.CHECK_NANS = enable
    try:
        with _NanCheck(), torch.autograd.set_detect_anomaly(enable, check_nan=True):
            yield
    finally:
        _fused.CHECK_NANS = old_flag


@dataclass
class CompileEvents:
    count: int = 0
    names: List[str] = field(default_factory=list)


def _segments() -> int:
    """Device-memory segments the CUDA caching allocator has reserved so far
    in this process (0 before CUDA is initialised)."""
    if not torch.cuda.is_initialized():
        return 0
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


@contextlib.contextmanager
def no_recompile_guard(allowed: int = 0):
    """Fail if more than ``allowed`` steady-state "hot-loop malloc" events
    happen inside the block: CUDA graph captures (the counterpart of the
    JAX guard's backend compiles), nvcc builds of the kernel library, and
    (on CUDA) device-memory segments newly reserved by the caching
    allocator.  Yields a `CompileEvents`, filled in when the block ends.

    Usage: warm the solver up once, then wrap the steady-state loop; an
    event means a shape or a setting leaked into the loop (a new batch
    size, say) — the analog of the reference's runtime-malloc checker."""
    events = CompileEvents()
    captures0, builds0, segments0 = len(_graphs.CAPTURES), _build.BUILDS, _segments()
    try:
        yield events
    finally:
        events.names += ["cuda graph capture"] * (len(_graphs.CAPTURES) - captures0)
        events.names += ["nvcc build"] * (_build.BUILDS - builds0)
        events.names += ["cuda segment"] * (_segments() - segments0)
        events.count = len(events.names)
    if events.count > allowed:
        raise RuntimeError(
            f"no_recompile_guard: {events.count} events inside guarded block "
            f"(allowed {allowed}): {sorted(set(events.names))} — a shape or "
            "setting leak (the analog of a hot-loop malloc)")


class MirrorMismatch(RuntimeError):
    """The eager mirror disagreed with the production result it mirrors."""


# core ranks of the IkProblem leaves: one more means a leading batch axis
_PROBLEM_CORE_NDIM = dict(H_ref=3, v_ref=2, A=3, b=2, lb=1, ub=1)
# SolveResult fields with a leading batch axis
_RESULT_BATCHED = ("nu", "z", "vis", "converged", "primal_infeasible",
                   "dual_infeasible", "iterations", "tail_iterations",
                   "primal_residual", "dual_residual")


def debug_mirror(tree, params, q, problem, warm_state=None, result=None,
                 sample=None, atol: float = 0.0):
    """Per-iteration observability for the fused production path.

    The fused CUDA kernel and the eager loop run the SAME body and round
    alike (`-fmad=false`, the same order for every sum), but the kernel
    cannot carry per-iteration log arrays (params.logging is refused,
    kernels/fused.py).  `debug_mirror` re-runs the same (q, problem,
    warm_state) on the eager loop with ``params.logging=True``, on the
    inputs' device, and returns the fully-logged SolveResult (log_rp /
    log_rd / log_mu / ... per iteration per problem): the iteration history
    the kernel executed.  The reference's analog: LoikSolverInfo logging on
    its PRODUCTION solver (loik-loid-optimized.hpp:47-127).

    Args:
      q / problem / warm_state: the inputs of the production call being
        mirrored — pass the SAME values (warm ticks need the same warm
        state or the mirror solves a different problem).
      result: optional production SolveResult (from `solve_fused`, a
        `solve_tracking` tick, ...).  When given, outcome parity is
        ASSERTED: status flags and iteration counts must match exactly and
        residuals within ``atol`` (0.0 = bit for bit, which holds for the
        kernel against the eager loop on one device); a divergence raises
        MirrorMismatch naming the problems, so mirror logs can never
        silently describe a different solve.
      sample: optional problem indices (a sequence, array or tensor) to
        mirror a sub-batch: log arrays are (max_iter, B), so at B=16k
        mirror a few stalling problems instead.  The batched leaves of
        ``problem``, the trailing-batch fields of ``warm_state`` and the
        batched fields of ``result`` are sliced alike.

    Returns the logging SolveResult of the eager mirror run.
    """
    from ..solver.solve import _as_batch, _solve_impl

    q = _as_batch(tree, q)
    B = q.shape[0]
    if sample is not None:
        idx = torch.as_tensor(sample, device=q.device).reshape(-1).long()
        q = q[idx]
        problem = problem.replace(**{
            name: getattr(problem, name)[idx]
            for name, core in _PROBLEM_CORE_NDIM.items()
            if getattr(problem, name).ndim == core + 1})
        if warm_state is not None:
            warm_state = dataclasses.replace(warm_state, **{
                f.name: x[..., idx] for f in dataclasses.fields(warm_state)
                if (x := getattr(warm_state, f.name)) is not None
                and x.ndim >= 1 and x.shape[-1] == B})
        if result is not None:
            result = dataclasses.replace(
                result, state=None,
                **{name: getattr(result, name)[idx] for name in _RESULT_BATCHED},
                **{name: None for name in LOG_FIELDS})
    mirror = _solve_impl(tree, params.replace(logging=True, verbose=False),
                         q, problem, warm_state)
    if result is not None:
        problems = []
        for name in ("converged", "primal_infeasible", "dual_infeasible",
                     "iterations"):
            bad = (getattr(mirror, name) != getattr(result, name)).nonzero().flatten()
            if bad.numel():
                problems.append(f"{name}: {bad.numel()} problem(s) differ, "
                                f"first {bad[:8].tolist()}")
        for name in ("primal_residual", "dual_residual"):
            a, b = getattr(mirror, name), getattr(result, name)
            bad = (~torch.isclose(a, b, rtol=0.0, atol=atol, equal_nan=True)
                   ).nonzero().flatten()
            if bad.numel():
                problems.append(
                    f"{name}: {bad.numel()} problem(s) beyond atol={atol}, "
                    f"first {bad[:8].tolist()} "
                    f"(mirror {a[bad[:3]].tolist()}, production {b[bad[:3]].tolist()})")
        if problems:
            raise MirrorMismatch(
                "eager mirror diverged from the production result — the logs "
                "below describe a DIFFERENT solve (same device for both runs? "
                "same warm_state?):\n  " + "\n  ".join(problems))
    return mirror


class Timer:
    """Wall-clock timing helper mirroring the SMOOTH(NBT) protocol of the
    reference timing tests (tests/loik-loid.cpp:1004-1026).  CUDA work is
    asynchronous: call ``torch.cuda.synchronize()`` just before the block
    and at its end, inside it, or the sample measures the enqueue."""

    def __init__(self):
        self.samples: List[float] = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)

    @property
    def mean_us(self) -> float:
        return 1e6 * sum(self.samples) / max(len(self.samples), 1)

    def percentile_ms(self, p: float) -> float:
        import numpy as np

        return float(np.percentile(self.samples, p) * 1e3)
