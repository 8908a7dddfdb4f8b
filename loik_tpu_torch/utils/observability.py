"""Observability: profiling traces, spans and phase labels, a steady-state
allocation guard, NaN checks, the logged mirror of a production solve, and
timing.

Port of `loik_tpu.utils.observability`, whose rigor mechanisms stand in for
the reference's:

- `PinocchioTicToc` timing (tests/loik-loid.cpp:1004) -> `trace()`, a
  `torch.profiler` context writing a Chrome trace (chrome://tracing,
  Perfetto); `Timer`, wall-clock samples of a block; and the spans and
  phase labels below, on the profiler's clock, which name the program's
  steps in such a trace and tell the device time of a replayed graph by
  solver phase (`phase_device_us`).
- `CHECK_RUNTIME_MALLOC` / `LOIK_EIGEN_MALLOC_NOT_ALLOWED` (macros.hpp:7-15;
  CMakeLists.txt:93-97) -> `no_recompile_guard()`.  What a steady-state
  loop must not do is capture a CUDA graph (the port's counterpart of a jit
  compile, `utils.graphs`), build the kernel library again or make the
  CUDA caching allocator reserve new device memory.
- `INITIALIZE_WITH_NAN` (CMakeLists.txt:88-91) -> `debug_nans()`.

Spans (`span`): host ranges, `torch.profiler.record_function` while a
profiler runs and nothing otherwise (one flag read).  Where they sit:

- ``api.<method>``: each `DiffIkSolver` entry point (`solve`,
  `solve_refined`, `solve_init`, `resolve`, `solve_tracking`,
  `track_scan`, `reach`), the request span: every other span of a call
  nests in it.
- ``graphs.key:<tag>``: `utils.graphs.run` / `scan` / `jit`: the inputs
  flattened, the key built and looked up.
- ``graphs.copy_in:<tag>``: the copies into the graph's static buffers, a
  new tree's derived values, the traced numbers, the generator's state.
- ``graphs.replay:<tag>``: the graph's launch.
- ``graphs.clone_out:<tag>``: the fresh results cloned out, the
  generator's state handed back.

``<tag>`` is the entry point's (`run`'s ``tag``; a `jit` function's
qualified name).  Phases (`phase`): inside a capture they run nothing and
record which of the graph's nodes each phase recorded
(`graphs.Capture.phases`); elsewhere each is the span of its name.

- ``solver.cast``: the tree, problem and state casts of the refine bodies
  (`refine.solve_delta_duals`, `solve_two_stage`, `_delta_refined`).
- ``solver.update``: the tracking tick's constraint update
  (`api.DiffIkSolver.solve_tracking`).
- ``solver.fk``: forward kinematics (`solve._solve_impl`): on the card one
  launch of the FK kernel (`kernels.fk`), one node of a graph.
- ``solver.prepare``: `prepare_problem`, the configuration-dependent S,
  the tolerance floors and a cold state (`_solve_impl`); the delta problem
  and warm start of `refine._delta_refined`; the kernel's operands made
  contiguous (`kernels.fused._launch`).
- ``solver.reset``: `_reset_state` (`_solve_impl`, the delta state's in
  `refine._delta_duals`), and the kernel's working copy of the state
  (`kernels.fused._launch`).
- ``solver.loop``: the fused kernel's launch or the WHILE node, each stage
  (`_solve_impl`, `refine._delta_duals`).
- ``solver.kkt64``: `refine._delta_duals`' float64 KKT evaluation, scales,
  delta problem and delta state.
- ``solver.result``: `solve._result` and the refine bodies'
  recombination.

Counters: `utils.graphs.copy_stats()` (per tag: calls and replays, bytes
copied in and cloned out, and the host clock's time of the key, copy-in,
replay and clone-out steps of the calls made while no profiler ran; and,
taken at capture where the tag's graphs agree on them, its graph's nodes
and their split by phase);
`utils.graphs.CAPTURES` (a capture's seconds, nodes and phases, and per
kernel the launches a replay makes), `kernels._build.BUILDS` and
`graphs.body_executions()`; and `kernel_counts()`, which reads the launches
of every hand-written kernel (`kernels.common`: ``fused_admm``, counted in
`kernels.fused._launch` as `kernels.fused.LAUNCHES`, and ``fk_limi``, in
`kernels.fk.fk_limi` as `kernels.fk.FK_LAUNCHES`; both with every replay of
a graph that recorded them, added by `utils.graphs`) and
`kernels.fk.PLAIN_CALLS` (per reason, the calls of
`solver.solve.fwd_pass_init` on CUDA tensors that took the plain FK,
counted in `kernels.fk.on_kernel`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# the package's modules are imported where they are used: the graphs and the
# solver import this module for `span` and `phase`

# what `span` returns while no profiler runs
_NULL = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a torch profiler runs (one flag read)."""
    return _profiler._is_profiler_enabled


def span(name: str, tag: Optional[str] = None):
    """A host span named ``name`` (``name:tag`` with a ``tag``):
    `torch.profiler.record_function` while a profiler runs, so the range
    lies in its trace on the clock of the device's events; otherwise a
    shared context that does nothing (one flag read)."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(name if tag is None else f"{name}:{tag}")


class _Phase:
    """`phase` inside a capture: the graph's node count at entry and exit
    into the capture's marks (`utils.graphs._phases`)."""

    __slots__ = ("name", "marks", "outer")

    def __init__(self, name, marks):
        self.name, self.marks = name, marks

    def __enter__(self):
        self.outer = self.marks[-1][1] if self.marks else None
        self.marks.append((_capture_nodes(), self.name))

    def __exit__(self, *exc):
        self.marks.append((_capture_nodes(), self.outer))


def _capture_nodes() -> int:
    from . import graphs

    return graphs._capture_nodes(graphs._capture_stream())


def phase(name: str):
    """A phase of a solve (the module docstring lists them).  On the thread
    that captures an entry point's graph: the graph's nodes recorded inside
    it are the phase's (`utils.graphs.Capture.phases`; an inner phase's
    nodes are the inner one's), which adds no node and runs nothing at
    replay; inside a WHILE node's body (or a capture that records no
    phases) nothing.  Elsewhere ``span(name)``, so an eager call's trace
    carries the same names."""
    from . import graphs

    inside = graphs._INSIDE
    if getattr(inside, "capturing", False):
        marks = getattr(inside, "marks", None)
        if marks is None or getattr(inside, "loop_buffers", ()):
            return _NULL
        return _Phase(name, marks)
    return span(name)


def kernel_counts() -> dict:
    """The kernels' counters (the module docstring says where they sit):
    ``launches`` (kernel name -> launches) and ``fk_plain_calls`` (reason
    -> calls)."""
    from ..kernels import common, fk, fused  # noqa: F401  (each registers its count)

    return {"launches": {name: c.count() for name, c in common.KERNELS.items()},
            "fk_plain_calls": dict(fk.PLAIN_CALLS)}


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
    output holds a NaN, while `kernels.common.CHECK_NANS` is set."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from ..kernels import common

        out = func(*args, **(kwargs or {}))
        if common.CHECK_NANS:
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(t.isnan().any()):
                    raise FloatingPointError(f"debug_nans: NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise FloatingPointError at the first NaN produced inside the block
    (the analog of jax's ``jax_debug_nans``): every eager operator's output
    (a dispatch mode), what every launch of a hand-written kernel wrote, and the
    backward pass (`torch.autograd.set_detect_anomaly` with check_nan).
    ``enable=False`` turns the checks off inside an enabled block.  The
    previous settings are restored on exit.  Every check reads the device,
    so the block synchronises after each operator, and the entry points run
    uncaptured inside it (no CUDA graph, `utils.graphs`)."""
    from ..kernels import common

    old_flag = common.CHECK_NANS
    common.CHECK_NANS = enable
    try:
        with _NanCheck(), torch.autograd.set_detect_anomaly(enable, check_nan=True):
            yield
    finally:
        common.CHECK_NANS = old_flag


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
    from ..kernels import _build
    from . import graphs as _graphs

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
    from ..solver.state import LOG_FIELDS

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


# the trace's categories of device operations, by the graph node type that
# makes each (`utils.graphs.node_kinds`)
_DEVICE_CATS = {"kernel": 0, "gpu_memcpy": 1, "gpu_memset": 2}
# node types that run nothing a trace shows: host, empty, event wait and
# record, external semaphores, memory allocation and release
_SILENT = frozenset({3, 5, 6, 7, 8, 9, 10, 11})


class PhaseSplit(NamedTuple):
    """`phase_device_us`' answer: device microseconds by phase (None: the
    nodes outside every phase), the replays attributed and those not."""

    us: Dict[Optional[str], float]
    replays: int
    unattributed: int


def _template(cap):
    """The device operations a replay of ``cap`` runs, in order: (node
    type, kernel name, phase) for a node, (None, its body's template,
    phase) for a WHILE node, whose body runs any number of times; None if
    a replay cannot be told op by op (no listing of the graph's nodes, not
    one chain, a child graph)."""
    from . import graphs

    listing = graphs.node_kinds(cap)
    if listing is None:
        return None
    (kinds, linear), bodies = listing
    if not (kinds and linear):
        return None
    label = [None] * len(kinds)
    for name, first, end in cap.phases:
        label[first:end] = [name] * (end - first)
    loops = iter(bodies)
    out = []
    for (kind, name), lab in zip(kinds, label):
        if kind == graphs.NODE_CONDITIONAL:
            body_kinds, body_linear = next(loops, ((), False))
            if not (body_kinds and body_linear):
                return None
            body = [(k, n, lab) for k, n in body_kinds if k not in _SILENT]
            if any(k not in _DEVICE_CATS.values() for k, _, _ in body):
                return None
            out.append((None, body, lab))
        elif kind in _DEVICE_CATS.values():
            out.append((kind, name, lab))
        elif kind not in _SILENT:
            return None
    return out


# the kernels the CUDA driver runs a graph's copy and set nodes as (an H100 under
# CUDA 12.8 runs a device-to-device copy node as ``memcpy32_post``)
_NODE_KERNELS = {1: "memcpy", 2: "memset"}


def _same(node, op) -> bool:
    """Whether the trace's device operation ``op`` is the run of ``node``."""
    kind, kernel, _ = node
    cat, name = _DEVICE_CATS.get(op.get("cat")), op.get("name", "")
    if kind == 0:
        return cat == 0 and name == kernel
    return cat == kind or (cat == 0 and name.startswith(_NODE_KERNELS[kind]))


def _labels(template, ops) -> Optional[list]:
    """The phase of each of a replay's ``ops`` (in time order) under
    ``template`` (`_template`), or None where they do not match it one for
    one."""
    out, j = [], 0
    for node in template:
        if node[0] is None:
            body = node[1]
            while body and j + len(body) <= len(ops) and all(
                    _same(b, ops[j + i]) for i, b in enumerate(body)):
                out += [node[2]] * len(body)
                j += len(body)
        elif j < len(ops) and _same(node, ops[j]):
            out.append(node[2])
            j += 1
        else:
            return None
    return out if j == len(ops) else None


def phase_device_us(events) -> PhaseSplit:
    """Device time by solver phase of the graph replays in a Chrome trace
    of torch.profiler (``events``: its event dicts, as `trace()` writes
    them; the device and host events of a trace, in any order).

    The device operations of one replay share the correlation id of its
    ``cudaGraphLaunch``; in time order they are matched to the labelled
    nodes of a capture of this process (`utils.graphs.CAPTURES`, whose
    graphs still live; those of the tag of the ``graphs.replay:<tag>``
    span around the launch, where there is one): the same count, node type
    for type, a kernel's name its function's, a WHILE node's body whole any
    number of times (its operations are the phase the node was captured
    in).  A replay that no
    capture matches, or that captures of different phases match, is
    counted unattributed: this never guesses."""
    from . import graphs

    templates = [(c.tag, t) for c in list(graphs.CAPTURES) if (t := _template(c)) is not None]
    by_corr = collections.defaultdict(list)
    launches, spans = [], []
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in _DEVICE_CATS and corr is not None and "ts" in e:
            by_corr[corr].append(e)
        elif cat in ("cuda_runtime", "cuda_driver") and "GraphLaunch" in name \
                and corr is not None:
            launches.append(e)
        elif name.startswith("graphs.replay:") and "dur" in e:
            spans.append(e)
    us: Dict[Optional[str], float] = collections.defaultdict(float)
    replays = unattributed = 0
    for launch in launches:
        t = float(launch["ts"])
        tags = {s["name"].split(":", 1)[1] for s in spans
                if s.get("tid") == launch.get("tid")
                and float(s["ts"]) <= t <= float(s["ts"]) + float(s["dur"])}
        ops = sorted(by_corr.get(launch["args"]["correlation"], []),
                     key=lambda e: float(e["ts"]))
        found = {tuple(lab) for tag, tpl in templates if not tags or tag in tags
                 if (lab := _labels(tpl, ops)) is not None}
        if len(found) != 1:
            unattributed += 1
            continue
        replays += 1
        for op, lab in zip(ops, found.pop()):
            us[lab] += float(op.get("dur", 0))
    return PhaseSplit(dict(us), replays, unattributed)
