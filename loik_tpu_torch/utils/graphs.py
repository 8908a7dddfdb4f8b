"""Captured CUDA graphs: the port's counterpart of `jax.jit`.

`loik_tpu` compiles each entry point into one device program
(`solve._solve_jit`, `_solve_fk_jit` and `fwd_pass_init_jit`,
`refine._delta_duals_jit`, `_two_stage_jit` and `_solve_jit_delta`,
`kernels.fused._run_fused`, `api._tracking_jit`, `stream._stream_jit`,
`clik._clik_jit`, `mixed._packed_solve_jit`, `_packed_scan_jit`,
`_prepacked_scan_jit` and `_pack_stacked_jit`, `multistart._multistart_jit`).
Eager PyTorch instead launches every operator from the host: the flagship
delta-duals solve is about 800 small launches around its two kernel
launches, and the host's enqueue, not the card, sets its time.  So on CUDA
tensors those entry points run their body through this module, which
captures it ONCE per key as a CUDA graph and replays the graph on later
calls:

- `run(tag, tree, statics, body, args)`: one call of ``body(tree, *args)``.
  The tensors of ``tree`` and ``args`` are copied into the graph's static
  input buffers, the graph is replayed, and the outputs are cloned, so
  every result is a fresh tensor (as JAX's arrays are) and a later call
  never overwrites an earlier result.
- `scan(tag, tree, statics, tick, carry, xs, consts, length)`: the
  counterpart of a `lax.scan` inside `jit`.  One tick is captured and
  replayed ``length`` times; the carry lives in the graph's own buffers,
  each tick reads its slice of ``xs`` at a tick counter kept on the device
  and writes its outputs into preallocated ``(length, ...)`` buffers.
- `while_loop(cond, body, carry)`: the counterpart of a `lax.while_loop`
  inside `jit` (the solver's masked ADMM loop).  Inside a capture it is a
  CUDA graph conditional node of type WHILE (`kernels/csrc/graph_while.cu`):
  the body is captured once and the node runs it on the card while the
  condition, set by a one-thread kernel from ``cond`` of the carry, holds;
  nothing is read on the host.  Elsewhere it is a host loop.
- `jit(fn, static_argnums, static_argnames)`: the counterpart of
  `jax.jit` for a user's function of tensors and numbers, at the loss
  level: ``fn``'s whole call, the backward of `torch.autograd.grad` inside
  it included, as one graph (the differentiable solve's training step).

The key is the jit cache key: the tree's topology, as `jax.jit` keys
loik_tpu's pytree by its aux data (parents, joint types, dof indexing,
joint names, the robot's name, pitches, mimic pairs, and for each tensor
leaf whether it is there, its shape, dtype and device; never the tree's
identity or values), the entry point's ``tag`` and ``statics`` (the
`SolverParams` and every other argument the body bakes in, such as
`batch_tile`, the stage caps or a tick count: they mirror `loik_tpu`'s
``static_argnums`` one for one), and the structure of the inputs with the
device, dtype and shape of every tensor, including which optional inputs
were given.  Constants in the inputs (constraint links) are part of it
too.  Everything the fused kernel's launch bakes into its graph node
(`kernels.fused._LoikConfig`: the batch, the topology, the parameters)
follows from these.  The tree's geometry is an input: a graph holds a tree
rebuilt on its own buffers, and a call with another tree of the topology
copies that tree's leaves in and recomputes the casts and S operand the
graph's tree derived from them before it replays (`_Trees`); a call with
the tree it holds copies nothing of it.  `jit` keys a function the same
way (``fn`` by identity; a tree among its arguments is an input as here),
but traces the Python and numpy numbers among its arguments as `jax.jit`
does: each is keyed by its type only and reaches the graph as a 0-d
tensor, so a new value replays; only the arguments named by
``static_argnums`` / ``static_argnames`` are keyed by value and baked in.

Semantics, as JAX's:
- On by default on the card; `disable_graphs()` (the counterpart of
  `jax.disable_jit()`) runs the same bodies eagerly, process-wide.
- On CPU tensors the bodies run eagerly, as always.
- A failed capture raises; it never quietly runs eagerly.
- While `utils.debug_nans` is on (its checks read the device after every
  operator and every launch) the bodies run eagerly.  So do calls whose
  inputs require a gradient (a graph would cut the autograd record).

The recipe is PyTorch's own: a warm-up call on a side stream (it builds
the kernel library, fills the graph tree's casts and S operand and sets the
kernel's shared-memory limit), then the capture on that stream under
``torch.cuda.graph(..., capture_error_mode="thread_local")``.  The warm-up
is the first call's own work: `run` returns its result (clones, fresh
like every result), so a first call launches the kernel as often as an
eager one; a first `scan` runs one warm-up tick and then replays all
``length`` ticks.  Captures
take a lock (`parallel.sharding.run_sharded` solves each card's rows on a
host thread of its own); each graph takes its own lock around a call.
Each graph holds a private memory pool for its intermediates
(`Capture.pool_bytes`).  A graph holds no reference to a caller's tree and
lives until `clear_graphs()` (the counterpart of `jax.clear_caches()`), a
`jit` function's graphs until the function goes.  A graph is never
destroyed while another one is being captured (destroying a graph releases
its pool and unregisters its generators, which breaks a capture under
way): the graphs of a `jit` function that dies, or of `clear_graphs`, wait
until the next entry-point call outside a capture.

A replay launches each hand-written kernel as often as the capture
recorded it (`Capture.launches`, per kernel); each replay adds that many
to the kernel's count (`kernels.common`), so the counts still show that a
path went through the kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import inspect
import threading
import time
import warnings
import weakref
from typing import Callable, List

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..model.tree import KinematicTree, refresh_derived
from .observability import profiling, span

# process-wide, like jax.disable_jit: a sharded solve's host threads see it
_DISABLED = False
# captures and graph lookups
_LOCK = threading.RLock()
# the graphs of `run` and `scan` by key (the tree's topology is part of it):
# they live until `clear_graphs`, as JAX's compile cache does, and hold no
# reference to a caller's tree
_CACHE: dict = {}
# the graphs of `jit` functions: id(fn) -> (weak reference to fn, {key: graph})
_FNS: dict = {}
# every graph captured here: id -> (its replay, a weak reference to the
# call that replays it).  Destroying a graph releases its pool and
# unregisters its generators, which breaks a capture under way, so a graph
# is destroyed only by `_drain`, once its call is gone and no capture runs
# (whatever thread dropped the call, and whenever the collector freed it)
_GRAPHS: dict = {}
# keys of `_GRAPHS` whose call is gone (appended by the call's weakref callback)
_GONE: list = []
# graphs whose capture failed: kept, never destroyed (their capture's
# traceback may hold them until any later moment)
_FAILED: list = []
# side stream per device for warm-ups and captures
_SIDE: dict = {}
# set on a thread inside `inline()`
_INSIDE = threading.local()
# per tag: [replays, bytes copied in, bytes cloned out] (`copy_stats`)
_COPIES: dict = {}
_COPIES_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class Capture:
    """One capture: the entry point, its wall time (``seconds``, the sum of
    its three parts), the device memory the graph's private pool reserved,
    the bytes of its static input buffers, per hand-written kernel the
    launches one replay makes (``launches``, under the names of
    `kernels.common.KERNELS`), its nodes (the WHILE nodes' bodies
    included) and its WHILE nodes.  The parts: ``warm_seconds``, the eager warm-up (and
    loading what a WHILE node launches); ``record_seconds``, the body
    recorded under `torch.cuda.graph` with the WHILE bodies' own captures,
    from the capture's start (a device synchronisation and emptying the
    allocator's cache) to its end (`cudaStreamEndCapture`);
    ``instantiate_seconds``, `cudaGraphInstantiate` (the capture keeps its
    graph, ``CUDAGraph(keep_graph=True)``, and instantiates it apart).

    What a trace of a replay is attributed by (`observability.
    phase_device_us`): ``phases``, the solver phases the body recorded
    (`observability.phase`), each (name, first node, end node) over the
    graph's top-level nodes in the order the capture recorded them,
    contiguous from 0 to the last node (a stretch outside every phase is
    named None); ``graph``, a function that returns the kept graph (a
    `torch.cuda.CUDAGraph`) while it lives and None after, whose nodes
    `node_kinds` lists on first ask (None: the CPU tests' stand-in)."""

    tag: str
    seconds: float
    pool_bytes: int
    static_bytes: int
    launches: dict
    nodes: int = 0
    loops: tuple = ()
    warm_seconds: float = 0.0
    record_seconds: float = 0.0
    instantiate_seconds: float = 0.0
    phases: tuple = ()
    graph: Callable = None
    # `node_kinds`' answer, once asked
    listing: list = dataclasses.field(default_factory=list, compare=False, repr=False)


@dataclasses.dataclass(frozen=True)
class Loop:
    """One WHILE node of a capture: its body graph's nodes and, per carry
    tensor in order, the bytes its body copies back every trip (0 for one
    the body wrote in place or left as it was); ``body``, the body graph (a
    cudaGraph_t, which the WHILE node owns; None on the CPU)."""

    body_nodes: int
    copies: tuple
    body: int = None


# `node_kinds`' node types (cudaGraphNodeType) that a trace shows as a
# device operation, and the WHILE node's
NODE_KERNEL, NODE_MEMCPY, NODE_MEMSET, NODE_CONDITIONAL = 0, 1, 2, 13


# every capture of this process, in order (`no_recompile_guard` counts them)
CAPTURES: List[Capture] = []


@contextlib.contextmanager
def disable_graphs(disable: bool = True):
    """Run the entry points eagerly inside the block (``disable=False``
    turns graphs back on inside a disabled block); the previous setting is
    restored on exit.  Process-wide, the counterpart of `jax.disable_jit`."""
    global _DISABLED
    old = _DISABLED
    _DISABLED = disable
    try:
        yield
    finally:
        _DISABLED = old


@contextlib.contextmanager
def inline():
    """Entry points called on this thread inside the block run their bodies
    inline, uncaptured: inside a body being warmed up or captured (as a
    jitted function called inside another is traced into it)."""
    old = getattr(_INSIDE, "active", False)
    _INSIDE.active = True
    try:
        yield
    finally:
        _INSIDE.active = old


def clear_graphs() -> None:
    """Drop every captured graph and its memory pool (the next call of an
    entry point captures again), the counterpart of `jax.clear_caches`."""
    with _LOCK:
        _CACHE.clear()
        _FNS.clear()
        _drain()


def cached_graphs() -> int:
    """Graphs currently held: every entry point's and every live `jit`
    function's."""
    with _LOCK:
        _drain()
        return len(_CACHE) + sum(len(graphs) for _, graphs in _FNS.values())


_STATS = ("calls", "replays", "bytes_in", "bytes_out", "timed", "key_ns", "copy_in_ns",
          "replay_ns", "clone_out_ns")


def copy_stats() -> dict:
    """Per entry point's tag (a `jit` function's qualified name), since the
    process started: the calls that replayed a graph and their replays (a
    `scan` call replays its tick ``length`` times); the bytes they copied
    into the graphs' static buffers (a held tree's leaves are not copied
    again) and cloned out of them; and, of the ``timed`` calls among them,
    those made while no profiler ran, the host clock's nanoseconds of each
    step of the graph layer: ``key_ns`` (the inputs flattened, the key
    built and looked up), ``copy_in_ns``, ``replay_ns`` (the launches) and
    ``clone_out_ns``, as ``{tag: {"calls", "replays", "bytes_in",
    "bytes_out", "timed", "key_ns", "copy_in_ns", "replay_ns",
    "clone_out_ns"}}``.  Plain integer adds, always on."""
    with _COPIES_LOCK:
        return {tag: dict(zip(_STATS, v)) for tag, v in _COPIES.items()}


def _count_copies(tag, replays, bytes_in, bytes_out, clock) -> None:
    """Counts one call that replayed ``tag``'s graph; ``clock``: the host
    clock (`time.perf_counter_ns`) at the call's start (None: not timed),
    after its key, copy-in, replay and clone-out."""
    timed = clock[0] is not None and not profiling()
    with _COPIES_LOCK:
        v = _COPIES.setdefault(tag, [0] * len(_STATS))
        v[0] += 1
        v[1] += replays
        v[2] += bytes_in
        v[3] += bytes_out
        if timed:
            v[4] += 1
            for i in range(4):
                v[5 + i] += clock[i + 1] - clock[i]


def _drain() -> None:
    """Destroy the graphs whose calls are gone.  Called with `_LOCK` held,
    which every capture holds throughout, so no other thread is capturing;
    skipped while this thread captures."""
    if not capturing():
        while _GONE:
            _GRAPHS.pop(_GONE.pop(), None)


# --------------------------------------------------------------------------- #
# inputs and outputs as flat lists of tensors
# --------------------------------------------------------------------------- #

_T, _C, _S = "tensor", "constant", "scalar"

# the Python numbers `jit` traces, and the dtype of the 0-d tensor each
# becomes (a float stays exact in float64)
_NUMBERS = {bool: torch.bool, int: torch.int64, float: torch.float64,
            complex: torch.complex128}


def _flatten(x, leaves: list, trace: bool = False, trees=None):
    """Append the tensors of ``x`` (tensors, None, tuples, lists and
    dataclasses of them, hashable constants) to ``leaves``; returns the
    hashable structure that `_unflatten` rebuilds ``x`` from.  With
    ``trace``, a Python bool, int, float or complex or a numpy scalar
    outside a dataclass is a leaf too, appended as it is and keyed by its
    type (a numpy scalar by its dtype), not its value: `jit`'s traced
    scalars.  A dataclass's fields that are not tensors stay constants: a
    `KinematicTree`'s structure is its topology, loik_tpu's pytree aux data
    (parents, joint types, dof indexing, names, pitches, mimic pairs) and
    whether each tensor leaf is there, with its shape, dtype and device.
    ``trees``: a list that gets (first leaf, end of its leaves, the tree)
    for each tree in ``x``."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return (_T, tuple(x.shape), x.dtype, x.device)
    if x is None:
        return None
    if trace and (type(x) in _NUMBERS or isinstance(x, (np.number, np.bool_))):
        leaves.append(x)
        return (_S, x.dtype if isinstance(x, np.generic) else type(x))
    if dataclasses.is_dataclass(x):
        start = len(leaves)
        spec = (type(x), tuple((f.name, _flatten(getattr(x, f.name), leaves, trees=trees))
                               for f in dataclasses.fields(x)))
        if trees is not None and isinstance(x, KinematicTree):
            trees.append((start, len(leaves), x))
        return spec
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves, trace, trees) for v in x))
    hash(x)
    return (_C, x)


def _unflatten(spec, leaves, made=None):
    """``x`` from its structure and an iterator over its tensors; the trees
    it builds are appended to ``made`` (in `_flatten`'s order of
    ``trees``)."""
    if spec is None:
        return None
    kind = spec[0]
    if kind == _T or kind == _S:
        return next(leaves)
    if kind == _C:
        return spec[1]
    if dataclasses.is_dataclass(kind):
        x = kind(**{name: _unflatten(s, leaves, made) for name, s in spec[1]})
        if made is not None and isinstance(x, KinematicTree):
            made.append(x)
        return x
    return kind(_unflatten(s, leaves, made) for s in spec[1])


def _map(fn, x):
    """``x`` with ``fn`` applied to each of its tensors."""
    leaves: list = []
    spec = _flatten(x, leaves)
    return _unflatten(spec, iter([fn(t) for t in leaves]))


def _fresh(leaves):
    """Detached clones of ``leaves``; a tensor listed twice (a result field
    that is also a state field) is cloned once."""
    memo: dict = {}
    for t in leaves:
        if id(t) not in memo:
            memo[id(t)] = t.detach().clone()
    return [memo[id(t)] for t in leaves]


def _static(leaves):
    """Contiguous buffers shaped like ``leaves``, holding their values."""
    out = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in leaves]
    _copy_in(out, leaves)
    return out


def _copy_in(static, leaves, skip=()):
    """The tensors of ``leaves`` into ``static``, but for the positions in
    ``skip`` (a traced number among ``leaves`` is copied in by `_Call`, one
    copy per dtype)."""
    for i, (s, t) in enumerate(zip(static, leaves)):
        if isinstance(t, torch.Tensor) and i not in skip:
            s.copy_(t)


def _dead():
    return None


class _Trees:
    """The trees among a graph's inputs, as `jax.jit` takes a pytree: the
    topology is in the key, the leaves are inputs.  The graph holds each
    as a tree rebuilt on its static buffers (``made``, what the body reads
    and derives its casts and the kernel's S operand from), and knows by a
    weak reference which caller's tree the buffers hold now.  A call with
    that same tree copies none of its leaves (a tree is immutable); a call
    with another copies them in and recomputes in place what the graph's
    tree derived from them (`model.tree.refresh_derived`), so the replay
    reads that tree's geometry.  A failed copy or recomputation raises."""

    def __init__(self, tag, given, made, static):
        self.tag, self.made = tag, made
        self.held = [weakref.ref(t) for _, _, t in given]
        self.bytes = [_bytes(static[start:stop]) for start, stop, _ in given]

    def copy_in(self, static, leaves, given) -> int:
        """``leaves`` (of a call whose trees are ``given``) into ``static``;
        returns the bytes of the held trees' leaves, which it skipped."""
        skip, new, held = set(), [], 0
        for i, (start, stop, t) in enumerate(given):
            if self.held[i]() is t:
                skip.update(range(start, stop))
                held += self.bytes[i]
            else:
                self.held[i] = _dead     # until its leaves and derived values are in
                new.append(i)
        _copy_in(static, leaves, skip)
        for i in new:
            try:
                refresh_derived(self.made[i])
            except Exception as e:
                raise RuntimeError(
                    f"{self.tag}: recomputing the graph's casts and S operand from a new "
                    f"tree's leaves failed ({type(e).__name__}: {e})") from e
            self.held[i] = weakref.ref(given[i][2])
        return held


def _numbers(tag, leaves, device) -> list:
    """The traced numbers among ``leaves``, one group per dtype: (their
    positions, a host tensor of their values, pinned for a CUDA
    ``device``), in the order of their first positions.  Raises under
    ``tag`` for a number no tensor holds."""
    groups: dict = {}
    try:
        for i, v in enumerate(leaves):
            if not isinstance(v, torch.Tensor):
                dtype = (torch.from_numpy(np.asarray(v)).dtype if isinstance(v, np.generic)
                         else _NUMBERS[type(v)])
                pos, vals = groups.setdefault(dtype, ([], []))
                pos.append(i)
                vals.append(v)
        return [(pos, torch.tensor(vals, dtype=dtype, pin_memory=device.type == "cuda"))
                for dtype, (pos, vals) in groups.items()]
    except (TypeError, ValueError, RuntimeError, OverflowError) as e:
        raise _copy_failed(tag, device, e) from e


def _copy_failed(tag, device, e) -> RuntimeError:
    return RuntimeError(f"{tag}: copying its scalar arguments to {device} failed "
                        f"({type(e).__name__}: {e})")


def _on_device(tag, leaves, device, numbers) -> list:
    """``leaves`` with each traced number a 0-d tensor on ``device``: one
    copy from the host per dtype of ``numbers`` (`_numbers`), from pinned
    memory on a card, so that no call makes the host wait.  (A 0-d CPU
    tensor handed to a CUDA operator inside a capture would be baked into
    the graph as a kernel argument.)"""
    out = list(leaves)
    for pos, host in numbers:
        try:
            values = host.to(device, non_blocking=True).unbind(0)
        except RuntimeError as e:
            raise _copy_failed(tag, device, e) from e
        for i, t in zip(pos, values):
            out[i] = t
    return out


# --------------------------------------------------------------------------- #
# capture
# --------------------------------------------------------------------------- #


def _graph_device(device: torch.device) -> bool:
    """Whether entry points on ``device`` run as graphs."""
    return device.type == "cuda"


def _graphable(leaves) -> bool:
    from ..kernels import common

    if _DISABLED or common.CHECK_NANS or getattr(_INSIDE, "active", False) or capturing():
        return False
    if not leaves or not _graph_device(leaves[0].device):
        return False
    if any(t.device != leaves[0].device for t in leaves):
        return False
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in leaves))


def _side_stream(device):
    with _LOCK:
        s = _SIDE.get(device)
        if s is None:
            s = _SIDE[device] = torch.cuda.Stream(device)
        return s


def _warm_up(device, fn):
    """fn() on the device's side stream, the stream its capture runs on,
    with the current stream ordered before and after it."""
    if device.type != "cuda":
        return fn()
    side = _side_stream(device)
    cur = torch.cuda.current_stream(device)
    side.wait_stream(cur)
    with torch.cuda.device(device), torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    return out


def _capture_cuda(device, fn, generators=()):
    """Capture a call of ``fn`` as a CUDA graph on the side stream (the
    call runs nothing), the random generators ``generators`` registered with
    it (torch registers the default one itself).  Returns (replay, the
    captured call's outputs, the bytes its private pool reserved, its
    nodes, the seconds its instantiation took, `Capture.graph`)."""
    side = _side_stream(device)
    cur = torch.cuda.current_stream(device)
    # torch.cuda.graph empties the allocator's cache on entry; empty it here
    # first, so that the reserved bytes before and after are the pool's
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    # the capture's end leaves the graph uninstantiated: timed apart
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    for g in generators:
        graph.register_generator_state(g)
    first = None
    _INSIDE.body_pool = None
    try:
        with torch.cuda.device(device), torch.cuda.graph(
                graph, stream=side, capture_error_mode="thread_local"):
            _INSIDE.body_pool = (torch.cuda.current_device(), None)
            try:
                out = fn()
                nodes = _capture_nodes(side)
            except Exception as e:
                first = e
                raise
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            graph.instantiate()
        instantiate = time.perf_counter() - t0
    except Exception as e:
        # ending a broken capture raises too, before torch.cuda.graph
        # restores the stream: restore it, and raise the body's own error
        torch.cuda.set_stream(cur)
        _end_routing(failed=True)
        with _LOCK:
            _FAILED.append(graph)
        raise (first or e)
    body_pool = _end_routing()
    if body_pool is not None:
        # the WHILE bodies' pool lives as long as the graph
        weakref.finalize(graph, torch._C._cuda_releasePool, *body_pool)
    return (graph.replay, out, torch.cuda.memory_reserved(device) - reserved,
            nodes, instantiate, weakref.ref(graph))


# the capture backend (the CPU tests put a stand-in here)
_capture = _capture_cuda


def _captured(tag, device, warm_fn, fn, static_bytes, owner, generators=()):
    """A call of ``warm_fn`` run for real (the warm-up: it builds the
    kernel library, fills the graph tree's casts and S operand, sets the kernel's
    shared-memory limit, and its launches count; it raises what the eager
    call raises), then ``fn``, the same call, captured, with this thread
    marked as inside a body and its phases recorded (`_phases`), a failed
    capture raised under the entry point's name and the capture logged;
    the graph lives until ``owner``, the call that replays it, is gone
    (`_GRAPHS`).  Returns (the warm-up's outputs, replay, the captured
    call's outputs, per kernel the launches a replay makes)."""
    from ..kernels import common

    t0 = time.perf_counter()
    with inline():
        warm = _warm_up(device, warm_fn)
        _prepare(device)              # load what a WHILE node launches
        t1 = time.perf_counter()
        _INSIDE.capturing, _INSIDE.loops, _INSIDE.marks = True, [], []
        before = common.recorded()
        try:
            replay, out, pool, nodes, inst, graph = _capture(device, fn, generators)
        except Exception as e:
            raise RuntimeError(
                f"{tag}: capturing the CUDA graph failed ({type(e).__name__}: {e}); a "
                "captured body reads nothing on the host (no .item(), bool(t), int(t) or "
                "copy of host data to the device; for a utils.jit function, no Python "
                "control flow on a traced scalar argument: name it in static_argnums / "
                "static_argnames to bake it in); run it eagerly with "
                "loik_tpu_torch.utils.disable_graphs() to debug"
            ) from e
        finally:
            _INSIDE.capturing = False
            loops, _INSIDE.loops = tuple(_INSIDE.loops), []
            marks, _INSIDE.marks = _INSIDE.marks, None
    warm_s, record_s = t1 - t0, time.perf_counter() - t1 - inst
    launches = common.recorded_since(before)
    CAPTURES.append(Capture(tag, warm_s + record_s + inst, pool, static_bytes, launches,
                            nodes + sum(lp.body_nodes for lp in loops), loops,
                            warm_s, record_s, inst, _phases(marks, nodes), graph))
    key = id(replay)
    _GRAPHS[key] = (replay, weakref.ref(owner, lambda _, key=key, gone=_GONE: gone.append(key)))
    return warm, replay, out, launches


# --------------------------------------------------------------------------- #
# the masked while loop: a WHILE node inside a capture
# --------------------------------------------------------------------------- #

# body executions of host loops (the device's count: `_trips`)
_HOST_TRIPS = [0]
# per device: a counter of the body executions of replayed WHILE nodes, on
# the device (the condition kernel at the end of each body adds one)
_TRIPS: dict = {}
# per device: the stream a WHILE node's body is captured on
_BODY: dict = {}


def capturing() -> bool:
    """Whether this thread is capturing an entry point's graph now (a
    `while_loop` then becomes a WHILE node), or enqueues work into a
    capture under way: autograd's worker thread, which runs the backward
    of a `jit` function's capture on the capturing stream, sees the
    capture here (its entry points run inline, no graph is destroyed)."""
    return getattr(_INSIDE, "capturing", False) or _stream_capturing()


def _stream_capturing() -> bool:
    """Whether this thread's current CUDA stream is being captured."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def _trips(device) -> torch.Tensor:
    with _LOCK:
        t = _TRIPS.get(device)
        if t is None:
            t = _TRIPS[device] = torch.zeros((), dtype=torch.int64, device=device)
        return t


def body_executions() -> int:
    """Body executions of every `while_loop` since `reset_body_executions`,
    on the host and in replayed WHILE nodes (reads the devices)."""
    with _LOCK:
        return _HOST_TRIPS[0] + sum(int(t) for t in _TRIPS.values())


def reset_body_executions() -> None:
    with _LOCK:
        _HOST_TRIPS[0] = 0
        for t in _TRIPS.values():
            t.zero_()


def write_row(arr: torch.Tensor, row: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``arr`` with ``val`` written at index ``row`` (a one-element index
    tensor on the device) of its leading axis.  Inside a WHILE node's body,
    where ``arr`` is a carry buffer of the loop's own, it is written in
    place, so that the loop copies nothing back (a log of shape (max_iter,
    B) gets one row a trip); elsewhere into a new tensor."""
    if id(arr) in getattr(_INSIDE, "loop_buffers", ()):
        return arr.index_copy_(0, row, val)
    return arr.index_copy(0, row, val)


def while_loop(cond: Callable, body: Callable, carry):
    """``body`` applied to ``carry`` while ``cond(carry)`` holds: the
    counterpart of `lax.while_loop`.  ``cond`` returns a one-element bool
    tensor on the carry's device; ``body`` returns a carry of the same
    structure, dtypes and shapes.

    Outside a capture (CPU tensors, `disable_graphs()`, a graph's warm-up,
    `debug_nans`, a verbose solve) it is a host loop that reads the
    predicate once per body call.  Inside an entry point's capture it is a
    CUDA graph WHILE node (`kernels/csrc/graph_while.cu`) and reads nothing
    on the host: the carry is copied into buffers of the loop's own, a
    kernel sets the node's condition from ``cond`` of them (so a loop may
    run no body at all), the body is captured ONCE into the node's body
    graph on a stream of its own and writes its result back into the
    buffers (`write_row` writes into them in place), and a last kernel sets
    the condition from ``cond`` of the new carry and counts the body
    execution (`body_executions`).  The buffers are the
    loop's result.  A body that cannot be captured (one that reads the
    device, copies host data to it, or records an event) fails the entry
    point's capture, which raises."""
    if not capturing():
        while bool(cond(carry)):
            carry = body(carry)
            with _LOCK:
                _HOST_TRIPS[0] += 1
        return carry
    if not getattr(_INSIDE, "capturing", False):
        raise RuntimeError("while_loop: a WHILE node is added only on the thread that "
                           "captures, not in a captured backward")

    leaves: list = []
    spec = _flatten(carry, leaves)
    dev = leaves[0].device
    # one buffer per leaf: no two alias, and no tensor of the caller's is written
    bufs = [t.clone() for t in leaves]
    carry = _unflatten(spec, iter(bufs))
    copies: list = []

    def step():
        _INSIDE.loop_buffers = {id(b) for b in bufs}
        try:
            new = body(carry)
        finally:
            _INSIDE.loop_buffers = ()
        new_leaves: list = []
        if _flatten(new, new_leaves) != spec:
            raise ValueError("while_loop: the body returned a carry of another "
                             "structure, dtype or shape than it was given")
        # every new leaf is computed before any buffer is written; one that
        # IS another buffer (a swap) is read before that one is overwritten
        ptrs = {t.untyped_storage().data_ptr(): i for i, t in enumerate(bufs)}
        new_leaves = [x.clone() if ptrs.get(x.untyped_storage().data_ptr(), i) != i else x
                      for i, x in enumerate(new_leaves)]
        copies.clear()
        for dst, src in zip(bufs, new_leaves):
            copies.append(0 if src is dst else dst.numel() * dst.element_size())
            if src is not dst:
                dst.copy_(src)
        return cond(carry).reshape(())

    body_nodes, body_graph = _while_node(dev, cond(carry).reshape(()), step, _trips(dev))
    _INSIDE.loops.append(Loop(body_nodes, tuple(copies), body_graph))
    return carry


@functools.lru_cache(maxsize=None)
def _while_library():
    """The kernel library with the WHILE node's C functions declared."""
    from ..kernels import _build

    lib = _build.load()
    lib.loik_while_prepare.argtypes = []
    lib.loik_while_begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.loik_while_end.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.loik_while_abort.argtypes = [ctypes.c_void_p]
    lib.loik_capture_nodes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.loik_capture_graph.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.loik_graph_nodes.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t)]
    for name in ("loik_while_prepare", "loik_while_begin", "loik_while_end",
                 "loik_while_abort", "loik_capture_nodes", "loik_capture_graph",
                 "loik_graph_nodes"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _check(lib, err, what):
    from ..kernels import common

    if err:
        raise RuntimeError(f"while_loop: {what} failed: {common.cuda_error(err, lib)}")


def _prepare(device) -> None:
    """Before a capture: the library built and loaded, the condition
    kernel's module loaded, the trip counter and the body stream made."""
    if device.type != "cuda":
        return
    lib = _while_library()
    with torch.cuda.device(device):
        _check(lib, lib.loik_while_prepare(), "loading the condition kernel")
    _trips(device)
    _body_stream(device)


def _body_stream(device):
    with _LOCK:
        s = _BODY.get(device)
        if s is None:
            s = _BODY[device] = torch.cuda.Stream(device)
        return s


def _capture_nodes(stream) -> int:
    """Nodes of the graph being captured on ``stream`` (0 off the card)."""
    if not isinstance(stream, torch.cuda.Stream):
        return 0
    lib = _while_library()
    n = ctypes.c_ulonglong()
    _check(lib, lib.loik_capture_nodes(stream.cuda_stream, ctypes.byref(n)),
           "counting the graph's nodes")
    return n.value


def _capture_stream():
    """The stream this thread captures on now (None off the card)."""
    return torch.cuda.current_stream() if torch.cuda.is_initialized() else None


def _phases(marks, nodes) -> tuple:
    """(name, first node, end node) of each stretch of a capture's
    top-level nodes: ``marks`` holds (node count, the phase from there on)
    as `observability.phase` recorded them at its entries and exits, in
    order; the stretch before the first mark and any stretch outside every
    phase are named None; ``nodes``: the nodes at the capture's end.  The
    stretches are contiguous and cover every node; an empty one is left
    out, and neighbours of one name are one."""
    out: list = []
    bounds = [(0, None)] + list(marks)
    ends = [n for n, _ in bounds[1:]] + [max(nodes, bounds[-1][0])]
    for (first, name), end in zip(bounds, ends):
        if end <= first:
            continue
        if out and out[-1][0] == name and out[-1][2] == first:
            out[-1] = (name, out[-1][1], end)
        else:
            out.append((name, first, end))
    return tuple(out)


def _list_nodes_cuda(graph) -> tuple:
    """(kinds, linear) of the nodes of ``graph`` (a cudaGraph_t): per node
    in the order the capture recorded them, its `cudaGraphNodeType` and,
    for a kernel node, its function's name as a trace shows it (demangled;
    "" for another node); and whether the nodes form one chain in that
    order, as a capture on one stream records them (a replay then runs
    them in it)."""
    from ..kernels import common

    lib = _while_library()
    n_max, cap = 4096, 1 << 20
    while True:
        types, chained = (ctypes.c_int * n_max)(), (ctypes.c_int * n_max)()
        names = ctypes.create_string_buffer(cap)
        n, used = ctypes.c_size_t(), ctypes.c_size_t()
        err = lib.loik_graph_nodes(ctypes.c_void_p(graph), n_max, types, chained, names,
                                   cap, ctypes.byref(n), ctypes.byref(used))
        if err and (n.value > n_max or used.value > cap):
            n_max, cap = max(n_max, n.value), max(cap, used.value)
            continue
        if err:
            raise RuntimeError(common.cuda_error(err, lib))
        break
    lines = names.raw[:used.value].decode(errors="replace").split("\n")
    kinds = tuple((types[i], lines[i]) for i in range(n.value))
    return kinds, all(chained[i] == 1 for i in range(n.value))


# the node listing backend (the CPU tests put a stand-in here)
_list_nodes = _list_nodes_cuda


def node_kinds(cap: Capture):
    """((kinds, linear) of ``cap``'s graph, the same of each WHILE node's
    body in `Capture.loops`' order), as `_list_nodes_cuda` gives them, read
    from the kept graph on the first ask and kept; None while the graph is
    gone or has no listing.  A graph whose nodes cannot be listed warns
    once: a trace of its replays is not split by phase."""
    if cap.listing:
        return cap.listing[0]
    graph = cap.graph() if cap.graph is not None else None
    if graph is None:
        return None
    try:
        # ``graph`` held here keeps its WHILE nodes' bodies alive
        listing = (_list_nodes(graph.raw_cuda_graph()),
                   tuple(_list_nodes(lp.body) for lp in cap.loops))
    except RuntimeError as e:
        warnings.warn(f"{cap.tag}: the captured graph's nodes could not be listed ({e}); "
                      "a trace of its replays is not split by phase")
        listing = None
    cap.listing.append(listing)
    return listing


def _end_routing(failed=False):
    """After a capture: end the routing of this thread's allocations to the
    pool of its WHILE bodies, if one began; returns that pool's (device,
    id), or None (also when the capture ``failed``: the pool is released)."""
    idx, pool = getattr(_INSIDE, "body_pool", None) or (None, None)
    _INSIDE.body_pool = None
    if pool is None:
        return None
    torch._C._cuda_endAllocateToPool(idx, pool)
    if failed:
        torch._C._cuda_releasePool(idx, pool)
        return None
    return idx, pool


def _while_node_cuda(device, pred: torch.Tensor, step: Callable, trips: torch.Tensor):
    """A WHILE node on the capture's current stream whose condition is
    ``pred`` (a 0-d bool tensor) and whose body is the capture of
    ``step()``, which returns the next condition, on the device's body
    stream (a WHILE body holds no WHILE node); the kernel that ends the body
    adds one to ``trips`` (an int64 on the device).  The body's allocations
    come from a private pool of their own that lives as long as the graph.
    Returns the body graph's nodes and the body graph (`Loop.body`)."""
    lib = _while_library()
    idx, pool = _INSIDE.body_pool
    if pool is None:
        # torch routes to the graph's pool only what its own capture
        # allocates, and refuses a second routing to that pool; the body
        # stream's capture is another, so this thread's allocations go to a
        # second private pool, which lives as long as the graph, until the
        # capture has ended (the parent's allocations still match the
        # parent's routing first)
        pool = torch.cuda.graph_pool_handle()
        torch._C._cuda_beginAllocateCurrentThreadToPool(idx, pool)
        _INSIDE.body_pool = (idx, pool)
    body = _body_stream(device)
    parent = torch.cuda.current_stream(device)
    handle = ctypes.c_ulonglong()
    _check(lib, lib.loik_while_begin(parent.cuda_stream, body.cuda_stream, pred.data_ptr(),
                                     _THREAD_LOCAL, ctypes.byref(handle)),
           "adding the WHILE node")
    try:
        with torch.cuda.stream(body):
            nxt = step()
    except BaseException:
        lib.loik_while_abort(body.cuda_stream)
        raise
    graph = ctypes.c_void_p()
    _check(lib, lib.loik_capture_graph(body.cuda_stream, ctypes.byref(graph)),
           "finding the WHILE node's body graph")
    nodes = ctypes.c_ulonglong()
    _check(lib, lib.loik_while_end(body.cuda_stream, handle, nxt.data_ptr(),
                                   trips.data_ptr(), ctypes.byref(nodes)),
           "capturing the WHILE node's body")
    # the body graph lives on in the node
    return nodes.value, graph.value


# cudaStreamCaptureModeThreadLocal, the mode of every capture here
_THREAD_LOCAL = 1
# the WHILE node backend (the CPU tests put a stand-in here)
_while_node = _while_node_cuda


# `_graph`'s marker of a call that a capture answered itself
_NONE = object()


def _forget(ref, fid):
    """The weakref callback of a `jit` function that died: its calls go
    (their graphs wait in `_GRAPHS` for `_drain`)."""
    slot = _FNS.get(fid)
    if slot is not None and slot[0] is ref:
        del _FNS[fid]


def _graph(key, build: Callable, fn=None):
    """``(graph, result)``: the graph of ``key`` (of the `jit` function
    ``fn``, when given) and `_NONE`; on a miss, ``build()``'s new graph and
    the result of the call that built it."""
    with _LOCK:
        _drain()
        graphs = _CACHE
        if fn is not None:
            fid = id(fn)
            slot = _FNS.get(fid)
            if slot is None or slot[0]() is not fn:
                slot = _FNS[fid] = (weakref.ref(fn, functools.partial(_forget, fid=fid)), {})
            graphs = slot[1]
        g = graphs.get(key)
        if g is not None:
            return g, _NONE
        try:
            g, result = build()
        finally:
            _drain()
        graphs[key] = g
        return g, result


def _bytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


class _Call:
    """A captured call of ``body`` on static copies of its inputs, the
    trees among them (``trees``, `_flatten`'s) rebuilt on those copies
    (`_Trees`).  The call that captures it is answered by the warm-up
    (`first`).  With a ``generator`` the body draws from, the warm-up draws
    from it and the graph from a generator of its own (`rng`), registered
    with it.  The traced numbers of a `jit` call (``numbers``, `_numbers`:
    their positions among ``leaves``, which holds them as 0-d tensors) get
    one static buffer per dtype, whose 0-d views are their inputs."""

    def __init__(self, tag, body, spec, leaves, trees=(), generator=None, numbers=()):
        self.lock = threading.Lock()
        self.tag = tag
        self.static = _static(leaves)
        self.numbers = []
        for pos, _ in numbers:
            buf = torch.stack([self.static[i] for i in pos])
            for i, t in zip(pos, buf.unbind(0)):
                self.static[i] = t
            self.numbers.append(buf)
        # the body gets detached aliases of the buffers, the same ones in
        # the warm-up and the capture: a `jit` function that marks an input
        # to be differentiated leaves the buffers as they are
        made: list = []
        args = _unflatten(spec, iter([t.detach() for t in self.static]), made)
        self.trees = _Trees(tag, trees, made, self.static)
        # the bytes a call copies in when it holds no tree of the graph's
        positions = {i for pos, _ in numbers for i in pos}
        self.in_bytes = _bytes(t for i, t in enumerate(self.static) if i not in positions)
        self.in_bytes += _bytes(self.numbers)
        dev = leaves[0].device
        self.rng = None if generator is None else torch.Generator(device=dev)
        given, own = ((), ()) if generator is None else ((generator,), (self.rng,))
        warm, self.replay, out, self.launches = _captured(
            tag, dev, lambda: body(*args, *given), lambda: body(*args, *own),
            _bytes(self.static), self, own)
        self.out = []
        self.out_spec = _flatten(out, self.out)
        # detached (a tensor listed twice stays one): the capture's autograd
        # record goes, its buffers stay in the graph's pool
        memo: dict = {}
        self.out = [memo.setdefault(id(t), t.detach()) for t in self.out]
        self.out_bytes = _bytes(memo.values())
        warm_leaves: list = []
        _flatten(warm, warm_leaves)
        self.first = _unflatten(self.out_spec, iter(_fresh(warm_leaves)))

    def __call__(self, leaves, trees=(), generator=None, numbers=(), start=None):
        """A replay of the graph on ``leaves``; ``start``: the host clock
        (`time.perf_counter_ns`) when the call's key began (`copy_stats`;
        None: the call is not timed)."""
        from ..kernels import common

        tag = self.tag
        clock = [start, time.perf_counter_ns()]
        with self.lock:
            with span("graphs.copy_in", tag):
                held = self.trees.copy_in(self.static, leaves, trees)
                for buf, (_, host) in zip(self.numbers, numbers):
                    try:
                        buf.copy_(host, non_blocking=True)
                    except RuntimeError as e:
                        raise _copy_failed(tag, buf.device, e) from e
                if self.rng is not None:
                    # the replay draws from the graph's generator at the
                    # caller's seed and offset, and hands the advanced offset back
                    self.rng.set_state(generator.get_state())
            clock.append(time.perf_counter_ns())
            with span("graphs.replay", tag):
                self.replay()
            clock.append(time.perf_counter_ns())
            with span("graphs.clone_out", tag):
                if self.rng is not None:
                    generator.set_state(self.rng.get_state())
                common.replayed(self.launches, 1)
                out = _unflatten(self.out_spec, iter(_fresh(self.out)))
            clock.append(time.perf_counter_ns())
            _count_copies(tag, 1, self.in_bytes - held, self.out_bytes, clock)
            return out


def run(tag: str, tree, statics: tuple, body: Callable, args: tuple,
        capture: bool = True, generator=None):
    """``body(tree, *args)``: as a replayed CUDA graph when ``capture`` and
    the tensors of ``tree`` and ``args`` lie on the card (and graphs are
    on), else eagerly.

    The tree is an input as ``args`` are, as `jax.jit` takes loik_tpu's
    pytree: its topology is part of the key and its leaves are copied into
    the graph's buffers, so another tree of the same topology (a robot
    loaded anew, a calibrated copy) replays the graph on its own geometry
    (`_Trees`).  The body reads the tree it is given, never a caller's.
    ``statics`` holds every value the body bakes in besides the structure
    of ``tree`` and ``args``; ``capture=False`` is for bodies that cannot
    be captured (a verbose solve prints from the host every body call).
    ``generator``: a `torch.Generator` the body draws from, passed to it
    as its last argument (without one, a body draws from torch's default
    generator, which every graph registers itself).  The graph draws from
    a generator of its own, registered with it, that takes ``generator``'s
    seed and offset before each replay and hands the advanced offset back
    after it: each call advances ``generator`` as an eager call does and
    draws the same numbers, the graph holds no reference to it, and
    another generator object is no new key (as a new PRNG key is no new
    compile in JAX)."""
    def build():
        g = _Call(tag, body, spec, leaves, trees, generator)
        return g, g.first

    start = time.perf_counter_ns()
    with span("graphs.key", tag):
        leaves: list = []
        trees: list = []
        spec = _flatten((tree,) + tuple(args), leaves, trees=trees)
        given = () if generator is None else (generator,)
        graphed = capture and _graphable(leaves)
        if graphed:
            g, result = _graph((tag, statics, spec, bool(given)), build)
    if not graphed:
        return body(tree, *args, *given)
    return g(leaves, trees, generator, start=start) if result is _NONE else result


class ConcretizationTypeError(TypeError):
    """A value read on the host inside the capture of a `utils.jit`
    function: the counterpart of jax's ``ConcretizationTypeError``."""


class _NoHostValues(TorchFunctionMode):
    """On while a `jit` function that has traced scalars is captured: a
    read of a device value on the host (`bool(t)`, `int(t)`, `range(t)`,
    `.item()`, ...) raises before it happens, naming the traced scalar
    argument read (``names``: id of its tensor -> its name) when it is one.
    On the card such a read fails the capture anyway; here it fails with
    its cause, and the CPU stand-in of the tests sees it too."""

    READS = frozenset({"__bool__", "__int__", "__float__", "__complex__", "__index__",
                       "item", "tolist", "numpy"})

    def __init__(self, tag, names):
        super().__init__()
        self.tag, self.names = tag, names

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", None)
        if (name in self.READS and args and isinstance(args[0], torch.Tensor)
                and _graph_device(args[0].device)):
            arg = self.names.get(id(args[0]))
            what = (f"the traced scalar argument {arg}" if arg else
                    "a device tensor (the traced scalar arguments of this call: "
                    + ", ".join(sorted(set(self.names.values()))) + ")")
            raise ConcretizationTypeError(
                f"{self.tag}: {name} of {what} inside the capture; a traced number has "
                "no value on the host, so Python control flow on it (if, range, a shape) "
                "cannot be captured: name it in static_argnums / static_argnames to bake "
                "its value in")
        return func(*args, **(kwargs or {}))


def jit(fn: Callable, static_argnums=(), static_argnames=()) -> Callable:
    """``fn`` as a captured CUDA graph: the counterpart of `jax.jit` for a
    function of tensors and numbers.  The training step of the
    differentiable solve is the case it is for: a function that marks what
    it differentiates (``x.requires_grad_()``), calls `solve_unrolled` and
    `torch.autograd.grad` (second order too, with ``create_graph=True``)
    and returns the value and its derivatives, as
    ``jax.jit(lambda x: (loss(x), jax.grad(loss)(x)))`` does::

        @loik_tpu_torch.utils.jit
        def step(bz, weight):
            bz.requires_grad_()
            value = weight * loss(bz)
            g, = torch.autograd.grad(value, bz, create_graph=True)
            h, = torch.autograd.grad(g, bz)
            return value, g, h

    On CUDA tensors the first call of a key runs ``fn`` (its result is that
    call's) and then captures ONE call of it as a CUDA graph, forward and
    backward alike (autograd's worker thread runs the backward on the
    capturing stream); later calls copy the tensors into the graph's static
    input buffers and replay it.  Positional and keyword arguments alike
    (keywords in the order of their names).  The key: ``fn`` by identity
    (its graphs go when it does), the structure of the arguments (tensors,
    None, numbers, tuples, lists and dataclasses of them), each tensor's
    device, dtype and shape, each number's type, and the value of every
    other argument (hashable: a static, baked into the graph).  A
    `KinematicTree` among the arguments is keyed by its topology and its
    leaves are inputs, as in `run`: another tree of the topology replays on
    its own geometry, the casts and S operand derived from it included.

    Numbers are traced, as `jax.jit` traces them: a Python bool, int,
    float or complex, or a numpy scalar, among the arguments (in a tuple or
    list among them too, but not a dataclass's field, which stays static)
    reaches ``fn`` as a 0-d tensor on the arguments' device: bool, int64,
    float64 (the value stays exact) and complex128, a numpy scalar in its
    own dtype.  So a new value is no new capture: one pinned host tensor
    per dtype is copied into the graph, without a host synchronisation.
    Those named by ``static_argnums`` (positions) or ``static_argnames``
    (names; as in `jax.jit`, either also marks the other through ``fn``'s
    signature) are keyed by value and reach ``fn`` as they are.  A
    function with no tensor argument runs eagerly, its numbers 0-d CPU
    tensors.

    A traced number has no value on the host inside the capture: Python
    control flow on it (``if flag:``, ``range(n)``, a shape) raises
    `ConcretizationTypeError` (under the capture's `RuntimeError`), naming
    the argument and ``static_argnums`` / ``static_argnames``; it is never
    baked in.  Its type promotion is torch's: a 0-d tensor does not
    promote a tensor with dimensions of its category, as jax's weak types
    do not (a float32 tensor times a traced float is float32, an int32
    tensor times a traced int is int32), but it joins 0-d tensors (a 0-d
    float32 tensor times a traced float is float64; jax: float32) and
    promotes across categories to its own dtype (an int32 tensor times a
    traced float is float64; jax: float32 without x64).  CUDA divides a
    tensor by a Python float as a multiply by its reciprocal but by a 0-d
    tensor exactly, so ``fn`` called with the raw number may differ in the
    last bits; every path of this function hands ``fn`` the same 0-d
    tensors.

    ``fn`` gets detached leaves that share the buffers' memory; the
    results are detached fresh tensors, as `run`'s.  Tensors that ``fn``
    closes over are read where they lie at every replay: they live as long
    as ``fn``, and a new value must be written into them in place, not
    bound to the name.  ``fn`` reads nothing back to the host (no
    ``.item()``, ``bool(t)`` or copy of host data to the card), as every
    captured body.

    Eagerly on CPU tensors, under `disable_graphs()` and while `debug_nans`
    is on: ``fn`` on detached aliases of the arguments, its results
    detached.  When an argument already requires a gradient (under grad
    mode), ``fn`` on the arguments as they are, eagerly: a graph would cut
    that argument's autograd record, and the results could not be
    differentiated back to it.  A failed capture, or a failed copy of the
    numbers, raises under ``fn``'s name; it never runs eagerly instead.
    Each capture is logged in `CAPTURES`; `clear_graphs()` frees the
    graphs."""
    tag = getattr(fn, "__qualname__", None) or repr(fn)
    nums = {static_argnums} if isinstance(static_argnums, int) else set(static_argnums)
    names = {static_argnames} if isinstance(static_argnames, str) else set(static_argnames)
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        params = ()
    positional = [p.name for p in params
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    nums |= {i for i, p in enumerate(positional) if p in names}
    names |= {positional[i] for i in nums if -len(positional) <= i < len(positional)}

    def split(args, kwargs, leaves, labels, trees):
        """The key of a call; its tensors and numbers appended to
        ``leaves``, each number's argument name put in ``labels``, its
        trees in ``trees``."""
        static = {i % len(args) for i in nums if -len(args) <= i < len(args)}
        pos, kw = [], []
        for i, a in enumerate(args):
            n = len(leaves)
            pos.append(_flatten(a, leaves, trace=i not in static, trees=trees))
            name = f"'{positional[i]}' (argument {i})" if i < len(positional) else f"argument {i}"
            labels.update((j, name) for j in range(n, len(leaves))
                          if not isinstance(leaves[j], torch.Tensor))
        for key in sorted(kwargs):
            n = len(leaves)
            kw.append((tuple, ((_C, key), _flatten(kwargs[key], leaves, trace=key not in names,
                                                   trees=trees))))
            labels.update((j, f"'{key}'") for j in range(n, len(leaves))
                          if not isinstance(leaves[j], torch.Tensor))
        return (tuple, ((tuple, tuple(pos)), (tuple, tuple(kw))))

    def body(labels, args, kwargs):
        leaves: list = []
        _flatten((args, kwargs), leaves)
        for t in leaves:            # the capture finds them as the warm-up did
            t.requires_grad_(False)
        if not (labels and getattr(_INSIDE, "capturing", False)):
            return fn(*args, **dict(kwargs))
        with _NoHostValues(tag, {id(leaves[i]): name for i, name in labels.items()}):
            return fn(*args, **dict(kwargs))

    @functools.wraps(fn)
    def jitted(*args, **kwargs):
        def build():
            g = _Call(tag, functools.partial(body, labels), spec,
                      _on_device(tag, leaves, device, numbers), trees, numbers=numbers)
            return g, g.first

        start = time.perf_counter_ns()
        with span("graphs.key", tag):
            leaves: list = []
            labels: dict = {}
            trees: list = []
            spec = split(args, kwargs, leaves, labels, trees)
            tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
            device = tensors[0].device if tensors else torch.device("cpu")
            numbers = _numbers(tag, leaves, device)
            grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
            graphed = not grad and _graphable(tensors)
            if graphed:
                g, result = _graph(spec, build, fn)
        if not graphed:
            eager = _on_device(tag, leaves, device, numbers)
            if not grad:
                eager = [t.detach() for t in eager]
            pos, kw = _unflatten(spec, iter(eager))
            out = fn(*pos, **dict(kw))
            return out if grad else _map(torch.Tensor.detach, out)
        return g(leaves, trees, numbers=numbers, start=start) if result is _NONE else result

    return jitted


def _stack(ys):
    leaves = []
    spec = _flatten(ys[0], leaves)
    cols = [leaves]
    for y in ys[1:]:
        cols.append([])
        _flatten(y, cols[-1])
    return _unflatten(spec, iter([torch.stack(col) for col in zip(*cols)]))


class _Scan:
    """One tick captured on static buffers, replayed ``length`` times; the
    tree rebuilt on its buffers (`_Trees`)."""

    def __init__(self, tag, tick, spec, leaves, trees, length):
        self.lock = threading.Lock()
        self.tag, self.length = tag, length
        self.static = _static(leaves)
        made: list = []
        tree, carry, xs, consts = _unflatten(spec, iter(self.static), made)
        self.trees = _Trees(tag, trees, made, self.static)
        carry_leaves: list = []
        carry_spec = _flatten(carry, carry_leaves)
        self.carry_spec, self.carry = carry_spec, carry_leaves
        dev = leaves[0].device
        # the tick counter lives on the device: the graph indexes xs with it
        self.t = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.ys = None

        def step():
            x_t = _map(lambda x: x.index_select(0, self.t)[0], xs)
            new, y = tick(tree, carry, x_t, consts)
            new_leaves: list = []
            if _flatten(new, new_leaves) != carry_spec:
                raise ValueError(f"{tag}: a tick returned a carry of another "
                                 "structure, dtype or shape than it was given")
            # a new carry leaf that shares memory with ANOTHER carry buffer
            # would read that buffer after it is overwritten: copy it first
            ptrs = {c.untyped_storage().data_ptr(): i for i, c in enumerate(carry_leaves)}
            new_leaves = [
                x.clone() if ptrs.get(x.untyped_storage().data_ptr(), i) != i else x
                for i, x in enumerate(new_leaves)]
            # the outputs first: one may be a carry buffer as the tick read it
            y_leaves: list = []
            self.y_spec = _flatten(y, y_leaves)
            if self.ys is None:    # the warm-up: outputs shaped from its tick
                self.ys = [torch.empty((length,) + tuple(v.shape), dtype=v.dtype,
                                       device=v.device) for v in y_leaves]
            for buf, v in zip(self.ys, y_leaves):
                buf.index_copy_(0, self.t, v.unsqueeze(0))
            for dst, src in zip(carry_leaves, new_leaves):
                dst.copy_(src)
            self.t.add_(1)

        _, self.replay, _, self.launches = _captured(tag, dev, step, step,
                                                     _bytes(self.static), self)
        self.out_bytes = _bytes({id(t): t for t in self.carry + self.ys}.values())

    def __call__(self, leaves, trees, start=None):
        """The ticks replayed on ``leaves``; ``start`` as `_Call`'s."""
        from ..kernels import common

        tag = self.tag
        clock = [start, time.perf_counter_ns()]
        with self.lock:
            with span("graphs.copy_in", tag):
                held = self.trees.copy_in(self.static, leaves, trees)
                self.t.zero_()
            clock.append(time.perf_counter_ns())
            with span("graphs.replay", tag):
                for _ in range(self.length):
                    self.replay()
            clock.append(time.perf_counter_ns())
            with span("graphs.clone_out", tag):
                common.replayed(self.launches, self.length)
                out = (_unflatten(self.carry_spec, iter(_fresh(self.carry))),
                       _unflatten(self.y_spec, iter(_fresh(self.ys))))
            clock.append(time.perf_counter_ns())
            _count_copies(tag, self.length, _bytes(self.static) - held, self.out_bytes, clock)
            return out


def scan(tag: str, tree, statics: tuple, tick: Callable, carry, xs, consts,
         length: int, capture: bool = True):
    """``length`` ticks of ``tick(tree, carry, x_t, consts) -> (carry,
    y_t)``, where ``x_t`` is ``xs`` (tensors with a leading tick axis, or
    None) at tick t; returns the last carry and the ``y_t`` stacked on a
    leading tick axis.  The carry keeps its structure, dtypes and shapes
    from tick to tick.  A replayed CUDA graph of one tick when ``capture``
    and the tensors lie on the card (and graphs are on), else a loop of
    eager ticks.  The tree is an input, keyed by its topology, as in
    `run`."""
    def build():
        nonlocal start
        start = None            # a capture's call is not timed (`copy_stats`)
        return _Scan(tag, tick, spec, leaves, trees, length), _NONE

    start = time.perf_counter_ns()
    with span("graphs.key", tag):
        leaves: list = []
        trees: list = []
        spec = _flatten((tree, carry, xs, consts), leaves, trees=trees)
        graphed = capture and _graphable(leaves)
        if graphed:
            g, _ = _graph((tag, statics, length, spec), build)
    if not graphed:
        ys = []
        for t in range(length):
            carry, y = tick(tree, carry, _map(lambda x: x[t], xs), consts)
            ys.append(y)
        return carry, _stack(ys)
    return g(leaves, trees, start)
