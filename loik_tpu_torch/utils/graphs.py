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

- `run(tag, tree, statics, body, args)`: one call of ``body(*args)``.  The
  tensors of ``args`` are copied into the graph's static input buffers,
  the graph is replayed, and the outputs are cloned, so every result is a
  fresh tensor (as JAX's arrays are) and a later call never overwrites an
  earlier result.
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

The key is the jit cache key: the tree by identity (held by a weak
reference: the tree's graphs go when it does), the entry point's ``tag``
and ``statics`` (the `SolverParams` and every other argument the body
bakes in, such as `batch_tile`, the stage caps or a tick count), and the
structure of the inputs with the device, dtype and shape of every tensor,
including which optional inputs were given.  Constants in the inputs
(constraint links) are part of it too.  Everything the fused kernel's
launch bakes into its graph node (`kernels.fused._LoikConfig`) follows from
these.

Semantics, as JAX's:
- On by default on the card; `disable_graphs()` (the counterpart of
  `jax.disable_jit()`) runs the same bodies eagerly, process-wide.
- On CPU tensors the bodies run eagerly, as always.
- A failed capture raises; it never quietly runs eagerly.
- While `utils.debug_nans` is on (its checks read the device after every
  operator and every launch) the bodies run eagerly.  So do calls whose
  inputs require a gradient (a graph would cut the autograd record).

The recipe is PyTorch's own: a warm-up call on a side stream (it builds
the kernel library, fills the per-tree caches and sets the kernel's
shared-memory limit), then the capture on that stream under
``torch.cuda.graph(..., capture_error_mode="thread_local")``.  The warm-up
is the first call's own work: `run` returns its result (clones, fresh
like every result), so a first call launches the kernel as often as an
eager one; a first `scan` runs one warm-up tick and then replays all
``length`` ticks.  Captures
take a lock (`parallel.sharding.run_sharded` solves each card's rows on a
host thread of its own); each graph takes its own lock around a call.
Each graph holds a private memory pool for its intermediates
(`Capture.pool_bytes`); `clear_graphs()` (the counterpart of
`jax.clear_caches()`) drops every graph.  A graph is never destroyed while
another one is being captured (destroying a graph releases its pool and
unregisters its generators, which breaks a capture under way): the graphs
of a tree that dies, or of `clear_graphs`, wait until the next entry-point
call outside a capture.

A replay launches the fused kernel as often as the capture recorded it
(`Capture.launches`); each replay adds that many to
`kernels.fused.LAUNCHES`, so the count still shows that a path went
through the kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import threading
import time
import weakref
from typing import Callable, List

import torch

# process-wide, like jax.disable_jit: a sharded solve's host threads see it
_DISABLED = False
# captures and graph lookups; the cache: id(tree) -> (weak ref, {key: graph})
_LOCK = threading.RLock()
_CACHE: dict = {}
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


@dataclasses.dataclass(frozen=True)
class Capture:
    """One capture: the entry point, its wall time (warm-up and capture),
    the device memory the graph's private pool reserved, the bytes of its
    static input buffers, the fused-kernel launches one replay makes, its
    nodes (the WHILE nodes' bodies included) and its WHILE nodes."""

    tag: str
    seconds: float
    pool_bytes: int
    static_bytes: int
    launches: int
    nodes: int = 0
    loops: tuple = ()


@dataclasses.dataclass(frozen=True)
class Loop:
    """One WHILE node of a capture: its body graph's nodes and, per carry
    tensor in order, the bytes its body copies back every trip (0 for one
    the body wrote in place or left as it was)."""

    body_nodes: int
    copies: tuple


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
    jitted function called inside another is traced into it), and around a
    one-shot call whose tree no later call shares, whose capture would
    never replay."""
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
        _drain()


def cached_graphs() -> int:
    """Graphs currently held, over every live tree."""
    with _LOCK:
        _drain()
        return sum(len(graphs) for _, graphs in _CACHE.values())


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

_T, _C = "tensor", "constant"


def _flatten(x, leaves: list):
    """Append the tensors of ``x`` (tensors, None, tuples, lists and
    dataclasses of them, hashable constants) to ``leaves``; returns the
    hashable structure that `_unflatten` rebuilds ``x`` from."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return (_T, tuple(x.shape), x.dtype, x.device)
    if x is None:
        return None
    if dataclasses.is_dataclass(x):
        return (type(x), tuple((f.name, _flatten(getattr(x, f.name), leaves))
                               for f in dataclasses.fields(x)))
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    hash(x)
    return (_C, x)


def _unflatten(spec, leaves):
    """``x`` from its structure and an iterator over its tensors."""
    if spec is None:
        return None
    kind = spec[0]
    if kind == _T:
        return next(leaves)
    if kind == _C:
        return spec[1]
    if dataclasses.is_dataclass(kind):
        return kind(**{name: _unflatten(s, leaves) for name, s in spec[1]})
    return kind(_unflatten(s, leaves) for s in spec[1])


def _map(fn, x):
    """``x`` with ``fn`` applied to each of its tensors."""
    leaves: list = []
    spec = _flatten(x, leaves)
    return _unflatten(spec, iter([fn(t) for t in leaves]))


def _fresh(leaves):
    """Clones of ``leaves``; a tensor listed twice (a result field that is
    also a state field) is cloned once."""
    memo: dict = {}
    for t in leaves:
        if id(t) not in memo:
            memo[id(t)] = t.clone()
    return [memo[id(t)] for t in leaves]


def _static(leaves):
    """Contiguous buffers shaped like ``leaves``, holding their values."""
    out = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in leaves]
    _copy_in(out, leaves)
    return out


def _copy_in(static, leaves):
    for s, t in zip(static, leaves):
        s.copy_(t)


# --------------------------------------------------------------------------- #
# capture
# --------------------------------------------------------------------------- #


def _graph_device(device: torch.device) -> bool:
    """Whether entry points on ``device`` run as graphs."""
    return device.type == "cuda"


def _graphable(leaves) -> bool:
    from ..kernels import fused

    if _DISABLED or fused.CHECK_NANS or getattr(_INSIDE, "active", False):
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
    captured call's outputs, the fused kernel launches it recorded, the
    bytes its private pool reserved, its nodes)."""
    from ..kernels import fused

    side = _side_stream(device)
    cur = torch.cuda.current_stream(device)
    # torch.cuda.graph empties the allocator's cache on entry; empty it here
    # first, so that the reserved bytes before and after are the pool's
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    n0 = fused.captured_launches()
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
    launches = fused.captured_launches() - n0
    return (graph.replay, out, launches, torch.cuda.memory_reserved(device) - reserved,
            nodes)


# the capture backend (the CPU tests put a stand-in here)
_capture = _capture_cuda


def _captured(tag, device, warm_fn, fn, static_bytes, owner, generators=()):
    """A call of ``warm_fn`` run for real (the warm-up: it builds the
    kernel library, fills the per-tree caches, sets the kernel's
    shared-memory limit, and its launches count; it raises what the eager
    call raises), then ``fn``, the same call, captured, with this thread
    marked as inside a body, a failed capture raised under the entry
    point's name and the capture logged; the graph lives until ``owner``,
    the call that replays it, is gone (`_GRAPHS`).  Returns (the warm-up's
    outputs, replay, the captured call's outputs, launches a replay
    makes)."""
    t0 = time.perf_counter()
    with inline():
        warm = _warm_up(device, warm_fn)
        _prepare(device)              # load what a WHILE node launches
        _INSIDE.capturing, _INSIDE.loops = True, []
        try:
            replay, out, launches, pool, nodes = _capture(device, fn, generators)
        except Exception as e:
            raise RuntimeError(
                f"{tag}: capturing the CUDA graph failed ({type(e).__name__}: {e}); "
                "run it eagerly with loik_tpu_torch.utils.disable_graphs() to debug"
            ) from e
        finally:
            _INSIDE.capturing = False
            loops, _INSIDE.loops = tuple(_INSIDE.loops), []
    CAPTURES.append(Capture(tag, time.perf_counter() - t0, pool, static_bytes, launches,
                            nodes + sum(lp.body_nodes for lp in loops), loops))
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
    `while_loop` then becomes a WHILE node)."""
    return getattr(_INSIDE, "capturing", False)


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

    body_nodes = _while_node(dev, cond(carry).reshape(()), step, _trips(dev))
    _INSIDE.loops.append(Loop(body_nodes, tuple(copies)))
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
    for name in ("loik_while_prepare", "loik_while_begin", "loik_while_end",
                 "loik_while_abort", "loik_capture_nodes"):
        getattr(lib, name).restype = ctypes.c_int
    lib.loik_cuda_error_string.argtypes = [ctypes.c_int]
    lib.loik_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, err, what):
    if err:
        raise RuntimeError(f"while_loop: {what} failed: "
                           f"{lib.loik_cuda_error_string(err).decode()} (cuda error {err})")


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


def _while_node_cuda(device, pred: torch.Tensor, step: Callable, trips: torch.Tensor) -> int:
    """A WHILE node on the capture's current stream whose condition is
    ``pred`` (a 0-d bool tensor) and whose body is the capture of
    ``step()``, which returns the next condition, on the device's body
    stream (a WHILE body holds no WHILE node); the kernel that ends the body
    adds one to ``trips`` (an int64 on the device).  The body's allocations
    come from a private pool of their own that lives as long as the graph.
    Returns the body graph's nodes."""
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
    nodes = ctypes.c_ulonglong()
    _check(lib, lib.loik_while_end(body.cuda_stream, handle, nxt.data_ptr(),
                                   trips.data_ptr(), ctypes.byref(nodes)),
           "capturing the WHILE node's body")
    return nodes.value


# cudaStreamCaptureModeThreadLocal, the mode of every capture here
_THREAD_LOCAL = 1
# the WHILE node backend (the CPU tests put a stand-in here)
_while_node = _while_node_cuda


# `_graph`'s marker of a call that a capture answered itself
_NONE = object()


def _forget(ref, tid, cache=_CACHE):
    """The weakref callback of a tree that died: its calls go (their graphs
    wait in `_GRAPHS` for `_drain`)."""
    slot = cache.get(tid)
    if slot is not None and slot[0] is ref:
        del cache[tid]


def _graph(tag, tree, key, build: Callable):
    """``(graph, result)``: the graph of ``key`` for ``tree`` and `_NONE`;
    on a miss, ``build()``'s new graph and the result of the call that
    built it."""
    with _LOCK:
        _drain()
        tid = id(tree)
        slot = _CACHE.get(tid)
        if slot is None or slot[0]() is not tree:
            slot = (weakref.ref(tree, functools.partial(_forget, tid=tid)), {})
            _CACHE[tid] = slot
        g = slot[1].get(key)
        if g is not None:
            return g, _NONE
        try:
            g, result = build()
        finally:
            _drain()
        slot[1][key] = g
        return g, result


def _bytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


class _Call:
    """A captured call of ``body`` on static copies of its inputs.  The call
    that captures it is answered by the warm-up (`first`).  With a
    ``generator`` the body draws from, the warm-up draws from it and the
    graph from a generator of its own (`rng`), registered with it."""

    def __init__(self, tag, body, spec, leaves, generator=None):
        self.lock = threading.Lock()
        self.static = _static(leaves)
        args = _unflatten(spec, iter(self.static))
        dev = leaves[0].device
        self.rng = None if generator is None else torch.Generator(device=dev)
        given, own = ((), ()) if generator is None else ((generator,), (self.rng,))
        warm, self.replay, out, self.launches = _captured(
            tag, dev, lambda: body(*args, *given), lambda: body(*args, *own),
            _bytes(self.static), self, own)
        self.out = []
        self.out_spec = _flatten(out, self.out)
        warm_leaves: list = []
        _flatten(warm, warm_leaves)
        self.first = _unflatten(self.out_spec, iter(_fresh(warm_leaves)))

    def __call__(self, leaves, generator=None):
        from ..kernels import fused

        with self.lock:
            _copy_in(self.static, leaves)
            if self.rng is not None:
                # the replay draws from the graph's generator at the
                # caller's seed and offset, and hands the advanced offset back
                self.rng.set_state(generator.get_state())
            self.replay()
            if self.rng is not None:
                generator.set_state(self.rng.get_state())
            fused.count_launches(self.launches)
            return _unflatten(self.out_spec, iter(_fresh(self.out)))


def run(tag: str, tree, statics: tuple, body: Callable, args: tuple,
        capture: bool = True, generator=None):
    """``body(*args)``: as a replayed CUDA graph when ``capture`` and the
    tensors of ``args`` lie on the card (and graphs are on), else eagerly.

    ``statics`` holds every value the body bakes in besides ``tree`` and
    the structure of ``args``; ``capture=False`` is for bodies that cannot
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
    leaves: list = []
    spec = _flatten(args, leaves)
    given = () if generator is None else (generator,)
    if not (capture and _graphable(leaves)):
        return body(*args, *given)
    def build():
        g = _Call(tag, body, spec, leaves, generator)
        return g, g.first

    g, result = _graph(tag, tree, (tag, statics, spec, bool(given)), build)
    return g(leaves, generator) if result is _NONE else result


def _stack(ys):
    leaves = []
    spec = _flatten(ys[0], leaves)
    cols = [leaves]
    for y in ys[1:]:
        cols.append([])
        _flatten(y, cols[-1])
    return _unflatten(spec, iter([torch.stack(col) for col in zip(*cols)]))


class _Scan:
    """One tick captured on static buffers, replayed ``length`` times."""

    def __init__(self, tag, tick, spec, leaves, length):
        self.lock = threading.Lock()
        self.length = length
        self.static = _static(leaves)
        carry, xs, consts = _unflatten(spec, iter(self.static))
        carry_leaves: list = []
        carry_spec = _flatten(carry, carry_leaves)
        self.carry_spec, self.carry = carry_spec, carry_leaves
        dev = leaves[0].device
        # the tick counter lives on the device: the graph indexes xs with it
        self.t = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.ys = None

        def step():
            x_t = _map(lambda x: x.index_select(0, self.t)[0], xs)
            new, y = tick(carry, x_t, consts)
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

    def __call__(self, leaves):
        from ..kernels import fused

        with self.lock:
            _copy_in(self.static, leaves)
            self.t.zero_()
            for _ in range(self.length):
                self.replay()
            fused.count_launches(self.launches * self.length)
            return (_unflatten(self.carry_spec, iter(_fresh(self.carry))),
                    _unflatten(self.y_spec, iter(_fresh(self.ys))))


def scan(tag: str, tree, statics: tuple, tick: Callable, carry, xs, consts,
         length: int, capture: bool = True):
    """``length`` ticks of ``tick(carry, x_t, consts) -> (carry, y_t)``,
    where ``x_t`` is ``xs`` (tensors with a leading tick axis, or None) at
    tick t; returns the last carry and the ``y_t`` stacked on a leading
    tick axis.  The carry keeps its structure, dtypes and shapes from tick
    to tick.  A replayed CUDA graph of one tick when ``capture`` and the
    tensors lie on the card (and graphs are on), else a loop of eager
    ticks."""
    leaves: list = []
    spec = _flatten((carry, xs, consts), leaves)
    if not (capture and _graphable(leaves)):
        ys = []
        for t in range(length):
            carry, y = tick(carry, _map(lambda x: x[t], xs), consts)
            ys.append(y)
        return carry, _stack(ys)
    g, _ = _graph(tag, tree, (tag, statics, length, spec),
                  lambda: (_Scan(tag, tick, spec, leaves, length), _NONE))
    return g(leaves)
