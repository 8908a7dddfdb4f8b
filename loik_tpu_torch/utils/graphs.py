"""Captured CUDA graphs: the port's counterpart of `jax.jit`.

`loik_tpu` compiles each entry point into one device program
(`refine._delta_duals_jit`, `kernels.fused._run_fused`, `api._tracking_jit`,
`stream._stream_jit`, `clik._clik_jit`).  Eager PyTorch instead launches
every operator from the host: the flagship delta-duals solve is about 800
small launches around its two kernel launches, and the host's enqueue,
not the card, sets its time.  So on CUDA tensors those entry points run
their body through this module, which captures it ONCE per key as a CUDA
graph and replays the graph on later calls:

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
`jax.clear_caches()`) drops every graph.

A replay launches the fused kernel as often as the capture recorded it
(`Capture.launches`); each replay adds that many to
`kernels.fused.LAUNCHES`, so the count still shows that a path went
through the kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
# side stream per device for warm-ups and captures
_SIDE: dict = {}
# set on a thread inside `inline()`
_INSIDE = threading.local()


@dataclasses.dataclass(frozen=True)
class Capture:
    """One capture: the entry point, its wall time (warm-up and capture),
    the device memory the graph's private pool reserved, the bytes of its
    static input buffers, and the fused-kernel launches one replay makes."""

    tag: str
    seconds: float
    pool_bytes: int
    static_bytes: int
    launches: int


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


def cached_graphs() -> int:
    """Graphs currently held, over every live tree."""
    with _LOCK:
        return sum(len(graphs) for _, graphs in _CACHE.values())


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


def _capture_cuda(device, fn):
    """Capture a call of ``fn`` as a CUDA graph on the side stream (the
    call runs nothing).  Returns (replay, the captured call's outputs, the
    fused kernel launches it recorded, the bytes its private pool
    reserved)."""
    from ..kernels import fused

    side = _side_stream(device)
    cur = torch.cuda.current_stream(device)
    # torch.cuda.graph empties the allocator's cache on entry; empty it here
    # first, so that the reserved bytes before and after are the pool's
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    n0 = fused.captured_launches()
    first = None
    try:
        with torch.cuda.device(device), torch.cuda.graph(
                graph, stream=side, capture_error_mode="thread_local"):
            try:
                out = fn()
            except Exception as e:
                first = e
                raise
    except Exception as e:
        # ending a broken capture raises too, before torch.cuda.graph
        # restores the stream: restore it, and raise the body's own error
        torch.cuda.set_stream(cur)
        raise (first or e)
    launches = fused.captured_launches() - n0
    return graph.replay, out, launches, torch.cuda.memory_reserved(device) - reserved


# the capture backend (the CPU tests put a stand-in here)
_capture = _capture_cuda


def _captured(tag, device, fn, static_bytes):
    """A call of ``fn`` run for real (the warm-up: it builds the kernel
    library, fills the per-tree caches, sets the kernel's shared-memory
    limit, and its launches count; it raises what the eager call raises),
    then ``fn`` captured, with this thread marked as inside a body, a failed
    capture raised under the entry point's name and the capture logged.
    Returns (the warm-up's outputs, replay, the captured call's outputs,
    launches a replay makes)."""
    t0 = time.perf_counter()
    with inline():
        warm = _warm_up(device, fn)
        try:
            replay, out, launches, pool = _capture(device, fn)
        except Exception as e:
            raise RuntimeError(
                f"{tag}: capturing the CUDA graph failed ({type(e).__name__}: {e}); "
                "run it eagerly with loik_tpu_torch.utils.disable_graphs() to debug"
            ) from e
    CAPTURES.append(Capture(tag, time.perf_counter() - t0, pool, static_bytes, launches))
    return warm, replay, out, launches


# `_graph`'s marker of a call that a capture answered itself
_NONE = object()


def _graph(tag, tree, key, build: Callable):
    """``(graph, result)``: the graph of ``key`` for ``tree`` and `_NONE`;
    on a miss, ``build()``'s new graph and the result of the call that
    built it."""
    with _LOCK:
        tid = id(tree)
        slot = _CACHE.get(tid)
        if slot is None or slot[0]() is not tree:
            slot = (weakref.ref(tree, lambda _, tid=tid, cache=_CACHE: cache.pop(tid, None)),
                    {})
            _CACHE[tid] = slot
        g = slot[1].get(key)
        if g is not None:
            return g, _NONE
        g, result = build()
        slot[1][key] = g
        return g, result


def _bytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


class _Call:
    """A captured call of ``body`` on static copies of its inputs.  The call
    that captures it is answered by the warm-up (`first`)."""

    def __init__(self, tag, body, spec, leaves):
        self.lock = threading.Lock()
        self.static = _static(leaves)
        args = _unflatten(spec, iter(self.static))
        warm, self.replay, out, self.launches = _captured(
            tag, leaves[0].device, lambda: body(*args), _bytes(self.static))
        self.out = []
        self.out_spec = _flatten(out, self.out)
        warm_leaves: list = []
        _flatten(warm, warm_leaves)
        self.first = _unflatten(self.out_spec, iter(_fresh(warm_leaves)))

    def __call__(self, leaves):
        from ..kernels import fused

        with self.lock:
            _copy_in(self.static, leaves)
            self.replay()
            fused.count_launches(self.launches)
            return _unflatten(self.out_spec, iter(_fresh(self.out)))


def run(tag: str, tree, statics: tuple, body: Callable, args: tuple,
        capture: bool = True):
    """``body(*args)``: as a replayed CUDA graph when ``capture`` and the
    tensors of ``args`` lie on the card (and graphs are on), else eagerly.

    ``statics`` holds every value the body bakes in besides ``tree`` and
    the structure of ``args``; ``capture=False`` is for bodies that cannot
    be captured (the eager loop reads the device every body call)."""
    leaves: list = []
    spec = _flatten(args, leaves)
    if not (capture and _graphable(leaves)):
        return body(*args)
    def build():
        g = _Call(tag, body, spec, leaves)
        return g, g.first

    g, result = _graph(tag, tree, (tag, statics, spec), build)
    return g(leaves) if result is _NONE else result


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

        _, self.replay, _, self.launches = _captured(tag, dev, step, _bytes(self.static))

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
