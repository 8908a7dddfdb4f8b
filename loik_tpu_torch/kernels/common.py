"""The launch shell of the hand-written kernels: a wrapper binds the
kernel library (`bind`, `library`), launches (`launch`), checks what a
launch wrote for NaNs (`check_nans`) and keeps its topology tables
(`table`) here; and their launch counts and CUDA's error messages.

Each kernel's wrapper owns a `Launches`, registered in `KERNELS` under its
kernel's name (`kernels.fused`: ``fused_admm``, `kernels.fk`: ``fk_limi``,
`kernels.kkt64`: ``kkt64``).  The count itself is an int of the wrapper's
module (``fused.LAUNCHES``, ``fk.FK_LAUNCHES``, ``kkt64.KKT64_LAUNCHES``)
that a run reads and may reset to show that its path went through the
kernel.  A launch outside a capture adds one to it.  A
launch recorded into a CUDA graph being captured runs nothing then and
counts per thread (`Launches.recorded`); `utils.graphs` takes what a
capture recorded of every registered kernel (`recorded_since`) and adds it
to the counts on every replay (`replayed`), naming none.
"""

from __future__ import annotations

import ctypes
import functools
import sys
import threading
from typing import Callable

import torch

from . import _build

# set by `utils.debug_nans`: a kernel writes through pointers that no
# dispatch mode sees, so each wrapper checks what its launches wrote (it
# reads the device, so the entry points run uncaptured meanwhile)
CHECK_NANS = False
# kernel name -> its `Launches`, in the order the wrappers were imported
KERNELS: dict = {}
# (kernel name, key) -> the kernel's device table (`table`)
_TABLES: dict = {}


class Launches:
    """One kernel's launches in this process, kept in the int ``attr`` of
    the module named ``module`` (a sharded solve launches from one host
    thread per card, hence the lock)."""

    def __init__(self, name: str, module: str, attr: str):
        self.name, self._module, self._attr = name, module, attr
        self._lock = threading.Lock()
        self._recorded = threading.local()
        KERNELS[name] = self

    def count(self) -> int:
        """The launches counted so far."""
        return getattr(sys.modules[self._module], self._attr)

    def add(self, n: int) -> None:
        """Add ``n`` launches to the count."""
        mod = sys.modules[self._module]
        with self._lock:
            setattr(mod, self._attr, getattr(mod, self._attr) + n)

    def recorded(self) -> int:
        """Launches this thread has recorded into CUDA graphs so far."""
        return getattr(self._recorded, "n", 0)

    def launched(self, capturing: bool) -> None:
        """Count one launch: recorded into the capture under way on this
        thread, or run now."""
        if capturing:
            self._recorded.n = self.recorded() + 1
        else:
            self.add(1)


def recorded() -> dict:
    """Per kernel, the launches this thread has recorded so far."""
    return {name: c.recorded() for name, c in KERNELS.items()}


def recorded_since(before: dict) -> dict:
    """Per kernel, the launches this thread has recorded since `recorded`
    returned ``before``."""
    return {name: c.recorded() - before.get(name, 0) for name, c in KERNELS.items()}


def replayed(launches: dict, replays: int) -> None:
    """Add ``replays`` replays of a graph that recorded ``launches``
    (`recorded_since`'s answer) to each kernel's count."""
    for name, n in launches.items():
        if n:
            KERNELS[name].add(n * replays)


def cuda_error(err: int, lib=None) -> str:
    """A cudaError_t that a C function of the kernel library returned, as
    CUDA's message and the code; ``lib``: the library (default: the built
    one, `_build.load`)."""
    fn = (_build.load() if lib is None else lib).loik_cuda_error_string
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return f"{fn(err).decode()} (cuda error {err})"


def declare(lib: ctypes.CDLL, functions: dict) -> ctypes.CDLL:
    """Declare on ``lib`` each of ``functions`` (C function name -> its
    argtypes), every one returning an int: 0 or a cudaError_t."""
    for name, argtypes in functions.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def bind(lib: ctypes.CDLL, kernel: str, functions: dict, abi: str, layout: dict) -> ctypes.CDLL:
    """`declare` ``functions`` on ``lib`` and check its compile-time layout:
    the C function ``abi`` reports one int per entry of ``layout`` (field
    name -> the wrapper's value); another report raises RuntimeError."""
    declare(lib, functions)
    report = getattr(lib, abi)
    report.argtypes, report.restype = [ctypes.POINTER(ctypes.c_int)] * len(layout), None
    got = [ctypes.c_int() for _ in layout]
    report(*[ctypes.byref(x) for x in got])
    got, want = tuple(x.value for x in got), tuple(layout.values())
    if got != want:
        raise RuntimeError(f"{kernel} layout {got} ({', '.join(layout)}) does not match "
                           f"the wrapper's {want}")
    return lib


@functools.lru_cache(maxsize=None)
def library(binder: Callable) -> ctypes.CDLL:
    """The built kernel library (`_build.load`) bound by ``binder`` (a
    wrapper's `bind` call), once per binder."""
    return binder(_build.load())


def launch(fn, args: tuple, device, counter: Launches, kernel: str, rehearsal) -> None:
    """``fn(*args, stream)``: with ``rehearsal`` (a host build of the
    source, CPU tensors) a null stream, not counted; else the current
    stream of ``device``, made the current card (the C side launches on
    it), whose capture, if one is under way, records the launch
    (`Launches.launched`).  A non-zero return raises RuntimeError."""
    if rehearsal is not None:
        err = fn(*args, None)
    else:
        with torch.cuda.device(device):
            capturing = torch.cuda.is_current_stream_capturing()
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{kernel} launch failed: {cuda_error(err, rehearsal)}")
    if rehearsal is None:
        counter.launched(capturing)


def check_nans(kernel: str, outputs) -> None:
    """`utils.debug_nans`' check of what a launch wrote (no dispatch mode
    sees a kernel's writes): ``outputs``, (name, tensor) pairs; raises
    FloatingPointError naming the first floating one that holds a NaN."""
    for name, x in outputs:
        if x.is_floating_point() and bool(x.isnan().any()):
            raise FloatingPointError(f"debug_nans: NaN in the {kernel}'s output {name}")


def table(kernel: str, key, build: Callable) -> torch.Tensor:
    """``kernel``'s device table for ``key`` (what it is built from, the
    device included): ``build()`` once, then the same tensor, so that a
    graph taking another tree of the topology refreshes it
    (`model.tree.refresh_derived`) as a copy onto itself, not from the host."""
    t = _TABLES.get((kernel, key))
    if t is None:
        t = _TABLES.setdefault((kernel, key), build())
    return t
