"""What the hand-written kernels share: their launch counts, the NaN
check's switch and CUDA's error messages.

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
import sys
import threading

# set by `utils.debug_nans`: a kernel writes through pointers that no
# dispatch mode sees, so each wrapper checks what its launches wrote (it
# reads the device, so the entry points run uncaptured meanwhile)
CHECK_NANS = False
# kernel name -> its `Launches`, in the order the wrappers were imported
KERNELS: dict = {}


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
    if lib is None:
        from . import _build

        lib = _build.load()
    fn = lib.loik_cuda_error_string
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return f"{fn(err).decode()} (cuda error {err})"
