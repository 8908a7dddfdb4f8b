"""The launch shell the hand-written kernels share (`kernels.common`): each
wrapper's binder refuses a library whose compile-time layout differs from
the wrapper's, naming the kernel, and a failed launch raises without being
counted.  Stand-in libraries only: no compiler, no card, no loik_tpu."""

import ctypes

import pytest

from loik_tpu_torch.kernels import common, fk, fused, kkt64


class StandIn:
    """A kernel library that reports ``layout`` from any ``*_abi`` function
    and holds a plain object for every other C function."""

    def __init__(self, layout):
        self.layout = layout

    def __getattr__(self, name):
        if not name.startswith("loik_"):
            raise AttributeError(name)
        if name.endswith("_abi"):
            def report(*ptrs):
                for p, v in zip(ptrs, self.layout):
                    p[0] = v
            proto = ctypes.CFUNCTYPE(None, *[ctypes.POINTER(ctypes.c_int)] * len(self.layout))
            fn = proto(report)
        else:
            fn = type(name, (), {})()
        setattr(self, name, fn)    # kept: a ctypes callback must outlive its calls
        return fn


@pytest.mark.parametrize("wrapper, kernel", [(fused, "fused ADMM kernel"),
                                             (fk, "FK kernel"), (kkt64, "KKT64 kernel")])
def test_binder_refuses_a_library_of_another_layout(wrapper, kernel):
    want = list(wrapper._LAYOUT.values())
    lib = StandIn(want)
    assert wrapper._bind(lib) is lib
    assert all(getattr(lib, f).restype is ctypes.c_int for f in wrapper._FUNCTIONS)
    for i, field in enumerate(wrapper._LAYOUT):
        other = list(want)
        other[i] += 1
        with pytest.raises(RuntimeError, match=f"^{kernel} layout .*{field}.* does not match"):
            wrapper._bind(StandIn(other))


def test_a_failed_rehearsal_launch_raises_uncounted():
    class Lib:
        @staticmethod
        def loik_cuda_error_string(err):
            return b"stand-in error"

    calls = []

    def fn(*args):
        calls.append(args)
        return 7

    n0 = fk.FK_LAUNCHES
    with pytest.raises(RuntimeError, match=r"^FK kernel launch failed: stand-in error \(cuda error 7\)"):
        common.launch(fn, ("args",), None, fk.COUNTER, "FK kernel", Lib())
    assert calls == [("args", None)] and fk.FK_LAUNCHES == n0
