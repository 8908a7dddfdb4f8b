"""The solver's forward kinematics (phase ``solver.fk``) as one CUDA kernel.

`fk_limi(tree, q)` computes liMi = placement_i * M_i(q) for every joint i
and problem b in one launch of `csrc/fk.cu`, straight into the
trailing-batch layout the solver keeps: ``liMi_R`` (N, 3, 3, B) and
``liMi_p`` (N, 3, B), contiguous, so the fused ADMM kernel reads them as
they are.  It computes no oMi.  Its plain version is
`model.tree.KinematicTree.fwd_kinematics`, which `solver.solve.fwd_pass_init`
runs where `on_kernel` says no.

`on_kernel(tree, q)` routes by the input alone, with no knob: a CPU tensor
takes the plain FK (every CPU test runs it unchanged); a CUDA tensor takes
the kernel, unless grad mode is on and q or a geometry leaf requires a
gradient (the kernel has no backward: `solve_unrolled` and a `utils.jit`
training step differentiate through the plain FK).  A CUDA input the
kernel does not take (a dtype other than float32 and float64, or q in
another dtype than the tree's) raises; nothing falls back.

Counters (read through `utils.observability`): `FK_LAUNCHES`, the kernel's
launches, counted by `COUNTER` as every kernel's are (`kernels.common`: a
graph's replays included); `PLAIN_CALLS`, per reason, the calls on CUDA
tensors that took the plain FK (counted on the host when the route is
chosen: a capture's recording counts, its replays do not).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import numpy as np
import torch

from ..model import tree as mtree
from . import common

# kernel launches in this process (see the module docstring)
FK_LAUNCHES = 0
COUNTER = common.Launches("fk_limi", __name__, "FK_LAUNCHES")
# reason -> calls on CUDA tensors that took the plain FK
PLAIN_CALLS: dict = {}
_LOCK = threading.Lock()

# the geometry leaves the kernel reads, in csrc/fk.cu::FkArgs' order
_GEOMETRY = ("placement_R", "placement_p", "axis", "axis2", "placement2_R", "placement2_p")


def grad_reason(tree, q) -> Optional[str]:
    """Why the FK of (``tree``, ``q``) has to keep an autograd record, or
    None: grad mode is on and q, or one of the geometry leaves, requires a
    gradient."""
    if not torch.is_grad_enabled():
        return None
    if q.requires_grad:
        return "q requires grad"
    if any(getattr(tree, f) is not None and getattr(tree, f).requires_grad
           for f in _GEOMETRY):
        return "geometry requires grad"
    return None


def on_kernel(tree, q) -> bool:
    """Whether `fwd_pass_init` runs the kernel on (``tree``, ``q``): a CUDA
    tensor that needs no gradient.  A CUDA call sent to the plain FK is
    counted in `PLAIN_CALLS` under its reason."""
    if q.device.type != "cuda":
        return False
    reason = grad_reason(tree, q)
    if reason is None:
        return True
    with _LOCK:
        PLAIN_CALLS[reason] = PLAIN_CALLS.get(reason, 0) + 1
    return False


class _FkLeaf(ctypes.Structure):
    """csrc/fk.cu::FkLeaf."""

    _fields_ = [("ptr", ctypes.c_void_p), ("sj", ctypes.c_longlong),
                ("sb", ctypes.c_longlong), ("s0", ctypes.c_longlong),
                ("s1", ctypes.c_longlong)]


class _FkArgs(ctypes.Structure):
    """csrc/fk.cu::FkArgs, field for field."""

    _fields_ = ([("B", ctypes.c_longlong), ("N", ctypes.c_longlong),
                 ("topo", ctypes.c_void_p), ("q", ctypes.c_void_p),
                 ("q_sb", ctypes.c_longlong), ("q_sk", ctypes.c_longlong)]
                + [(f, _FkLeaf) for f in _GEOMETRY]
                + [("R", ctypes.c_void_p), ("p", ctypes.c_void_p)])


# csrc/fk.cu's words a joint in the topology table
_WORDS = 7
# (topology, device) -> its table: one tensor per topology, so that a graph
# that takes another tree of its topology recomputes its tree's table
# (`model.tree.refresh_derived`) as a copy of the tensor onto itself, which
# runs nothing, instead of a copy from the host, which would wait for the card
_TABLES: dict = {}


def _topology(tree) -> torch.Tensor:
    """The kernel's (N, 7) int64 topology table on the tree's device: per
    joint its type, first q index, a mimic pair's master and mimic types,
    and the float64 bits of its helical pitch and mimic multiplier and
    offset (0.0 where it has none).  One tensor per topology and device."""
    key = (tree.jtypes, tree.idx_q, tree.pitches, tree.mimic, tree.device)
    table = _TABLES.get(key)
    if table is None:
        table = _TABLES.setdefault(key, _table(tree))
    return table


def _table(tree) -> torch.Tensor:
    rows = np.zeros((tree.njoints, _WORDS), np.int64)
    consts = np.zeros((tree.njoints, 3), np.float64)
    for i, t in enumerate(tree.jtypes):
        rows[i, 0], rows[i, 1] = t, tree.idx_q[i]
        if tree.pitches is not None:
            consts[i, 0] = float(tree.pitches[i])
        m = tree.mimic[i] if tree.mimic is not None else None
        if m is not None:
            rows[i, 2], rows[i, 3] = m[0], m[1]
            consts[i, 1:] = float(m[2]), float(m[3])
    rows[:, 4:] = consts.view(np.int64)
    return torch.as_tensor(rows, device=tree.device)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the kernel's C signatures on a library and check its layout
    against this wrapper."""
    for name in ("loik_fk_limi_f32", "loik_fk_limi_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_FkArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.loik_fk_abi.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.loik_fk_abi.restype = None
    abi = [ctypes.c_int() for _ in range(2)]
    lib.loik_fk_abi(*[ctypes.byref(x) for x in abi])
    want = (ctypes.sizeof(_FkArgs), _WORDS)
    if tuple(x.value for x in abi) != want:
        raise RuntimeError(
            f"FK kernel layout {tuple(x.value for x in abi)} (argument bytes, "
            f"topology words) does not match the wrapper's {want}")
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library (`_build.load`), its FK functions bound."""
    from . import _build

    return _bind(_build.load())


def _leaf(x: Optional[torch.Tensor], base_ndim: int, q: torch.Tensor, name: str) -> _FkLeaf:
    """A geometry leaf as pointer and strides (joint, problem, row,
    column): ``base_ndim`` is its rank without a problem axis (2 for a
    vector per joint, 3 for a matrix); a leaf with one more axis carries
    one value per problem of q."""
    if x is None:
        return _FkLeaf()
    B = q.shape[0]
    batched = x.ndim == base_ndim + 1
    if not (x.ndim == base_ndim or batched) or (batched and x.shape[1] != B):
        raise ValueError(f"FK kernel: geometry leaf {name} of shape {tuple(x.shape)} "
                         f"for a batch of {B}")
    if x.dtype != q.dtype or x.device != q.device:
        raise ValueError(f"FK kernel: geometry leaf {name} is {x.dtype} on {x.device}, "
                         f"q {q.dtype} on {q.device}")
    s = list(x.stride())
    sj, sb = s[0], (s.pop(1) if batched else 0)
    s0, s1 = s[1], (s[2] if base_ndim == 3 else 0)
    return _FkLeaf(x.data_ptr(), sj, sb, s0, s1)


def fk_limi(tree, q: torch.Tensor, lib: Optional[ctypes.CDLL] = None):
    """liMi of every joint and problem, ``(liMi_R (N, 3, 3, B), liMi_p
    (N, 3, B))`` contiguous, for q (B, nq), in one launch on the current
    stream of q's card.

    ``lib``: a host build of `csrc/fk.cu` bound with `_bind`, for a
    rehearsal on CPU tensors (tests/test_torch_fk_kernel.py); it runs in
    the call and is not counted.  Raises for an input the kernel does not
    take."""
    dtype, dev = q.dtype, q.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"FK kernel takes float32 or float64, got q in {dtype}")
    if tree.dtype != dtype or tree.device != dev:
        raise ValueError(
            f"FK kernel: q is {dtype} on {dev} and the tree {tree.dtype} on "
            f"{tree.device}; cast one to the other (KinematicTree.astype)")
    if q.ndim != 2 or q.shape[1] != tree.nq:
        raise ValueError(f"FK kernel: q of shape {tuple(q.shape)}, expected (B, {tree.nq})")
    B, N = q.shape[0], tree.njoints
    R = torch.empty((N, 3, 3, B), dtype=dtype, device=dev)
    p = torch.empty((N, 3, B), dtype=dtype, device=dev)
    rehearsal = lib is not None
    if not rehearsal:
        lib = _library()
    topo = mtree.derived(tree, ("fk_topology",), _topology)
    leaves = [_leaf(getattr(tree, f), 3 if f.endswith("_R") else 2, q, f)
              for f in _GEOMETRY]
    args = _FkArgs(B, N, topo.data_ptr(), q.data_ptr(), q.stride(0), q.stride(1),
                   *leaves, R.data_ptr(), p.data_ptr())
    fn = lib.loik_fk_limi_f32 if dtype == torch.float32 else lib.loik_fk_limi_f64
    capturing = False
    if rehearsal:
        err = fn(ctypes.byref(args), None)
    else:
        with torch.cuda.device(dev):
            capturing = torch.cuda.is_current_stream_capturing()
            err = fn(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"FK kernel launch failed: {common.cuda_error(err)}")
    if common.CHECK_NANS and not rehearsal:
        # `utils.debug_nans`: no dispatch mode sees the kernel's writes
        for name, x in (("liMi_R", R), ("liMi_p", p)):
            if bool(x.isnan().any()):
                raise FloatingPointError(f"debug_nans: NaN in the FK kernel's output {name}")
    if not rehearsal:
        COUNTER.launched(capturing)
    return R, p
