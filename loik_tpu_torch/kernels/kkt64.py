"""The refined solve's float64 KKT step (phase ``solver.kkt64``) as one CUDA
kernel.

`kkt64_step(tree, problem, prob32, st)` computes, from the float32 stage-1
state ``st`` of `solver.refine.solve_delta_duals`, the float64 KKT
residual at the stage-1 point (`solver.solve.kkt_residual`), the delta
problem, the original problem's tolerance scales and the delta state of
every problem in one launch of `csrc/kkt64.cu`, written as float32 straight
into the trailing-batch layout the fused ADMM kernel and the eager loop
read.  It makes no float64 copy of the state, the tree or the problem: the
kernel widens what it reads.  Its plain version is
`solver.refine._kkt64_plain`, equal to it in every bit, which
`refine._delta_duals` runs where `on_kernel` says no.

`on_kernel(tree, problem, st)` routes by the input alone, with no knob: a
CPU tensor takes the plain step (every CPU test runs it unchanged); a CUDA
tensor takes the kernel, whatever it is: problem leaves in float32 or
float64 (another floating dtype, or a mix, is widened to float64 first,
exactly), shared or one per problem, any number of constraints, two on one
link, batched geometry.  Where grad mode is on and the state, a problem
leaf or the tree's axes require a gradient, the launch is the forward of an
autograd function whose backward runs the plain step again on the same
inputs and returns its vector-Jacobian product (`_Step`): the gradient is
the plain step's, and the forward is still one launch.

Counter (read through `utils.observability.kernel_counts`):
`KKT64_LAUNCHES`, the kernel's launches, counted by `COUNTER` as every
kernel's are (`kernels.common`: a graph's replays included).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from ..model import tree as mtree
from . import common

# kernel launches in this process (see the module docstring)
KKT64_LAUNCHES = 0
COUNTER = common.Launches("kkt64", __name__, "KKT64_LAUNCHES")

# the state leaves the kernel reads, then the problem's, in csrc/kkt64.cu::KktArgs' order
_STATE = ("liMi_R", "liMi_p", "vis", "fis", "nu", "z", "w", "Aty")
_PROBLEM = ("H_ref", "v_ref", "A", "b", "lb", "ub")
# the outputs, in csrc/kkt64.cu's order: name, leading shape ("N6": (N, 6),
# "NK": (N, K), "C6": (NC, 6), "": none), each with the problem axis last
_OUTPUTS = (
    ("Hv", "N6"), ("fdpa_hat", "N6"), ("vis", "N6"), ("fis", "N6"), ("fdpa", "N6"),
    ("lb", "NK"), ("ub", "NK"), ("r_offset", "NK"), ("z", "NK"), ("nu", "NK"),
    ("w", "NK"), ("stfw", "NK"),
    ("b", "C6"), ("Atb", "C6"), ("yis", "C6"), ("Aty", "C6"),
    ("tol_scale_primal", ""), ("tol_scale_dual", ""), ("Hv_inf", ""), ("b_inf", ""),
)
# which of them are the delta problem's fields and which the delta state's
_PROBLEM_OUT = ("Hv", "lb", "ub", "r_offset", "b", "Atb", "tol_scale_primal",
                "tol_scale_dual", "Hv_inf", "b_inf")
_STATE_OUT = ("vis", "fis", "fdpa", "z", "nu", "w", "stfw", "yis", "Aty")
# the delta state's leaves that are zero in every problem
_ZEROS = ("vis", "fis", "fdpa", "nu", "w", "stfw", "yis", "Aty")


def step_bytes(st, problem) -> tuple:
    """The least bytes one step on ``st`` and ``problem`` moves, for its
    roofline: the state leaves it reads once and the problem's leaves once,
    plus every output written once; and the same with only the outputs
    that are not zero in every problem (`_ZEROS`: the delta state's zeros,
    which the kernel writes too)."""
    N, K, B = st.nu.shape
    NC = len(problem.constraint_links)
    read = sum(getattr(st, f).numel() * getattr(st, f).element_size() for f in _STATE)
    read += sum(getattr(problem, f).numel() * getattr(problem, f).element_size()
                for f in _PROBLEM)
    words = {"N6": N * 6, "NK": N * K, "C6": NC * 6, "": 1}
    every = sum(words[s] for _, s in _OUTPUTS) * B * 4
    zeros = sum(words[s] for n, s in _OUTPUTS if n in _ZEROS) * B * 4
    return read + every, read + every - zeros


def needs_grad(tree, problem, st) -> bool:
    """Whether the step on (``tree``, ``problem``, ``st``) has to keep an
    autograd record: grad mode is on and a state leaf it reads, a problem
    leaf or the tree's axes require a gradient."""
    return torch.is_grad_enabled() and (
        any(getattr(st, f).requires_grad for f in _STATE)
        or any(getattr(problem, f).requires_grad for f in _PROBLEM)
        or tree.axis.requires_grad)


def on_kernel(tree, problem, st) -> bool:
    """Whether `refine._delta_duals` runs the kernel on (``tree``,
    ``problem``, ``st``): a CUDA state."""
    return st.vis.device.type == "cuda"


class _KktLeaf(ctypes.Structure):
    """csrc/kkt64.cu::KktLeaf."""

    _fields_ = [("ptr", ctypes.c_void_p)] + [
        (f, ctypes.c_longlong) for f in ("s0", "s1", "s2", "sb", "f64")]


class _KktArgs(ctypes.Structure):
    """csrc/kkt64.cu::KktArgs, field for field."""

    _fields_ = ([(f, ctypes.c_longlong) for f in ("B", "N", "K", "NC")]
                + [("topo", ctypes.c_void_p)]
                + [(f, _KktLeaf) for f in _STATE + _PROBLEM + ("axis",)]
                + [("out", ctypes.c_void_p * len(_OUTPUTS))])


# csrc/kkt64.cu's words a joint in the topology table
_WORDS = 7
# (topology, constraint links, device) -> its table: one tensor per key, so
# that a graph that takes another tree of its topology recomputes its tree's
# table (`model.tree.refresh_derived`) as a copy of the tensor onto itself,
# which runs nothing, instead of a copy from the host
_TABLES: dict = {}


def _topology(tree, links) -> torch.Tensor:
    """The kernel's int64 topology table on the tree's device: per joint
    (`_WORDS` words) its type, dofs, first dof, where its children start in
    the child list and how many it has, the last constraint on its link
    (-1: none) and the float64 bits of its helical pitch (0.0 where it has
    none); then the child list, each joint's children in descending index
    order (the order `solve.kkt_residual` adds them), N words; then the
    constraints' links.  One tensor per key."""
    key = (tree.jtypes, tree.parents, tree.nvs, tree.pitches, links, tree.device)
    table = _TABLES.get(key)
    if table is None:
        table = _TABLES.setdefault(key, _table(tree, links))
    return table


def _table(tree, links) -> torch.Tensor:
    N = tree.njoints
    kids = [[] for _ in range(N)]
    for i, p in enumerate(tree.parents):
        if p >= 0:
            kids[p].append(i)
    last = {c: k for k, c in enumerate(links)}  # a later constraint overwrites
    rows = np.zeros((N, _WORDS), np.int64)
    children = []
    for i in range(N):
        pitch = float(tree.pitches[i]) if tree.pitches is not None else 0.0
        rows[i, :6] = (tree.jtypes[i], tree.nvs[i], tree.idx_v[i], len(children),
                       len(kids[i]), last.get(i, -1))
        rows[i, 6] = np.float64(pitch).view(np.int64)
        children += sorted(kids[i], reverse=True)
    children += [0] * (N - len(children))  # the roots': N words in all
    table = np.concatenate([rows.ravel(), np.asarray(children, np.int64),
                            np.asarray(links, np.int64)])
    return torch.as_tensor(table, device=tree.device)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the kernel's C signature on a library and check its layout
    against this wrapper."""
    lib.loik_kkt64.argtypes = [ctypes.POINTER(_KktArgs), ctypes.c_void_p]
    lib.loik_kkt64.restype = ctypes.c_int
    lib.loik_kkt64_abi.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.loik_kkt64_abi.restype = None
    abi = [ctypes.c_int() for _ in range(3)]
    lib.loik_kkt64_abi(*[ctypes.byref(x) for x in abi])
    want = (ctypes.sizeof(_KktArgs), _WORDS, len(_OUTPUTS))
    if tuple(x.value for x in abi) != want:
        raise RuntimeError(
            f"KKT64 kernel layout {tuple(x.value for x in abi)} (argument bytes, "
            f"topology words, outputs) does not match the wrapper's {want}")
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library (`_build.load`), its KKT64 function bound."""
    from . import _build

    return _bind(_build.load())


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel reads it: float32 and float64 as they are,
    another floating dtype widened to float64 (exact)."""
    return x if x.dtype in (torch.float32, torch.float64) else x.to(torch.float64)


def _leaf(x: torch.Tensor, core_ndim: int, B: int, dev, name: str) -> _KktLeaf:
    """An input as pointer and strides (index, row, column, problem):
    ``core_ndim`` is its rank without a problem axis; a leaf with one more
    axis carries one value per problem (or one for all, if that axis is 1):
    leading for the problem's leaves, the second axis for the tree's axes
    ((N, B, 3)), the last for the state's."""
    if x.device != dev:
        raise ValueError(f"KKT64 kernel: {name} is on {x.device}, the state on {dev}")
    shape, strides = list(x.shape), list(x.stride())
    sb = 0
    if x.ndim == core_ndim + 1:
        at = -1 if name in _STATE else (1 if name == "axis" else 0)
        n, s = shape.pop(at), strides.pop(at)
        if n not in (1, B):
            raise ValueError(f"KKT64 kernel: {name} of shape {tuple(x.shape)} for a batch of {B}")
        sb = s if n == B else 0
    elif x.ndim != core_ndim:
        raise ValueError(f"KKT64 kernel: {name} of shape {tuple(x.shape)}")
    strides += [0] * (3 - len(strides))
    # the kernel takes the offsets within one index and problem (rows and
    # columns 0-5; lb and ub: their index) in 32 bits
    if 5 * sum(strides if name in ("lb", "ub") else strides[1:]) >= 2 ** 31:
        if x.is_contiguous():
            raise ValueError(f"KKT64 kernel: {name} of shape {tuple(x.shape)} is beyond the "
                             "kernel's 32-bit offsets")
        return _leaf(x.contiguous(), core_ndim, B, dev, name)
    return _KktLeaf(x.data_ptr(), *strides, sb, int(x.dtype == torch.float64))


def kkt64_step(tree, problem, prob32, st, lib: Optional[ctypes.CDLL] = None):
    """The delta problem, the delta state and fdpa_hat of every problem,
    ``(prob_d, st_d, fdpa_hat (N, 6, B))``, from the float32 stage-1 state
    ``st`` of ``problem`` (its leaves as the caller gave them) on ``tree``
    (its own dtype), in one launch on the current stream of the state's
    card.  ``prob32``: stage 1's prepared float32 problem, whose H_ref, A,
    AtA, links and S_all the delta problem keeps.  As
    `solver.refine._kkt64_plain`, bit for bit, gradient included
    (`needs_grad`: the launch is then `_Step`'s forward).

    ``lib``: a host build of `csrc/kkt64.cu` bound with `_bind`, for a
    rehearsal on CPU tensors (tests/test_torch_kkt64_kernel.py); it runs in
    the call and is not counted.  Raises for an input the kernel does not
    take."""
    if tree.has_q_dependent_S:
        raise ValueError("KKT64 kernel: the tree has configuration-dependent motion subspaces")
    for f in _STATE:
        if getattr(st, f).dtype != torch.float32:
            raise ValueError(f"KKT64 kernel: the stage-1 state is float32; {f} is "
                             f"{getattr(st, f).dtype}")
    N, K, B = st.nu.shape
    if 5 * B >= 2 ** 31:  # the outputs' offsets within one index, as the inputs'
        raise ValueError(f"KKT64 kernel: a batch of {B} is beyond the kernel's 32-bit offsets")
    if needs_grad(tree, problem, st):
        leaves = [getattr(st, f) for f in _STATE] + [getattr(problem, f) for f in _PROBLEM]
        buf = _Step.apply((tree, problem, prob32, st, lib), *leaves, tree.axis)
    else:
        buf = _launch(tree, problem, st, lib)
    out = _unpack(buf, N, K, len(problem.constraint_links), B)
    prob_d = dataclasses.replace(prob32, **{n: out[n] for n in _PROBLEM_OUT})
    st_d = dataclasses.replace(st, **{n: out[n] for n in _STATE_OUT})
    return prob_d, st_d, out["fdpa_hat"]


def _unpack(buf: torch.Tensor, N: int, K: int, NC: int, B: int) -> dict:
    """The outputs (`_OUTPUTS`), each a view of the flat ``buf``, problem
    axis last."""
    lead = {"N6": (N, 6), "NK": (N, K), "C6": (NC, 6), "": ()}
    shapes = [lead[s] + (B,) for _, s in _OUTPUTS]
    parts = buf.split([math.prod(shape) for shape in shapes])
    return {name: x.view(shape) for (name, _), x, shape in zip(_OUTPUTS, parts, shapes)}


def _launch(tree, problem, st, lib) -> torch.Tensor:
    """One launch of the kernel on (``tree``, ``problem``, ``st``): every
    output, flat in `_OUTPUTS`' order (`_unpack`)."""
    dev = st.vis.device
    N, K, B = st.nu.shape
    links = tuple(problem.constraint_links)
    NC = len(links)
    words = [{"N6": N * 6, "NK": N * K, "C6": NC * 6, "": 1}[s] * B for _, s in _OUTPUTS]
    buf = torch.empty((sum(words),), dtype=torch.float32, device=dev)
    rehearsal = lib is not None
    if not rehearsal:
        lib = _library()
    topo = mtree.derived(tree, ("kkt64_topology", links), lambda t: _topology(t, links))
    leaves = [_leaf(getattr(st, f), getattr(st, f).ndim - 1, B, dev, f) for f in _STATE]
    pleaves = [_wide(getattr(problem, f)) for f in _PROBLEM]
    if len({x.dtype for x in pleaves}) > 1:  # the kernel reads one dtype: widen, exactly
        pleaves = [x.to(torch.float64) for x in pleaves]
    leaves += [_leaf(x, n, B, dev, f) for x, f, n in zip(pleaves, _PROBLEM, (3, 2, 3, 2, 1, 1))]
    leaves.append(_leaf(_wide(tree.axis), 2, B, dev, "axis"))
    at = [buf.data_ptr() + 4 * sum(words[:o]) for o in range(len(words))]
    ptrs = (ctypes.c_void_p * len(_OUTPUTS))(*at)
    args = _KktArgs(B, N, K, NC, topo.data_ptr(), *leaves, ptrs)
    capturing = False
    if rehearsal:
        err = lib.loik_kkt64(ctypes.byref(args), None)
    else:
        with torch.cuda.device(dev):
            capturing = torch.cuda.is_current_stream_capturing()
            err = lib.loik_kkt64(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"KKT64 kernel launch failed: {common.cuda_error(err)}")
    if common.CHECK_NANS and not rehearsal and bool(buf.isnan().any()):
        # `utils.debug_nans`: no dispatch mode sees the kernel's writes
        out = _unpack(buf, N, K, NC, B)
        bad = next(name for name, _ in _OUTPUTS if bool(out[name].isnan().any()))
        raise FloatingPointError(f"debug_nans: NaN in the KKT64 kernel's output {bad}")
    if not rehearsal:
        COUNTER.launched(capturing)
    return buf


class _Step(torch.autograd.Function):
    """The kernel's launch with the plain step's gradient.  The forward is
    `_launch`; the backward runs `solver.refine._kkt64_plain` again on the
    same inputs under autograd and returns its vector-Jacobian product for
    the flat output's gradient, with a graph of its own where the caller
    asks for one (``create_graph``), so higher derivatives are the plain
    step's too.  Inputs: the call's (tree, problem, prob32, state, lib), then
    the leaves the kernel reads (`_STATE`, `_PROBLEM`, the tree's axes)."""

    @staticmethod
    def forward(ctx, call, *leaves):
        ctx.call = call
        ctx.save_for_backward(*leaves)
        tree, problem, _, st, lib = call
        return _launch(tree, problem, st, lib)

    @staticmethod
    def backward(ctx, grad):
        from ..solver import refine

        tree, problem, prob32, st, _ = ctx.call
        need = ctx.needs_input_grad[1:]
        create = torch.is_grad_enabled()
        with torch.enable_grad(), refine.full_f32_matmul():
            xs = [x if create else x.detach().requires_grad_(n)
                  for x, n in zip(ctx.saved_tensors, need)]
            ns = len(_STATE)
            st_x = dataclasses.replace(st, **dict(zip(_STATE, xs[:ns])))
            problem_x = dataclasses.replace(problem, **dict(zip(_PROBLEM, xs[ns:-1])))
            tree_x = dataclasses.replace(tree, axis=xs[-1])
            prob_d, st_d, fdpa_hat = refine._kkt64_plain(tree_x, problem_x, prob32, st_x)
            N, K, B = st.nu.shape
            gout = _unpack(grad.contiguous(), N, K, len(problem.constraint_links), B)
            value = {"fdpa_hat": fdpa_hat, **{n: getattr(prob_d, n) for n in _PROBLEM_OUT},
                     **{n: getattr(st_d, n) for n in _STATE_OUT}}
            pairs = [(value[n], gout[n]) for n, _ in _OUTPUTS if value[n].requires_grad]
            wrt = [x for x, n in zip(xs, need) if n]
            got = iter(torch.autograd.grad([v for v, _ in pairs], wrt, [g for _, g in pairs],
                                           allow_unused=True, create_graph=create)
                       if pairs else [None] * len(wrt))
        return (None, *[next(got) if n else None for n in need])
