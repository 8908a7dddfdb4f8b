"""The fused ADMM solve loop: one CUDA kernel runs the whole masked loop.

Port of `loik_tpu.kernels.fused`.  The TPU version ran `make_loop_body`
inside one Pallas kernel over tiles of the batch; here
`csrc/fused_admm.cu` runs the same loop body per problem, a group of LANES
lanes per problem, with each problem leaving the loop at its own iteration.

`fused_solve_loop` launches the kernel for CUDA tensors.  For CPU tensors
it runs the plain PyTorch loop (`solver.solve._solve_loop`), the twin the
kernel is checked against — the port's analog of Pallas `interpret=True`.
A build or launch failure raises; it is never turned into the eager loop.

Preconditions of the kernel (`fused_eligibility` names the first one a call
breaks): no logging, no verbose, float32 on the public path (the kernel
also has a float64 instantiation, reachable through `fused_solve_loop`),
motion subspaces that do not depend on q (no universal, spherical-ZYX or
mimic-pair joint), at most MAX_JOINTS joints with at most MAX_NV dofs in all
(joints of 1 to 6 dofs: D = S'HS + mu I is a k x k block inverted in the
kernel), at most MAX_CONSTRAINTS constraints, a `batch_tile` of 1..1024
problems per block, and a tree whose one problem fits a block's shared
memory.

The kernel takes the motion subspaces in one of two forms.  A tree with
plain geometry leaves has one S per joint, shared by all problems: a small
(N, 6, nv_max) device tensor built once per tree and kept
(`_subspace_operand`).  A tree with batched geometry leaves (the mixed
super-batch's padded chain, `parallel/mixed.py`) has one S per joint and
problem: `with_S_all` precomputes them as `PreparedProblem.S_all`
(N, 6, K, B), batch trailing like every other per-problem operand, and the
kernel reads them as data.  `S_all` is taken by the instantiation for
chains of at most SMALL_JOINTS one-dof joints only (what a mixed chain is);
which form a launch uses is a template parameter of that instantiation.

What bounds it: latency, far above either roof (its floor is the bytes it
must move, a few KB per problem; chip_smoke.py computes it per run).  A
problem is a long data-dependent chain of tiny 6x6 products through a tree,
and a launch lasts as long as its slowest problem, so the kernel shortens
the chain of one problem: LANES lanes share it (lane r owns row r of every
6-vector and 6x6), and the problem's working set — H, U, the joint
transforms, the whole iterate — lives in a frame in shared memory sized by
the tree (`frame_words`: about 4 KB for panda_arm and 17 KB for talos in
float32), read from device memory once and written back once (H_ref and
AtA, needed once per body call, stay in device memory).
`problems_per_block` mirrors the kernel's count to choose how many problems
share a block.  A launch reads nothing back from the device and packs only
ints and six doubles on the host, so a stream of launches (tracking ticks,
staged super-batches) enqueues without a host synchronisation.
"""

from __future__ import annotations

import ctypes
import dataclasses
import warnings
from typing import Optional

import torch

from ..model.tree import derived
from . import common
from ..params import SolverParams
from ..problem import IkProblem, validate_problem
from ..solver.solve import _as_batch, _solve_impl, _solve_loop
from ..solver.state import PreparedProblem, SolverState, SolveResult

# compile-time caps of csrc/fused_admm.cu (LOIK_MAX_JOINTS / LOIK_MAX_NV /
# LOIK_MAX_CONSTRAINTS); checked against the built library at first launch
MAX_JOINTS = 40
MAX_NV = 48
MAX_CONSTRAINTS = 8
# cap of the instantiation for chains of one-dof joints (LOIK_SMALL_JOINTS),
# the one that takes per-problem subspaces (S_all)
SMALL_JOINTS = 16
# lanes (threads) that share one problem (LOIK_LANES), the partial maxima a
# lane keeps (LOIK_NACC) and the shared memory one block may use on sm_90
# (LOIK_MAX_SMEM_BYTES)
LANES = 8
_NACC = 16
MAX_SMEM_BYTES = 232448

# number of kernel launches in this process: a run can read it to show that
# its main path went through the kernel; counted by `COUNTER` (`kernels.common`
# says how a captured launch and a graph's replays count)
LAUNCHES = 0
COUNTER = common.Launches("fused_admm", __name__, "LAUNCHES")

# state fields that the kernel writes (everything except liMi and the logs),
# in the order of the kernel's pointer array (csrc/fused_admm.cu::LoikPtr)
_STATE_FIELDS = (
    "vis", "fis", "nu", "z", "w", "yis", "Aty", "fdpa", "stfw",
    "mu", "mu_eq", "mu_ineq", "iterations", "tail_iterations",
    "converged", "primal_infeasible", "dual_infeasible", "in_tail",
    "running", "primal_residual", "dual_residual", "delta_x_inf",
    "delta_z_inf", "it",
)
_PROB_FIELDS = ("H_ref", "Hv", "A", "b", "AtA", "Atb", "lb", "ub", "b_inf", "Hv_inf")
_OPTIONAL_FIELDS = ("r_offset", "tol_scale_primal", "tol_scale_dual")
_FIELD_DTYPES = {
    "iterations": torch.int32, "tail_iterations": torch.int32,
    "converged": torch.bool, "primal_infeasible": torch.bool,
    "dual_infeasible": torch.bool, "in_tail": torch.bool, "running": torch.bool,
    "it": torch.int32,
}
# state fields, problem fields, optional fields, liMi_R, liMi_p, S (shared)
# or S_all (per problem; the other is null), input `it`
_N_PTRS = len(_STATE_FIELDS) + len(_PROB_FIELDS) + len(_OPTIONAL_FIELDS) + 5


class _LoikConfig(ctypes.Structure):
    """csrc/fused_admm.cu::LoikConfig, field for field."""

    _fields_ = [
        ("B", ctypes.c_int), ("N", ctypes.c_int), ("NC", ctypes.c_int),
        ("nv_max", ctypes.c_int), ("tile", ctypes.c_int),
        ("max_iter", ctypes.c_int), ("check_interval", ctypes.c_int),
        ("check_feasibility", ctypes.c_int), ("tail_solve", ctypes.c_int),
        ("parents", ctypes.c_int * MAX_JOINTS),
        ("nvs", ctypes.c_int * MAX_JOINTS),
        ("clinks", ctypes.c_int * MAX_CONSTRAINTS),
        ("rho", ctypes.c_double), ("tol_abs", ctypes.c_double),
        ("tol_rel", ctypes.c_double), ("tol_primal_inf", ctypes.c_double),
        ("tol_tail_solve", ctypes.c_double), ("mu_eq_scale", ctypes.c_double),
    ]


_LAUNCH_ARGTYPES = [ctypes.POINTER(_LoikConfig), ctypes.POINTER(ctypes.c_void_p),
                    ctypes.c_int, ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    """The built kernel library, bound and checked (`_bind`)."""
    from . import _build

    return _bind(_build.load())


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a kernel library and check its
    compile-time layout against this wrapper."""
    for name in ("loik_fused_admm_f32", "loik_fused_admm_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _LAUNCH_ARGTYPES
        fn.restype = ctypes.c_int
    lib.loik_fused_admm_abi.argtypes = [ctypes.POINTER(ctypes.c_int)] * 8
    lib.loik_fused_admm_abi.restype = None
    lib.loik_fused_admm_frame.argtypes = [
        ctypes.POINTER(_LoikConfig), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.loik_fused_admm_frame.restype = ctypes.c_int
    abi = [ctypes.c_int() for _ in range(8)]
    lib.loik_fused_admm_abi(*[ctypes.byref(x) for x in abi])
    want = (MAX_JOINTS, MAX_NV, MAX_CONSTRAINTS, SMALL_JOINTS, _N_PTRS,
            ctypes.sizeof(_LoikConfig), LANES, MAX_SMEM_BYTES)
    if tuple(x.value for x in abi) != want:
        raise RuntimeError(
            f"kernel library layout {tuple(x.value for x in abi)} (max joints, "
            f"max dofs, max constraints, one-dof chain joints, pointers, config "
            f"bytes, lanes, shared bytes) does not match the wrapper's {want}"
        )
    return lib


def frame_words(nvs, num_constraints: int, per_problem_S: bool = False):
    """(words per problem, words per block) of shared memory the kernel
    needs for a tree whose joints have ``nvs`` dofs, in words of the scalar
    type: one problem's frame, and the block's copy of the shared S (none
    with per-problem S, which sits in the frame).  Mirrors
    csrc/fused_admm.cu::loik_layout field for field; the built library
    reports the same numbers (`loik_fused_admm_frame`)."""
    N, NC, nv = len(nvs), num_constraints, sum(nvs)
    words = (
        max(N * 36, _NACC * LANES)          # H; the lanes' partial maxima
        + 2 * nv * 6 + sum(k * k for k in nvs)   # U, U D^-1, D^-1
        + 2 * N * 6 + nv                    # p, the dual-residual sums, r
        + N * (9 + 3 + 9)                   # joint transforms: R, p, [p]x R
        + 4 * N * 6                         # vis, fis, fdpa, Hv
        + 3 * NC * 6 + NC * 36 + NC * 6     # yis, Aty, Atb, A, b
        + 7 * nv                            # nu, z, w, stfw, lb, ub, r_offset
        + 36 + 36                           # Ha, D
        + 2 * nv + 2 * NC * 6               # terms of the four ordered sums
        + (N * 6 if per_problem_S else 0)   # S_all
        + 3                                 # running, mu_eq, mu_ineq
    )
    # an odd stride spreads the lanes of a warp's groups over the banks
    return words | 1, 0 if per_problem_S else N * 6 * max(nvs)


def problems_per_block(nvs, num_constraints: int, dtype, batch_tile: int,
                       per_problem_S: bool = False) -> int:
    """Problems that share one block: ``batch_tile`` at most, LANES threads
    each within 1024 threads, their frames within MAX_SMEM_BYTES; a whole
    number of warps where more than one warp's worth fits.  0 when not even
    one problem fits."""
    frame, block = frame_words(nvs, num_constraints, per_problem_S)
    size = torch.finfo(dtype).bits // 8
    fit = (MAX_SMEM_BYTES - block * size) // (frame * size)
    tile = max(0, min(batch_tile, 1024 // LANES, fit))
    per_warp = 32 // LANES
    return tile - tile % per_warp if tile > per_warp else tile


# one warning per distinct (call-site, reason): the eager loop is far slower
# than the kernel on the GPU — a cliff users must be told about, once
_fallback_warned: set = set()


def fused_eligibility(tree, params: SolverParams, B: int, batch_tile: int,
                      dtype=None, num_constraints: int = 1):
    """Why-not report for the fused kernel.

    Returns ``(eligible, reason)``: eligible=True means the kernel can run on
    this call shape; otherwise ``reason`` names the first blocker in plain
    words.  ``dtype=None`` skips the float32 check (the delta-duals path
    casts to float32 internally, so its stages fuse whatever the caller's
    q dtype).  The device is not a condition: on CPU tensors the fused path
    is the eager loop.  The batch need not divide by ``batch_tile``: the
    kernel masks the ragged last block.  ``batch_tile`` is the most problems
    a block takes; `problems_per_block` lowers it to what fits the block's
    threads and shared memory, and a tree whose ONE problem does not fit is
    refused here (sized for float32 unless ``dtype`` is float64).

    A tree with batched geometry leaves runs on per-problem subspaces
    (``PreparedProblem.S_all``), which only the kernel's instantiation for
    chains of at most SMALL_JOINTS one-dof joints takes: a taller or
    multi-dof batched tree is refused here by name (`with_S_all` refuses
    non-uniform dof counts on its own)."""
    if params.logging:
        return False, ("params.logging is set — the fused kernel has no "
                       "per-iteration log arrays (use utils.debug_mirror "
                       "to log a batch on the eager loop)")
    if params.verbose:
        return False, ("params.verbose is set — the fused kernel prints "
                       "nothing per iteration")
    if dtype is not None and dtype != torch.float32:
        return False, (f"dtype {dtype} != torch.float32 (the public fused "
                       "path is float32; use the delta-duals refinement for "
                       "tight tolerances)")
    if tree.has_q_dependent_S:
        return False, ("tree has configuration-dependent motion subspaces "
                       "(universal/spherical-ZYX/mimic joints): the kernel "
                       "takes one constant S per tree")
    if tree.has_batched_geometry and (tree.nv_max != 1
                                      or tree.njoints > SMALL_JOINTS):
        return False, ("tree has batched geometry leaves (per-problem "
                       "motion subspaces, S_all) with "
                       f"{tree.njoints} joints of up to {tree.nv_max} dofs: "
                       "the kernel takes S_all for chains of at most "
                       f"{SMALL_JOINTS} one-dof joints (LOIK_SMALL_JOINTS)")
    if tree.njoints > MAX_JOINTS:
        return False, (f"{tree.njoints} joints exceed the kernel's cap of "
                       f"{MAX_JOINTS} (LOIK_MAX_JOINTS)")
    if tree.nv > MAX_NV:
        return False, (f"{tree.nv} dofs exceed the kernel's cap of "
                       f"{MAX_NV} (LOIK_MAX_NV)")
    if num_constraints > MAX_CONSTRAINTS:
        return False, (f"{num_constraints} constraints exceed the kernel's "
                       f"cap of {MAX_CONSTRAINTS} (LOIK_MAX_CONSTRAINTS)")
    if not 1 <= batch_tile <= 1024:
        return False, (f"batch_tile {batch_tile} is not a number of problems "
                       "per block that a CUDA block size allows (1..1024)")
    size_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    if problems_per_block(tree.nvs, num_constraints, size_dtype, batch_tile,
                          tree.has_batched_geometry) < 1:
        frame, block = frame_words(tree.nvs, num_constraints,
                                   tree.has_batched_geometry)
        size = torch.finfo(size_dtype).bits // 8
        return False, (f"one problem of this tree ({tree.njoints} joints, "
                       f"{tree.nv} dofs, {num_constraints} constraints) needs "
                       f"{(frame + block) * size} bytes of shared memory in "
                       f"{size_dtype}, more than the {MAX_SMEM_BYTES} a block "
                       "has (LOIK_MAX_SMEM_BYTES)")
    return True, None


def resolve_fused(fused, tree, params: SolverParams, B: int, batch_tile: int,
                  dtype=None, where: str = "solve",
                  num_constraints: int = 1) -> bool:
    """Resolve a user ``fused=`` request (None | bool | 'require') to a bool.

    None (auto): eligible shapes fuse; an ineligible shape warns ONCE per
    (call-site, reason) naming the blocker, and runs the eager loop.
    'require': raise with the reason instead of degrading.  True/False:
    forced by the caller (the kernel wrapper still validates its hard
    preconditions)."""
    if fused == "require":
        ok, reason = fused_eligibility(tree, params, B, batch_tile, dtype,
                                       num_constraints)
        if not ok:
            raise ValueError(
                f"{where}: fused='require' but the fused kernel cannot run "
                f"here: {reason}"
            )
        return True
    if fused is None:
        ok, reason = fused_eligibility(tree, params, B, batch_tile, dtype,
                                       num_constraints)
        if not ok:
            key = (where, reason)
            if key not in _fallback_warned:
                _fallback_warned.add(key)
                warnings.warn(
                    f"{where}: running the eager PyTorch loop instead of the "
                    f"fused kernel: {reason}. Pass fused=False to silence or "
                    f"fused='require' to fail instead.",
                    stacklevel=3,
                )
        return ok
    return bool(fused)


def _subspace_operand(tree, dtype) -> torch.Tensor:
    """The kernel's shared S operand: every joint's constant motion
    subspace, zero-padded to (N, 6, nv_max), in ``dtype`` on the tree's
    device.  Built once per tree object and dtype and kept as long as the
    tree lives (`model.tree.derived`; a captured graph that takes another
    tree's leaves recomputes it in place with `refresh_derived`).
    (`KinematicTree.to` returns the tree itself when nothing changes, so a
    float32 tree on the card keeps its operand from solve to solve.)  Not
    for trees with batched geometry: their subspaces are per problem and
    travel as `PreparedProblem.S_all`."""
    if tree.has_batched_geometry:
        raise ValueError("a tree with batched geometry has no shared S operand")
    return derived(tree, ("S", dtype),
                   lambda t: t.joint_S_padded().to(dtype).contiguous())


def _launch(tree, params: SolverParams, prob: PreparedProblem,
            st: SolverState, batch_tile: int,
            lib: Optional[ctypes.CDLL] = None) -> SolverState:
    """Launch the kernel on clones of the state; returns the final state.

    ``lib``: a host build of the kernel source bound with `_bind`, for a
    rehearsal on CPU tensors (tools/rehearse_kernel.py); it runs in the call
    and is not counted as a launch.  None: the CUDA library, on the current
    stream of the tensors' device, with that device made current."""
    dtype, dev = st.vis.dtype, st.vis.device
    B = st.vis.shape[-1]
    N, NC = tree.njoints, len(prob.constraint_links)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the fused kernel takes float32 or float64, got {dtype}")
    tile = problems_per_block(tree.nvs, NC, dtype, batch_tile, prob.S_all is not None)
    if tile < 1:
        raise ValueError(
            f"fused kernel: one problem of this tree does not fit a block's "
            f"shared memory in {dtype} ({MAX_SMEM_BYTES} bytes)")
    rehearsal = lib is not None
    if not rehearsal:
        lib = _library()

    def operand(name, x, want_dtype):
        if x.device != dev or x.dtype != want_dtype:
            raise ValueError(
                f"fused kernel operand {name}: {x.dtype} on {x.device}, "
                f"expected {want_dtype} on {dev}")
        return x.contiguous()

    # the kernel updates these clones in place; a trace counts them with the
    # state's reset and the operands' copies with the problem's preparation,
    # so that the loop's phase is the launch alone (`utils.observability.phase`)
    from ..utils.observability import phase

    with phase("solver.reset"):
        out = {n: operand(n, getattr(st, n), _FIELD_DTYPES.get(n, dtype)).clone()
               for n in _STATE_FIELDS}
    with phase("solver.prepare"):
        inputs = [operand(n, getattr(prob, n), dtype) for n in _PROB_FIELDS]
        inputs += [None if getattr(prob, n) is None else operand(n, getattr(prob, n), dtype)
                   for n in _OPTIONAL_FIELDS]
        inputs += [operand("liMi_R", st.liMi_R, dtype), operand("liMi_p", st.liMi_p, dtype)]
        if prob.S_all is not None:
            if tuple(prob.S_all.shape) != (N, 6, tree.nv_max, B):
                raise ValueError(
                    f"fused kernel operand S_all: shape {tuple(prob.S_all.shape)}, "
                    f"expected {(N, 6, tree.nv_max, B)}")
            inputs += [None, operand("S_all", prob.S_all, dtype)]
        else:
            inputs += [operand("S", _subspace_operand(tree, dtype), dtype), None]
        inputs += [operand("it", st.it, torch.int32)]
    tensors = [out[n] for n in _STATE_FIELDS] + inputs
    ptrs = (ctypes.c_void_p * _N_PTRS)(
        *[None if t is None else t.data_ptr() for t in tensors])

    cfg = _LoikConfig(
        B=B, N=N, NC=NC, nv_max=tree.nv_max, tile=tile,
        max_iter=params.max_iter,
        check_interval=params.check_interval,
        check_feasibility=int(params.check_feasibility),
        tail_solve=int(params.tail_solve),
        rho=params.rho, tol_abs=params.tol_abs, tol_rel=params.tol_rel,
        tol_primal_inf=params.tol_primal_inf,
        tol_tail_solve=params.tol_tail_solve,
        mu_eq_scale=params.mu_equality_scale_factor,
    )
    cfg.parents[:N] = tree.parents
    cfg.nvs[:N] = tree.nvs
    cfg.clinks[:NC] = prob.constraint_links

    fn = lib.loik_fused_admm_f32 if dtype == torch.float32 else lib.loik_fused_admm_f64
    capturing = False
    if rehearsal:
        err = fn(ctypes.byref(cfg), ptrs, _N_PTRS, ctypes.c_void_p(0))
    else:
        # the C side sets the kernel's shared-memory limit and launches on
        # the CURRENT device: make the tensors' card current for the call.
        # Under a CUDA graph capture the current stream is the capture's,
        # and the launch, its config passed by value, becomes a graph node
        with torch.cuda.device(dev):
            capturing = torch.cuda.is_current_stream_capturing()
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(ctypes.byref(cfg), ptrs, _N_PTRS, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"fused ADMM kernel launch failed: {common.cuda_error(err, lib)}")
    if not rehearsal:
        COUNTER.launched(capturing)
    return dataclasses.replace(st, **out)


def fused_solve_loop(tree, params: SolverParams, prob: PreparedProblem,
                     st: SolverState, batch_tile: Optional[int] = None) -> SolverState:
    """Run `_solve_loop` as the fused kernel (CUDA tensors) or as the eager
    loop itself (CPU tensors).  Takes/returns the same trailing-batch state.

    batch_tile: the most problems per block (default
    `refine.default_batch_tile`); `problems_per_block` lowers it to what the
    block's threads and shared memory hold.  The kernel masks a ragged last
    block, so B need not divide by it."""
    if params.logging:
        raise ValueError("fused path does not support logging")
    if params.verbose:
        raise ValueError(
            "fused path does not support verbose console mode (the kernel "
            "cannot print per iteration); use solver.solve")
    if batch_tile is None:
        from ..solver.refine import default_batch_tile

        batch_tile = default_batch_tile(tree.njoints)
    B = st.vis.shape[-1]
    ok, reason = fused_eligibility(tree, params, B, batch_tile,
                                   num_constraints=len(prob.constraint_links))
    if not ok:
        raise ValueError(f"fused_solve_loop: {reason}")
    if tree.has_batched_geometry and prob.S_all is None:
        raise ValueError(
            "fused_solve_loop with batched geometry (axis ndim 3) needs "
            "precomputed per-problem subspaces in prob.S_all (use solve_fused "
            "/ _fused_body, which set S_all, or with_S_all)"
        )
    if prob.S_all is not None and (tree.nv_max != 1 or tree.njoints > SMALL_JOINTS):
        raise ValueError(
            "fused_solve_loop: S_all is taken for chains of at most "
            f"{SMALL_JOINTS} one-dof joints (LOIK_SMALL_JOINTS)")
    if st.vis.device.type == "cpu":
        return _solve_loop(tree, prob, params, st)
    if st.vis.device.type != "cuda":
        raise ValueError(f"fused_solve_loop: no kernel for device {st.vis.device}")
    out = _launch(tree, params, prob, st, batch_tile)
    if common.CHECK_NANS:
        _check_nans(out)
    return out


def _check_nans(st: SolverState) -> None:
    """`utils.debug_nans`' check of a launch's output state: raises
    FloatingPointError naming the first floating field holding a NaN."""
    for f in dataclasses.fields(st):
        x = getattr(st, f.name)
        if isinstance(x, torch.Tensor) and x.is_floating_point() and bool(x.isnan().any()):
            raise FloatingPointError(
                f"debug_nans: NaN in the fused kernel's output field {f.name}")


def with_S_all(tree, prob: PreparedProblem, dtype) -> PreparedProblem:
    """Attach precomputed per-problem motion subspaces for batched-geometry
    trees (axis (N, B, 3), the mixed super-batch path): inside the kernel S
    is DATA, not computation — (N, 6, K, B) built once at prepare time."""
    K = tree.nv_max
    if any(k != K for k in tree.nvs):
        raise ValueError(
            "fused path with batched geometry needs uniform joint "
            "dof counts (serial 1-dof chains)"
        )
    S_all = torch.stack(
        [tree.joint_S(i).to(dtype).movedim(0, -1) for i in range(tree.njoints)]
    ).contiguous()
    return dataclasses.replace(prob, S_all=S_all)


def fused_loop(batch_tile: Optional[int]):
    """`fused_solve_loop` in the ``loop(tree, prob, params, st)`` form that
    `_solve_impl` takes; a batched-geometry tree gets its `S_all` here."""
    def loop(tree, prob, params, st):
        if tree.has_batched_geometry and prob.S_all is None:
            prob = with_S_all(tree, prob, st.vis.dtype)
        return fused_solve_loop(tree, params, prob, st, batch_tile)

    return loop


def _fused_body(params, batch_tile, tree, q, problem, warm_state) -> SolveResult:
    """The fused solve on a validated (B, nq) q (also stage 1 of
    refine.solve_delta_duals)."""
    if tree.has_q_dependent_S:
        raise ValueError(
            "the fused kernel does not support configuration-dependent "
            "motion subspaces (universal joints); use solver.solve"
        )
    return _solve_impl(tree, params, q, problem, warm_state,
                       loop=fused_loop(batch_tile))


def solve_fused(tree, params: SolverParams, q, problem: IkProblem,
                warm_state: Optional[SolverState] = None,
                batch_tile: Optional[int] = None) -> SolveResult:
    """Drop-in variant of `solver.solve` running the fused kernel.

    float32-only, as in loik_tpu: float64 inputs are rejected up front (the
    float64 path is `solver.solve` or the delta-duals refinement).  On CUDA
    tensors FK, prepare, reset, the launch and the result run as one
    captured CUDA graph per key (`utils.graphs`, the counterpart of
    loik_tpu's `_run_fused`); eagerly under `utils.disable_graphs()` or
    `utils.debug_nans()`."""
    from ..utils import graphs

    q = _as_batch(tree, q)
    if q.dtype == torch.float64:
        raise ValueError(
            "solve_fused is float32-only; cast inputs to float32 or use "
            "solver.solve / solve_delta_duals for float64"
        )
    validate_problem(tree, problem)
    return graphs.run(
        "solve_fused", tree, (params, batch_tile),
        lambda tree_, q_, problem_, warm_: _fused_body(params, batch_tile, tree_, q_,
                                                       problem_, warm_),
        (q, problem, warm_state))
