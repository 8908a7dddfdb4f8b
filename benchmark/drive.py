"""The system under test, driven as its users call it.

`loik_tpu_torch.DiffIkSolver` with the kernel required (``fused="require"``:
a fall-back to the eager loop raises instead of being timed) and graphs on
(the port's default).  The benchmark's inputs, made in the reference
robot's joint layout, are gathered into the program's layout; the
program's answers are gathered back for the comparison.  The request
loop of a traffic mix is `entries/<entry>.py`, found by the mix's
``entry``, the name of the `DiffIkSolver` method it calls.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

import inputs


@dataclasses.dataclass
class Answer:
    """What the comparison reads of one call: the answers in the reference's
    dof order, and the inputs the call was given (in the reference's
    layout)."""
    nu: torch.Tensor
    converged: torch.Tensor
    q: torch.Tensor
    b: torch.Tensor


@dataclasses.dataclass
class Iters:
    """A call's iteration counts: the largest, the sum over its problems, and
    the sum of each problem's checks (iterations // check_interval)."""
    max: int
    total: int
    checks: int


class Program:
    """The port's tree, task and solver settings for a cell."""

    def __init__(self, cell: inputs.Cell, device):
        import loik_tpu_torch as lt

        self.lt, self.cell, self.device = lt, cell, torch.device(device)
        self.tree = getattr(lt.robots, cell.config["robot"]["program"])("float32", device=device)
        names = list(self.tree.joint_names)
        robot = cell.robot
        qidx = [0] * self.tree.nq
        vperm = []
        for j, sq, sv in zip(robot.joints, robot.q_slices(), robot.v_slices()):
            i = names.index(j.name)
            if self.tree.nvs[i] != j.nv:
                raise ValueError(f"joint {j.name}: {self.tree.nvs[i]} dofs in the program, "
                                 f"{j.nv} in the reference")
            for k in range(sq.stop - sq.start):
                qidx[self.tree.idx_q[i] + k] = sq.start + k
            vperm += range(self.tree.idx_v[i], self.tree.idx_v[i] + j.nv)
        self.qidx = torch.tensor(qidx, device=device)
        self.vperm = torch.tensor(vperm, device=device)
        self.links = tuple(names.index(n) for n in cell.links)
        self.A, self.b, self.lo, self.hi = inputs.task_tensors(cell, torch.float32, device)
        self.params = lt.SolverParams(**cell.solver)

    def to_program(self, q_ref: torch.Tensor) -> torch.Tensor:
        return q_ref.index_select(-1, self.qidx).contiguous()

    def to_reference(self, nu: torch.Tensor) -> torch.Tensor:
        return nu.index_select(-1, self.vperm)

    def solver(self, b: Optional[torch.Tensor] = None, fused="require"):
        ones = torch.ones(self.tree.nv, device=self.device)
        problem = self.lt.make_problem(self.tree, self.links, A=self.A,
                                       b=self.b if b is None else b,
                                       lb=self.lo * ones, ub=self.hi * ones)
        return self.lt.DiffIkSolver(self.tree, self.params, self.links, problem=problem,
                                    fused=fused)

    def iters(self, res) -> torch.Tensor:
        """(max, total, checks) of a result's iteration counts, on the device."""
        it = res.iterations.long()
        k = int(self.params.check_interval)
        return torch.stack([it.max(), it.sum(), (it // k).sum()])


class Requests:
    """A cell's request loop, one class per entry point of the program in
    `entries/<entry>.py`, found by the traffic mix's ``entry``: `call(i)`
    sends request i and returns the result; `answer(i, nu, converged)` is
    what the comparison reads of it; `units(converged)` counts what the
    request completed (on the device where it has to read the answer);
    `keep_key(i)` the slot under which its answer is kept for the check;
    `cycle()` the calls after which the traffic repeats itself (the traced
    stretch).  ``send`` holds the program's callable."""

    launches_per_call = 1
    settle = 2
    send: Optional[Callable] = None

    def call(self, i: int):
        raise NotImplementedError

    def answer(self, i: int, nu, converged) -> Answer:
        raise NotImplementedError

    def units(self, converged):
        raise NotImplementedError

    def keep_key(self, i: int):
        raise NotImplementedError

    def cycle(self) -> int:
        raise NotImplementedError

    def control(self, side: str):
        """Put a control of the program's own in its place (`readings.py`)."""
        raise ValueError(f"{type(self).__module__} offers no {side!r} control")

    def release(self):
        """Drop the program's callable and so its captured state."""
        self.send = None


def requests(prog: Program, seed: int) -> Requests:
    return prog.cell.entry.Requests(prog, seed)


@dataclasses.dataclass
class Window:
    seconds: float = 0.0            # from the first call to the last answer
    calls: int = 0
    units: float = 0.0
    latency_ms: List[float] = dataclasses.field(default_factory=list)   # call to answer
    host_ms: List[float] = dataclasses.field(default_factory=list)      # call to return
    start_s: List[float] = dataclasses.field(default_factory=list)      # from the first call
    iters: List[Iters] = dataclasses.field(default_factory=list)
    kept: Dict[object, tuple] = dataclasses.field(default_factory=dict)   # (i, nu, converged)


def run_calls(req: Requests, first: int, seconds: Optional[float] = None,
              count: Optional[int] = None, iters: bool = False, label=None) -> Window:
    """Requests first, first + 1, ... in a closed loop: each answer ready on
    the device before the next call; for ``seconds`` or ``count`` calls.
    Each call's latency is taken by CUDA events recorded around it on the
    stream, which is idle when the call starts, so they span the host's
    work of the call as well as the device's; the same two events serve
    every call."""
    win = Window()
    cuda = req.prog.device.type == "cuda"
    if cuda:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    units = 0
    its = []
    i = first
    t0 = time.perf_counter()
    while True:
        if cuda:
            e0.record()
        h0 = time.perf_counter()
        if label is not None:
            with label("bench.call"):
                res = req.call(i)
        else:
            res = req.call(i)
        h1 = time.perf_counter()
        if cuda:
            e1.record()
            torch.cuda.synchronize()
            win.latency_ms.append(e0.elapsed_time(e1))
        else:
            win.latency_ms.append((time.perf_counter() - h0) * 1e3)
        win.host_ms.append((h1 - h0) * 1e3)
        win.start_s.append(h0 - t0)
        units = units + req.units(res.converged)
        if iters:
            its.append(req.prog.iters(res))
        win.kept[req.keep_key(i)] = (i, res.nu, res.converged)
        i += 1
        if (seconds is not None and time.perf_counter() - t0 >= seconds) or (
                count is not None and i - first >= count):
            break
    win.seconds = time.perf_counter() - t0
    win.calls = i - first
    win.units = float(units)
    win.iters = [Iters(*(int(v) for v in t.tolist())) for t in its]
    return win
