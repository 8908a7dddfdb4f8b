"""The cell's specification and the general traffic generator.

A cell names a configuration (`configs/<name>.json`: the robot, the task,
the solver settings, the batch) and a traffic mix (`traffic/<name>.json`:
the entry point it calls, whose request loop is `entries/<entry>.py`, and
its parameters).  Everything here is found by those names, and every input
is made from the seed on the run's device with plain torch, in the
reference robot's joint layout (`reference.kinematics`); the harness hands
the program the same inputs in the program's layout.  A key that nothing
reads is refused: the task's weights are the program's defaults (H_ref = I
on every link, v_ref = 0), which the reference assumes, and a file that set
them would otherwise be timed and checked as if it had not.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import re
from types import ModuleType
from typing import List, Optional

import torch

from reference import kinematics

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


CONFIG_KEYS = {"name", "source", "robot", "task", "solver", "refine", "batch",
               "base_position_bound", "assumed", "reduced"}
ROBOT_KEYS = {"program", "urdf", "floating_base", "joints"}
TASK_KEYS = {"constraints", "box"}
CONSTRAINT_KEYS = {"joint", "A", "b"}
TRAFFIC_KEYS = {"name", "entry", "batch", "solver"}     # and those of its entry


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def find(kind: str, name: str, ext: str = ".json") -> str:
    """The file of a configuration, a traffic mix, a limit set or an entry's
    request loop, by name."""
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a valid name")
    path = os.path.join(HERE, kind, f"{name}{ext}")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r} ({path})")
    return path


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _only(what: str, keys, allowed):
    extra = sorted(set(keys) - set(allowed))
    if extra:
        raise ValueError(f"{what}: keys {extra} are read by nothing")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    robot: kinematics.Robot
    entry: ModuleType                   # entries/<traffic's entry>.py

    @property
    def batch(self) -> int:
        return int(self.traffic.get("batch") or self.config["batch"])

    @property
    def solver(self) -> dict:
        return {**self.config["solver"], **self.traffic.get("solver", {})}

    @property
    def links(self) -> List[str]:
        return [c["joint"] for c in self.config["task"]["constraints"]]


def load_cell(workload: str, spec: Optional[dict] = None) -> Cell:
    spec = spec if spec is not None else benchmark_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    config = read_json(find("configs", w["config"]))
    traffic = read_json(find("traffic", w["traffic"]))
    limits = read_json(find("limits", workload))
    entry = load_module(find("entries", traffic["entry"], ".py"),
                        f"bench_entry_{traffic['entry']}")
    _only(f"configs/{w['config']}.json", config, CONFIG_KEYS)
    _only(f"configs/{w['config']}.json robot", config["robot"], ROBOT_KEYS)
    _only(f"configs/{w['config']}.json task", config["task"], TASK_KEYS)
    for c in config["task"]["constraints"]:
        _only(f"configs/{w['config']}.json constraint", c, CONSTRAINT_KEYS)
    _only(f"traffic/{w['traffic']}.json", traffic, TRAFFIC_KEYS | entry.KEYS)
    rob = config["robot"]
    robot = kinematics.load(os.path.join(ROOT, rob["urdf"]), rob["floating_base"], rob["joints"])
    return Cell(workload, config, traffic, limits, robot, entry)


def task_tensors(cell: Cell, dtype, device):
    """(A (NC, 6, 6), b (NC, 6), lower, upper) of the configuration's task."""
    A, b = [], []
    for c in cell.config["task"]["constraints"]:
        A.append(torch.eye(6) if c["A"] == "identity" else torch.tensor(c["A"]))
        b.append(torch.tensor(c["b"]))
    lo, hi = cell.config["task"]["box"]
    return (torch.stack(A).to(dtype=dtype, device=device),
            torch.stack(b).to(dtype=dtype, device=device), float(lo), float(hi))


def _generator(device, seed: int, stream: int) -> torch.Generator:
    # one independent stream per purpose; the seed may exceed 32 bits
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) % (1 << 63))


def _limits(robot, dtype, device, margin: float = 0.0):
    lo = torch.tensor([j.lower + margin for j in robot.joints if j.kind != "free"],
                      dtype=dtype, device=device)
    hi = torch.tensor([j.upper - margin for j in robot.joints if j.kind != "free"],
                      dtype=dtype, device=device)
    return lo, hi


def configurations(cell: Cell, seed: int, count: int, device, stream: int = 0,
                   margin: float = 0.0, dtype=torch.float32) -> torch.Tensor:
    """(count, B, nq) configurations, each joint uniform between its limits
    (shrunk by ``margin``), a free-flyer's position uniform in the
    configuration's base box and its orientation uniform."""
    robot, B = cell.robot, cell.batch
    gen = _generator(device, seed, stream)
    u = torch.rand((count, B, robot.nq), generator=gen, dtype=dtype, device=device)
    gauss = torch.randn((count, B, 4), generator=gen, dtype=dtype, device=device)
    lo, hi = _limits(robot, dtype, device, margin)
    q = torch.empty_like(u)
    k = 0
    for j, sl in zip(robot.joints, robot.q_slices()):
        if j.kind == "free":
            bound = float(cell.config["base_position_bound"])
            q[..., sl.start:sl.start + 3] = (2 * u[..., sl.start:sl.start + 3] - 1) * bound
            q[..., sl.start + 3:sl.stop] = gauss / gauss.norm(dim=-1, keepdim=True)
        else:
            q[..., sl.start] = lo[k] + (hi[k] - lo[k]) * u[..., sl.start]
            k += 1
    return q


def _quat_mul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], -1)


def _exp_quat(w):
    th = w.norm(dim=-1, keepdim=True)
    half = 0.5 * th
    k = torch.where(th > 1e-12, torch.sin(half) / th.clamp_min(1e-30), 0.5 - th * th / 48)
    return torch.cat([w * k, torch.cos(half)], -1)


def displaced(robot, q0: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """q0 moved by the tangent displacement d (..., nv): joints add, a
    free-flyer moves by d_linear and turns by exp(d_angular), both in its
    local frame (to first order Pinocchio's `integrate`)."""
    q = q0.clone()
    for j, sq, sv in zip(robot.joints, robot.q_slices(), robot.v_slices()):
        if j.kind == "free":
            R = kinematics.quat_to_rot(q0[..., sq.start + 3:sq.stop])
            q[..., sq.start:sq.start + 3] += (R @ d[..., sv.start:sv.start + 3, None])[..., 0]
            q[..., sq.start + 3:sq.stop] = _quat_mul(q0[..., sq.start + 3:sq.stop],
                                                     _exp_quat(d[..., sv.start + 3:sv.stop]))
        else:
            q[..., sq.start] += d[..., sv.start]
    return q


@dataclasses.dataclass
class Fleet:
    """The tracking traffic's seeded fleet: base configurations, phases."""
    q0: torch.Tensor     # (B, nq)
    psi: torch.Tensor    # (B, nv)
    phi: torch.Tensor    # (B,)

    def ticks(self, cell: Cell, ts: torch.Tensor):
        """(q_t (T, B, nq), b_t (T, B, NC, 6)) at the integer ticks ``ts``."""
        tr = cell.traffic
        t = ts.to(self.q0.dtype)[:, None, None]
        amp, per = tr["motion"]["amplitude"], tr["motion"]["period"]
        d = amp * torch.sin(2 * math.pi * t / per + self.psi)
        q = displaced(cell.robot, self.q0.expand(len(ts), *self.q0.shape), d)
        _, b, _, _ = task_tensors(cell, self.q0.dtype, self.q0.device)
        b = b.expand(len(ts), self.q0.shape[0], *b.shape).clone()
        tg = tr["target"]
        b[:, :, tg["slot"], tg["axis"]] = tg["amplitude"] * torch.cos(
            2 * math.pi * t[:, :, 0] / tg["period"] + self.phi)
        return q, b


def fleet(cell: Cell, seed: int, device, dtype=torch.float32) -> Fleet:
    amp = cell.traffic["motion"]["amplitude"]
    q0 = configurations(cell, seed, 1, device, stream=1, margin=amp, dtype=dtype)[0]
    gen = _generator(device, seed, 2)
    B, nv = cell.batch, cell.robot.nv
    psi = 2 * math.pi * torch.rand((B, nv), generator=gen, dtype=dtype, device=device)
    phi = 2 * math.pi * torch.rand((B,), generator=gen, dtype=dtype, device=device)
    return Fleet(q0, psi, phi)


def tick_period(cell: Cell) -> int:
    """Ticks after which the tracking traffic repeats itself."""
    return math.lcm(int(cell.traffic["motion"]["period"]), int(cell.traffic["target"]["period"]))
