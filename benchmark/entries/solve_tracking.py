"""Request loop of `DiffIkSolver.solve_tracking`: one warm-started tick of
the whole fleet per request.

Traffic keys: ``fleet_seed``, ``motion`` (amplitude, period) and ``target``
(slot, axis, amplitude, period) of the fleet's trajectory
(`inputs.fleet`), ``settle`` (ticks before the window) and
``check_every`` (one tick in that many is kept for the check).  The fleet
(base configurations and phases) is the traffic's own, drawn from its
``fleet_seed``, and its trajectory repeats after `inputs.tick_period`
ticks; the run's seed orders the robots and sets the tick the window
starts at, so every seed meets the same problems in another order (the
time of a tick is set by the fleet's hardest robot, so a fleet drawn anew
each run would change the work).
"""

from __future__ import annotations

import torch

import drive
import inputs

KEYS = {"fleet_seed", "motion", "target", "settle", "check_every"}


class Requests(drive.Requests):
    launches_per_call = 1

    def __init__(self, prog: drive.Program, seed: int):
        cell = prog.cell
        tr = cell.traffic
        self.prog = prog
        self.settle = int(tr["settle"])
        dev = prog.device
        fleet = inputs.fleet(cell, int(tr["fleet_seed"]), dev)
        gen = torch.Generator().manual_seed(seed % (1 << 63))
        period = inputs.tick_period(cell)
        order = torch.randperm(cell.batch, generator=gen).to(dev)
        self.start = int(torch.randint(period, (1,), generator=gen))
        self.every = int(tr["check_every"])
        self.offset = int(torch.randint(self.every, (1,), generator=gen))
        q_ref, b_ref = fleet.ticks(cell, torch.arange(period, device=dev))
        self.q_ref = q_ref[:, order].contiguous()
        self.b_ref = b_ref[:, order].contiguous()
        self.q = prog.to_program(self.q_ref)
        slot = int(tr["target"]["slot"])
        self.b_slot = self.b_ref[:, :, slot].contiguous()
        solver = prog.solver(b=self.b_ref[self.start])
        link = prog.links[slot]
        self.send = lambda q, b: solver.solve_tracking(q, link, b=b)

    def _k(self, i):
        return (self.start + i) % len(self.q)

    def call(self, i):
        k = self._k(i)
        return self.send(self.q[k], self.b_slot[k])

    def answer(self, i, nu, converged):
        k = self._k(i)
        return drive.Answer(self.prog.to_reference(nu), converged, self.q_ref[k], self.b_ref[k])

    def units(self, converged):
        return converged.shape[0]

    def keep_key(self, i):
        # a seeded sample of the ticks; "last" always holds the latest one
        return i if i % self.every == self.offset else "last"

    def cycle(self):
        return len(self.q)
