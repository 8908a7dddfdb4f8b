"""Request loop of `DiffIkSolver.solve_refined`: one solve of a fresh batch
per request, from a pool of seeded batches that the calls cycle.

Traffic keys: ``pool``, the number of distinct batches.  The
configuration's ``refine`` holds the method and its options.
"""

from __future__ import annotations

import drive
import inputs

KEYS = {"pool"}


class Requests(drive.Requests):
    launches_per_call = 2

    def __init__(self, prog: drive.Program, seed: int):
        cell = prog.cell
        self.prog = prog
        self.pool_ref = inputs.configurations(cell, seed, int(cell.traffic["pool"]), prog.device)
        self.pool = prog.to_program(self.pool_ref)
        refine = dict(cell.config["refine"])
        method = refine.pop("method")
        solver = prog.solver()
        self.send = lambda q: solver.solve_refined(q, method=method, **refine)

    def call(self, i):
        return self.send(self.pool[i % len(self.pool)])

    def answer(self, i, nu, converged):
        k = i % len(self.pool)
        return drive.Answer(self.prog.to_reference(nu), converged, self.pool_ref[k], self.prog.b)

    def units(self, converged):
        return converged.sum()

    def keep_key(self, i):
        return i % len(self.pool)

    def cycle(self):
        return len(self.pool)

    def control(self, side):
        """"float32": the program's own float32 path through the same kernel
        with the same settings (`kernels.fused.solve_fused`), i.e. the
        refined solve with its float64 step switched off."""
        if side != "float32":
            return super().control(side)
        from loik_tpu_torch.kernels.fused import solve_fused

        prog, problem = self.prog, self.prog.solver().problem
        self.send = lambda q: solve_fused(prog.tree, prog.params, q, problem)
