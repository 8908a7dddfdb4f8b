"""The least time the fused ADMM loop needs for a call, from shapes alone.

Bytes: each launch reads its inputs once and writes its outputs once, per
problem the joint placements (12 N words), the task targets (6 NC), the box
(2 nv) and the iterate (primal v and nu, duals f, y and w, slack z: 12 N +
3 nv + 6 NC words) and writes the iterate and its flags back; float32
words.  Operations: the arithmetic of the iterations the call's problems
ran (a multiply and an add count one each): the iterate's sweeps every
iteration, the Riccati factorisation and the checks every check_interval
iterations.  The operation formula is chip_smoke.py's `loop_bound`, written
from the robot's shape instead of the program's field lists.

The published peaks of one H100 SXM (NVIDIA's data sheet): 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM3, at the full 700 W.
"""

from __future__ import annotations

from typing import Sequence

PEAK_FP32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12
WORD = 4
FLAG_WORDS = 4          # converged, iterations, two residuals


def launch_bytes(N: int, nv: int, NC: int, B: int) -> int:
    """Bytes one launch over B problems reads and writes at the least."""
    iterate = 12 * N + 3 * nv + 6 * NC
    reads = 12 * N + 6 * NC + 2 * nv + iterate
    writes = iterate + FLAG_WORDS
    return WORD * B * (reads + writes)


def iteration_ops(nvs: Sequence[int], parents: Sequence[int], NC: int):
    """(operations of one iteration, of one factorisation and check) for one
    problem of a tree with per-joint dofs ``nvs`` and ``parents``."""
    N, nv = len(nvs), sum(nvs)
    nonroot = [k for k, par in zip(nvs, parents) if par >= 0]
    h_half = 6 * N + 72 * NC                      # rho I + H_ref + mu_eq A'A
    for k in nvs:                                 # U = H S, D = S'U + mu I, D^-1
        h_half += 66 * k + 11 * k * k + k + (1 if k == 1 else 2 * k ** 3)
    for k in nonroot:                             # U D^-1, H - U D^-1 U', X* Ha X*'
        h_half += 6 * k * (2 * k - 1) + 72 * k + 846
    iterate = 2 * nv + 12 * N + 18 * NC           # forward pass 1
    iterate += 12 * nv + sum(12 * k + 51 for k in nonroot)            # backward pass
    iterate += N * (39 + 72) + sum(12 * k + 2 * k * k + 12 * k for k in nvs)  # forward pass 2
    iterate += 6 * nv + 144 * NC                  # box projection, dual update
    checks = 57 * N + 13 * nv + 78 * N + 40 * N + 20 * nv + 30 * NC   # residuals, norms
    return iterate, h_half + checks


def least_ms(nvs: Sequence[int], parents: Sequence[int], NC: int, B: int, launches: int,
             iterations: int, checks: int):
    """(least time in ms, "bytes" or "operations") of one call: ``launches``
    launches over B problems that ran ``iterations`` iterations and
    ``checks`` factorisations and checks in all (each problem's iterations
    over the check interval, rounded down, summed)."""
    per_it, per_check = iteration_ops(nvs, parents, NC)
    ops = iterations * per_it + checks * per_check
    nbytes = launches * launch_bytes(len(nvs), sum(nvs), NC, B)
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_FP32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
