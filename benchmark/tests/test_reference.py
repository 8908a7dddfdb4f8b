import itertools
import os

import pytest
import torch

import inputs
from reference import check, kinematics, qp

ROBOTS = os.path.join(os.path.dirname(inputs.HERE), "benchmark", "robots")


def _random_qp(B, n, m, seed, box=10.0):
    g = torch.Generator().manual_seed(seed)
    L = torch.randn((B, n, n), generator=g, dtype=torch.float64)
    M = L @ L.transpose(-1, -2) + 0.5 * torch.eye(n, dtype=torch.float64)
    C = torch.randn((B, m, n), generator=g, dtype=torch.float64)
    d = torch.randn((B, m), generator=g, dtype=torch.float64)
    l = torch.full((B, n), -box, dtype=torch.float64)
    return M, torch.zeros((B, n), dtype=torch.float64), C, d, l, -l


def test_interior_point_equals_the_closed_form_with_a_loose_box():
    M, g, C, d, l, u = _random_qp(16, 7, 6, 0, box=1e3)
    res = qp.solve(M, g, C, d, l, u)
    Mi = torch.linalg.inv(M)
    x = Mi @ C.transpose(-1, -2) @ torch.linalg.solve(C @ Mi @ C.transpose(-1, -2), d[..., None])
    assert bool(res.solved.all())
    assert float((res.x - x[..., 0]).abs().max()) < 1e-9


def test_interior_point_equals_enumerated_active_sets():
    B, n, m = 8, 3, 1
    M, g, C, d, l, u = _random_qp(B, n, m, 1, box=0.3)
    res = qp.solve(M, g, C, d, l, u)
    for b in range(B):
        best = None
        for act in itertools.product((None, "l", "u"), repeat=n):
            fixed = [i for i in range(n) if act[i]]
            free = [i for i in range(n) if not act[i]]
            x = torch.zeros(n, dtype=torch.float64)
            for i in fixed:
                x[i] = l[b, i] if act[i] == "l" else u[b, i]
            if free:
                Mf, Cf = M[b][free][:, free], C[b][:, free]
                rhs_d = d[b] - C[b][:, fixed] @ x[fixed] if fixed else d[b]
                K = torch.zeros((len(free) + m, len(free) + m), dtype=torch.float64)
                K[:len(free), :len(free)], K[:len(free), len(free):] = Mf, Cf.T
                K[len(free):, :len(free)] = Cf
                rhs = torch.cat([-(M[b][free][:, fixed] @ x[fixed]) if fixed
                                 else torch.zeros(len(free), dtype=torch.float64), rhs_d])
                try:
                    x[free] = torch.linalg.solve(K, rhs)[:len(free)]
                except RuntimeError:
                    continue
            elif (C[b] @ x - d[b]).abs().max() > 1e-9:
                continue
            if (x < l[b] - 1e-12).any() or (x > u[b] + 1e-12).any():
                continue
            if (C[b] @ x - d[b]).abs().max() > 1e-9:
                continue
            f = float(0.5 * x @ M[b] @ x)
            if best is None or f < best[0]:
                best = (f, x)
        if best is None:
            assert not bool(res.solved[b])
        else:
            assert bool(res.solved[b])
            assert float((res.x[b] - best[1]).abs().max()) < 1e-7


@pytest.mark.parametrize("urdf,free,keep", [
    ("panda.urdf", False, [f"panda_joint{i}" for i in range(1, 8)]),
    ("talos.urdf", True, None),
])
def test_jacobians_are_the_derivative_of_the_frames(urdf, free, keep):
    robot = kinematics.load(os.path.join(ROBOTS, urdf), free, keep)
    g = torch.Generator().manual_seed(2)
    B = 3
    q = torch.rand((B, robot.nq), generator=g, dtype=torch.float64) * 2 - 1
    nu = torch.randn((B, robot.nv), generator=g, dtype=torch.float64)
    if free:      # a unit quaternion, and a step that turns it in the local frame
        q[:, 3:7] = q[:, 3:7] / q[:, 3:7].norm(dim=-1, keepdim=True)
    J = kinematics.jacobians(robot, q)
    h = 1e-6

    def moved(t):
        return inputs.displaced(robot, q, t * nu)

    Rp, pp = kinematics.frames(robot, moved(h))
    Rm, pm = kinematics.frames(robot, moved(-h))
    R, _ = kinematics.frames(robot, q)
    for i in range(len(robot.joints)):
        v = (J[i] @ nu[..., None])[..., 0]
        lin = (R[:, i].transpose(-1, -2) @ ((pp[:, i] - pm[:, i]) / (2 * h))[..., None])[..., 0]
        W = R[:, i].transpose(-1, -2) @ (Rp[:, i] - Rm[:, i]) / (2 * h)
        ang = torch.stack([W[:, 2, 1], W[:, 0, 2], W[:, 1, 0]], -1)
        assert float((v[:, :3] - lin).abs().max()) < 1e-6
        assert float((v[:, 3:] - ang).abs().max()) < 1e-6


def _panda(B=16, seed=7):
    cell = inputs.load_cell("panda_arm.plan")
    cell.config["batch"] = B
    q = inputs.configurations(cell, seed, 1, "cpu")[0]
    A, b, lo, hi = inputs.task_tensors(cell, torch.float32, "cpu")
    return cell, q, A, b, lo, hi


def test_the_reference_agrees_with_itself_and_its_lower_precisions():
    cell, q, A, b, lo, hi = _panda()
    x, solved = check.optimum(cell.robot, cell.links, q, A, b, lo, hi)
    x2, solved2 = check.optimum(cell.robot, cell.links, q.clone(), A, b, lo, hi)
    assert torch.equal(x, x2) and torch.equal(solved, solved2) and bool(solved.any())

    def numbers(nu, conv):
        j = check.judge(cell.robot, cell.links, q, A, b, lo, hi, nu, conv, x, solved)
        return check.numbers(j, 1e-5)

    same = numbers(x, solved)
    assert same["missed"] == 0.0 and same["nu_err_p99"] == 0.0 and same["residual"] < 1e-9
    x32, s32 = check.optimum(cell.robot, cell.links, q, A, b, lo, hi, "float32")
    assert numbers(x32, s32 & solved)["residual"] < 1e-5
    xb, sb = check.optimum(cell.robot, cell.links, q, A, b, lo, hi, "bfloat16")
    low = numbers(xb, sb & solved)
    assert low["residual"] > 1e-4 and low["nu_err_p99"] > 1e-3 and low["missed"] > 0.5


def test_the_numbers_see_misses_claims_and_altered_answers():
    cell, q, A, b, lo, hi = _panda()
    x, solved = check.optimum(cell.robot, cell.links, q, A, b, lo, hi)
    i = int(solved.nonzero()[0, 0])

    def numbers(nu, conv):
        j = check.judge(cell.robot, cell.links, q, A, b, lo, hi, nu, conv, x, solved)
        return check.numbers(j, 1e-5)

    conv = solved.clone()
    conv[i] = False                                       # one answer missing
    n = numbers(x, conv)
    assert n["missed"] == pytest.approx(1 / int(solved.sum())) and n["n_unflagged"] == 1
    nu = x.clone()
    nu[i, 0] += 0.05                                      # one answer altered
    n = numbers(nu, solved)
    assert n["residual"] > 1e-3 and n["nu_err_max"] >= 0.05
    assert n["missed"] == pytest.approx(1 / int(solved.sum()))
    if not bool(solved.all()):                            # a claim the reference cannot back
        n = numbers(x, torch.ones_like(solved))
        assert n["nu_err_max"] == float("inf") and n["n_flagged_unsolved"] > 0
