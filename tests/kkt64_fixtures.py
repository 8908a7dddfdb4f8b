"""States, problems and trees on which the KKT64 kernel (`kernels.kkt64`) is
held against the plain float64 step (`solver.refine._kkt64_plain`):
tests/test_torch_kkt64_kernel.py, and tools/kkt64_check.py on the card.
Imports torch and numpy only."""

import dataclasses

import numpy as np
import torch

import loik_tpu_torch as lt
from loik_tpu_torch.model import builders
from loik_tpu_torch.model import tree as mtree
from loik_tpu_torch.solver import refine
from loik_tpu_torch.solver.state import init_state

from fk_fixtures import per_problem

# every joint type whose motion subspace is constant, twice over
CONSTANT = (mtree.REVOLUTE, mtree.PRISMATIC, mtree.SPHERICAL, mtree.REVOLUTE_UNBOUNDED,
            mtree.TRANSLATION, mtree.PLANAR, mtree.HELICAL) * 2
# the plan cells' robots, the configurations `chip_smoke.config` names them
# by, their batches and check intervals
CELLS = {"panda_arm": ("flagship", 16384, 8), "talos": ("talos", 4096, 1),
         "solo12": ("solo12", 10240, 1)}


def zoo(seed, device="cpu"):
    """A free-flyer root and two joints of every other constant-subspace
    type under random parents (`builders.random_tree`), float64."""
    return builders.random_tree(np.random.default_rng(seed), 1 + len(CONSTANT),
                                floating_base=True, force_types=CONSTANT,
                                name=f"kkt_zoo{seed}", device=device)


def random_state(tree, B, num_constraints, seed=0):
    """A float32 stage-1 state of ``tree`` with every leaf the step reads
    drawn at random (the padded dof slots 0, as the solver keeps them)."""
    dev = tree.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = init_state(tree, B, num_constraints, torch.float32, dev)
    upd = {f: torch.randn(getattr(st, f).shape, generator=gen, dtype=torch.float32,
                          device=dev)
           for f in ("liMi_R", "liMi_p", "vis", "fis", "nu", "z", "w", "Aty")}
    for i, k in enumerate(tree.nvs):
        for f in ("nu", "z", "w"):
            upd[f][i, k:] = 0
    return dataclasses.replace(st, **upd)


def random_problem(tree, links, B, dtype=torch.float32, batched=False, seed=1):
    """A problem with every leaf drawn at random in ``dtype``, shared or
    (``batched``) one per problem; ``links`` is not validated, so two
    constraints may sit on one link."""
    dev = tree.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    lead = (B,) if batched else ()

    def r(*shape):
        return torch.randn(lead + shape, generator=gen, dtype=torch.float64,
                           device=dev).to(dtype)

    N, nv, nc = tree.njoints, tree.nv, len(links)
    lb = -0.1 - torch.rand(lead + (nv,), generator=gen, dtype=torch.float64,
                           device=dev).to(dtype)
    return lt.IkProblem(H_ref=r(N, 6, 6), v_ref=r(N, 6), A=r(nc, 6, 6), b=r(nc, 6),
                        lb=lb, ub=-lb, constraint_links=tuple(links))


def prepared32(tree, problem, B):
    """Stage 1's prepared float32 problem, as `_solve_impl` makes it."""
    from loik_tpu_torch.solver.solve import prepare_problem

    return prepare_problem(tree.astype(torch.float32),
                           refine._cast_problem(problem, torch.float32), B, torch.float32)


def differences(got, want):
    """The names of the step's outputs (``(prob_d, st_d, fdpa_hat)``) whose
    dtype, shape or bits differ."""
    out = []
    for side, a, b in (("problem", got[0], want[0]), ("state", got[1], want[1])):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
                same = (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                        and x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y))
                if not same:
                    out.append(f"{side}.{f.name}")
            elif x != y:
                out.append(f"{side}.{f.name}")
    if not (got[2].dtype == want[2].dtype and torch.equal(got[2], want[2])):
        out.append("fdpa_hat")
    return out


def case(name, device="cpu", B=45):
    """(tree, problem, stage-1 state) of a named case, random states and
    problems on the robot or tree it names."""
    if name in ("panda_arm", "talos", "solo12"):
        tree = lt.robots.get(name, "float32", device=device)
        N = tree.njoints
        links = {"panda_arm": (6,), "talos": (N - 1, 0), "solo12": (0,) + tree.leaf_joints}[name]
        problem = random_problem(tree, links, B)
    elif name == "float64_batched":     # float64 leaves, one per problem, on a float64 tree
        tree = lt.robots.talos("float64", device=device)
        problem = random_problem(tree, (5, 0, 20), B, torch.float64, batched=True)
    elif name == "zoo_two_on_one_link":  # every constant joint type; link 3 twice
        tree = zoo(1, device=device).to(dtype=torch.float32)
        problem = random_problem(tree, (3, 7, 3, 14), B, torch.float64)
    elif name == "batched_geometry":     # per-problem placements and axes
        tree = per_problem(lt.robots.panda_arm("float32", device=device), B)
        problem = random_problem(tree, (6, 2), B, batched=True)
    elif name == "mixed_dtypes":         # float64 H_ref, float32 rest (widened together)
        tree = lt.robots.solo12("float32", device=device)
        problem = random_problem(tree, (0,) + tree.leaf_joints, B)
        problem = dataclasses.replace(problem, H_ref=problem.H_ref.double() / 3)
    elif name == "tall_tree":            # 150 joints: a row of threads takes several
        tree = builders.random_tree(np.random.default_rng(2), 150, floating_base=True,
                                    force_types=CONSTANT * 10 + (mtree.REVOLUTE,) * 9,
                                    name="kkt_tall", device=device).to(dtype=torch.float32)
        problem = random_problem(tree, (149, 0, 75), B)
    elif name == "many_constraints":     # more than the fused loop's MAX_CONSTRAINTS
        tree = lt.robots.talos("float32", device=device)
        problem = random_problem(tree, tuple(range(0, 33, 3)), B)
    else:
        raise KeyError(name)
    return tree, problem, random_state(tree, B, problem.num_constraints, seed=B)


CASES = ("panda_arm", "talos", "solo12", "float64_batched", "zoo_two_on_one_link",
         "batched_geometry", "mixed_dtypes", "tall_tree", "many_constraints")


def stage1(name, B=None):
    """(tree, problem, stage 1's prepared problem, stage-1 state) of a plan
    cell's robot (`chip_smoke.config`) at its batch: the float32 stage 1 of
    `solve_delta_duals` through the fused kernel."""
    import chip_smoke
    from loik_tpu_torch.kernels.fused import fused_loop
    from loik_tpu_torch.solver.solve import _solve_impl, full_f32_matmul

    cfg, B_cell, K = CELLS[name]
    tree, links, problem, params, q = chip_smoke.config(
        lt, torch, cfg, torch.float32, torch.device("cuda"), B or B_cell, K)
    p1 = params.replace(tol_abs=2e-5, tol_rel=2e-5, max_iter=32)
    loop = fused_loop(refine.default_batch_tile(tree.njoints))
    with full_f32_matmul():
        res1, prob32 = _solve_impl(tree, p1, q, problem, None, loop=loop, with_problem=True)
    return tree, problem, prob32, res1.state
