"""A tree is a graph input keyed by its topology, as `jax.jit` takes
loik_tpu's pytree: its aux data (parents, joint types, dof indexing, names,
pitches, mimic pairs) and whether each tensor leaf is there, with its shape,
dtype and device, key the graph; its geometry is traced.  So another tree
of the same topology (a robot loaded anew, a calibrated copy) replays the
graph of the first, on its own geometry: the casts and the kernel's S
operand that the graph's tree derives from its leaves are recomputed when
another tree's leaves are copied in.

On the CPU through the stand-in capture of tests/test_torch_graphs.py
(`fake_graphs`), which drives the real graph path: a tree A, then a tree B
of A's topology with its placements moved and its axes turned (numpy,
seeded), then A again, through every graphed entry point.  One capture in
all, and each result equals the same call under `disable_graphs()` on its
own tree, bit for bit.  A new topology misses; a graph holds no reference
to a tree.  Against loik_tpu: its `solve_delta_duals` compiles once for A
and B, the port captures once, and the port's B result holds against
loik_tpu's B within the float32 budget of tests/test_torch_refine.py (nu
where both converged within 2e-5, at most 1% of the flags apart,
iteration counts within one check interval).

The kernel does not read S on the CPU (its CPU branch is the eager loop),
so the refreshed S operand is checked on the card by the `cuda` tests of
tests/test_torch_kernel.py and by chip_smoke.py's phase 21.
"""

import dataclasses
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu.model import tree as jtree
from loik_tpu.params import SolverParams as JParams
from loik_tpu.problem import make_problem as jmake_problem
from loik_tpu.solver import refine as jrefine
from loik_tpu_torch import convert
from loik_tpu_torch.kernels import fused
from loik_tpu_torch.model import tree as ttree
from loik_tpu_torch.utils import graphs

from test_torch_graphs import assert_bits, b_sweep
from test_torch_graphs import fake_graphs, standin_loop  # noqa: F401  (fixtures)

PARAMS = dict(max_iter=10, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
              mu_equality_scale_factor=1e5, tail_solve=False)
TRACK = dict(max_iter=10, tol_abs=1e-4, tol_rel=1e-4, warm_start=True)
B = 6


def _turn(axis: np.ndarray, k: np.ndarray, ang: np.ndarray) -> np.ndarray:
    """Each row of ``axis`` turned by ``ang`` about the unit row of ``k``
    (Rodrigues), renormalised."""
    out = (axis * np.cos(ang)[:, None] + np.cross(k, axis) * np.sin(ang)[:, None]
           + k * (k * axis).sum(-1, keepdims=True) * (1 - np.cos(ang))[:, None])
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def calibrated(tree, seed, dp=0.02, deg=3.0):
    """A tree of ``tree``'s topology: each placement moved by up to ``dp``
    per coordinate and each axis turned by ``deg``/2 to ``deg`` degrees
    about a random direction (numpy, ``seed``)."""
    rng = np.random.default_rng(seed)
    N, dtype = tree.njoints, tree.dtype
    k = rng.normal(size=(N, 3))
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    ang = np.deg2rad(rng.uniform(deg / 2, deg, N))
    axis = _turn(tree.axis.double().numpy(), k, ang)
    dpos = rng.uniform(-dp, dp, tuple(tree.placement_p.shape))
    return dataclasses.replace(
        tree, placement_p=tree.placement_p + torch.as_tensor(dpos, dtype=dtype),
        axis=torch.as_tensor(axis, dtype=dtype))


def scaled_turned(tree):
    """``tree`` with its placements 1.05 times as far out and its axes
    turned 2.6 degrees about z."""
    N = tree.njoints
    axis = _turn(tree.axis.double().numpy(), np.tile([0.0, 0.0, 1.0], (N, 1)),
                 np.full(N, np.deg2rad(2.6)))
    return dataclasses.replace(tree, placement_p=tree.placement_p * 1.05,
                               axis=torch.as_tensor(axis, dtype=tree.dtype))


def arm(dtype=torch.float32):
    """A panda_arm tree that the robot cache does not hold, its task
    (v_z = 0.2 at the flange, box +-4) and B configurations."""
    tree = dataclasses.replace(lt.robots.panda_arm(str(dtype).removeprefix("torch."),
                                                   device="cpu"))
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.uniform(-np.pi, np.pi, (B, 7)), dtype=dtype)
    problem = lt.make_problem(tree, (6,), b=np.array([[0, 0, 0.2, 0, 0, 0]]),
                              lb=-4 * np.ones(7), ub=4 * np.ones(7))
    return tree, q, problem


def fleet_groups(seed=None, per=B // 2):
    """[(tree, q, problem)] of ``per`` UR5 and ``per`` panda_arm in float32,
    each tree calibrated with ``seed`` when given."""
    rng = np.random.default_rng(4)
    groups = []
    for i, name in enumerate(("ur5", "panda_arm")):
        t = lt.robots.get(name, "float32", device="cpu")
        if seed is not None:
            t = calibrated(t, seed + i)
        p = lt.make_problem(t, (t.njoints - 1,), b=np.array([[0, 0, 0.2, 0, 0, 0]]),
                            lb=-4 * np.ones(t.nv), ub=4 * np.ones(t.nv))
        q = torch.as_tensor(rng.uniform(-np.pi, np.pi, (per, t.nq)), dtype=torch.float32)
        groups.append((t, q, p))
    return groups


def fleet(seed=None):
    """`MixedPadded` of `fleet_groups` and their configurations."""
    groups = fleet_groups(seed)
    mp = lt.parallel.prepare_mixed_padded([(t, q.shape[0], p) for t, q, p in groups])
    return mp, [q for _, q, _ in groups]


def entry(name, tree, q, problem):
    """One call of the entry point ``name`` on ``tree``."""
    params = lt.SolverParams(**PARAMS)
    if name.startswith("solve_delta_duals"):
        return lt.solve_delta_duals(tree, params, q, problem, fused=True)
    if name == "solve":
        return lt.solve(tree, params, q, problem)
    if name == "solve_two_stage":
        return lt.solve_two_stage(tree, params, q, problem)
    if name == "solve_fused":
        return fused.solve_fused(tree, params, q, problem)
    if name == "solve_refined":
        return lt.DiffIkSolver(tree, params, (6,), problem=problem,
                               fused=True).solve_refined(q)
    if name in ("track_scan", "track_scan_delta"):
        solver = lt.DiffIkSolver(tree, lt.SolverParams(**TRACK), (6,), problem=problem,
                                 fused=True)
        return solver.track_scan(q, b_sweep(3).to(q.dtype), 6,
                                 refine="delta" if name == "track_scan_delta" else None)
    if name == "solve_clik":
        target = lt.robots.panda_arm("float32", device="cpu")
        _, _, oR, op = target.fwd_kinematics(torch.zeros(B, 7))
        return lt.solve_clik(tree, lt.SolverParams(**TRACK), q, oR[:, 6].contiguous(),
                             op[:, 6].contiguous(), 6, steps=2, dt=0.1, gain=2.0, fused=True)
    if name == "solve_multistart":
        gen = torch.Generator().manual_seed(3)
        return lt.parallel.solve_multistart(tree, params, problem, gen, 8, k=2)
    raise KeyError(name)


ENTRIES = ["solve_delta_duals_f32", "solve_delta_duals_f64", "solve", "solve_two_stage",
           "solve_fused", "solve_refined", "track_scan", "track_scan_delta", "solve_clik",
           "solve_multistart", "solve_packed"]


def nu_of(res):
    return getattr(res, "nu", None) if not isinstance(res, tuple) else res[0]


@pytest.mark.parametrize("name", ENTRIES)
def test_a_calibrated_tree_replays_the_graph_on_its_own_geometry(name, fake_graphs,
                                                                  standin_loop):
    """A, then B of A's topology, then A again: one capture, each result
    equal to the same call under `disable_graphs()` on its own tree, bit
    for bit, and B's result differs from A's."""
    if name == "solve_packed":
        (mp_a, qs), (mp_b, _) = fleet(), fleet(seed=7)
        params = lt.SolverParams(**PARAMS)

        def call(mp):
            return mp.solve_packed(params, qs)
        a, b = mp_a, mp_b
    else:
        dtype = torch.float64 if name in ("solve_delta_duals_f64", "solve",
                                          "solve_two_stage") else torch.float32
        a, q, problem = arm(dtype)
        b = calibrated(a, seed=11)

        def call(tree):
            return entry(name, tree, q, problem)
    n = len(graphs.CAPTURES)
    got = [call(a), call(b), call(a)]
    assert len(graphs.CAPTURES) == n + 1, [c.tag for c in graphs.CAPTURES[n:]]
    with graphs.disable_graphs():
        want = [call(a), call(b)]
    assert_bits(got[0], want[0])
    assert_bits(got[1], want[1])
    assert_bits(got[2], want[0])
    assert not torch.equal(nu_of(got[0]), nu_of(got[1]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_jit_of_delta_duals_answers_with_the_tree_it_is_given(dtype, fake_graphs):
    """`utils.jit` over a function that calls `solve_delta_duals` on its
    tree argument: a second tree of the topology replays the capture
    (no new one) and answers with its own geometry, equal to the eager
    call on it bit for bit (a float64 tree's float32 cast, a float32 tree's
    float64 cast, recomputed from its leaves)."""
    a, q, problem = arm(dtype)
    b = scaled_turned(a)
    params = lt.SolverParams(**PARAMS)

    def fn(tree, q, problem):
        return lt.solve_delta_duals(tree, params, q, problem, fused=False).nu

    step = graphs.jit(fn)
    first = step(a, q, problem)
    n = len(graphs.CAPTURES)
    got_b, got_a = step(b, q, problem), step(a, q, problem)
    assert len(graphs.CAPTURES) == n
    with graphs.disable_graphs():
        want_a, want_b = step(a, q, problem), step(b, q, problem)
    assert torch.equal(first, want_a) and torch.equal(got_a, want_a)
    assert torch.equal(got_b, want_b)
    assert (got_b - want_a).abs().max() > 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_jit_of_astype_reads_the_tree_it_is_given(dtype, fake_graphs):
    """The smallest case: ``tree.astype(float64)`` inside a `jit` function
    (a cast the graph's tree keeps, or the tree itself) is the given tree's,
    not the first tree's."""
    a, q, _ = arm(dtype)
    b = scaled_turned(a)
    step = graphs.jit(lambda tree, q: tree.astype(torch.float64).placement_p.sum() + q.sum())
    step(a, q)
    n = len(graphs.CAPTURES)
    got = step(b, q)
    assert len(graphs.CAPTURES) == n
    with graphs.disable_graphs():
        want = step(b, q)
    assert torch.equal(got, want)
    assert torch.equal(got, b.placement_p.double().sum() + q.sum())
    assert not torch.equal(got, step(a, q))


def _topology(change, tree):
    if change == "name":
        return dataclasses.replace(tree, name="panda_arm_b")
    if change == "joint type":
        return dataclasses.replace(tree, jtypes=tree.jtypes[:-1] + (ttree.PRISMATIC,))
    if change == "float64":
        return tree.to(dtype=torch.float64)
    if change == "axis2":
        return dataclasses.replace(tree, axis2=torch.zeros_like(tree.axis))
    raise KeyError(change)


@pytest.mark.parametrize("change", ["name", "joint type", "float64", "axis2"])
def test_another_topology_misses(change, fake_graphs, standin_loop):
    """A tree whose name, a joint type, dtype or the presence of an
    optional leaf differs is another key: it captures, then replays."""
    a, q, problem = arm()
    params = lt.SolverParams(**PARAMS)
    lt.solve_delta_duals(a, params, q, problem, fused=True)
    n = len(graphs.CAPTURES)
    lt.solve_delta_duals(calibrated(a, 1), params, q, problem, fused=True)
    assert len(graphs.CAPTURES) == n
    other = _topology(change, a)
    lt.solve_delta_duals(other, params, q, problem, fused=True)
    assert len(graphs.CAPTURES) == n + 1, f"another {change} must miss"
    lt.solve_delta_duals(calibrated(other, 2), params, q, problem, fused=True)
    assert len(graphs.CAPTURES) == n + 1


def test_batched_geometry_at_another_batch_misses(fake_graphs, standin_loop):
    """The mixed chain's batched leaves change shape with the batch: a
    fleet of another size is another key; a new chain of the same fleet
    hits (`solve_mixed_padded` replays)."""
    params = lt.SolverParams(**PARAMS)
    lt.parallel.solve_mixed_padded(fleet_groups(), params)
    n = len(graphs.CAPTURES)
    lt.parallel.solve_mixed_padded(fleet_groups(seed=3), params)
    assert len(graphs.CAPTURES) == n
    lt.parallel.solve_mixed_padded(fleet_groups(per=4), params)
    assert len(graphs.CAPTURES) == n + 1
    lt.parallel.solve_mixed_padded(fleet_groups(seed=5, per=4), params)
    assert len(graphs.CAPTURES) == n + 1


def test_graphs_hold_no_tree_and_go_at_clear_graphs(fake_graphs):
    """A graph holds no reference to the trees it was called with: they
    die with their last reference, its casts with them, and the graph
    stays until `clear_graphs()`."""
    a, q, problem = arm(torch.float64)
    b = calibrated(a, 3)
    params = lt.SolverParams(**PARAMS)
    lt.solve_delta_duals(a, params, q, problem, fused=True)
    lt.solve_delta_duals(b, params, q, problem, fused=True)
    held = graphs.cached_graphs()
    assert held == 1
    refs = [weakref.ref(a), weakref.ref(b)]
    ids = [id(a), id(b)]
    del a, b
    gc.collect()
    assert all(r() is None for r in refs)
    assert not any(i in ttree._DERIVED for i in ids)
    assert graphs.cached_graphs() == held
    graphs.clear_graphs()
    assert graphs.cached_graphs() == 0


def test_a_failed_refresh_raises_and_the_next_call_copies_again(fake_graphs, monkeypatch):
    """A call with a new tree whose derived values cannot be recomputed
    raises under the entry point's name; it never runs eagerly, and the
    next call copies that tree in again."""
    a, q, problem = arm(torch.float64)
    b = calibrated(a, 5)
    params = lt.SolverParams(**PARAMS)
    lt.solve_delta_duals(a, params, q, problem, fused=False)
    real = ttree.refresh_derived

    def broken(tree):
        raise RuntimeError("no memory")

    monkeypatch.setattr(graphs, "refresh_derived", broken)
    with pytest.raises(RuntimeError, match="solve_delta_duals: recomputing the graph's casts"):
        lt.solve_delta_duals(b, params, q, problem, fused=False)
    monkeypatch.setattr(graphs, "refresh_derived", real)
    got = lt.solve_delta_duals(b, params, q, problem, fused=False)
    with graphs.disable_graphs():
        want = lt.solve_delta_duals(b, params, q, problem, fused=False)
    assert_bits(got, want)


def three_joint_arm():
    """loik_tpu's tree of a small arm (yaw, pitch, pitch), float32: a short
    compile for loik_tpu's solver."""
    joints = [dict(name="yaw", parent=-1, type=jtree.REVOLUTE, axis=(0, 0, 1)),
              dict(name="shoulder", parent=0, type=jtree.REVOLUTE, xyz=(0, 0, 0.3),
                   axis=(0, 1, 0)),
              dict(name="elbow", parent=1, type=jtree.REVOLUTE, xyz=(0.3, 0, 0),
                   axis=(0, 1, 0))]
    return jtree.make_tree(joints, name="arm3", dtype=jnp.float32)


def test_reference_compiles_once_and_the_port_captures_once(fake_graphs):
    """loik_tpu's `solve_delta_duals` on A and then on a calibrated B
    compiles once (`jax.jit` traces the tree's leaves); the port captures
    once; the port's B result holds against loik_tpu's B within the float32
    budget of tests/test_torch_refine.py."""
    n_prob = 64
    ja = three_joint_arm()
    a = convert.tree_from_arrays(ja, device="cpu")
    b = calibrated(a, seed=21, dp=0.01, deg=2.0)
    jb = convert_back(ja, b)
    A = np.zeros((1, 6, 6))
    A[0, 2, 2] = 1.0
    b_rhs = np.zeros((1, 6))
    b_rhs[0, 2] = 0.2
    jp = jmake_problem(ja, (2,), A=A, b=b_rhs, lb=-4 * np.ones(3), ub=4 * np.ones(3),
                       dtype=jnp.float32)
    tp = convert.problem_from_arrays(jp, device="cpu")
    q = np.random.default_rng(1).uniform(-np.pi, np.pi, (n_prob, 3)).astype(np.float32)
    settings = dict(max_iter=200, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
                    mu_equality_scale_factor=1e5, tail_solve=False, check_interval=8)
    jparams, params = JParams(**settings), lt.SolverParams(**settings)

    compiles = jrefine._delta_duals_jit._cache_size()
    res_ja = jrefine.solve_delta_duals(ja, jparams, jnp.asarray(q), jp, fused=False)
    res_jb = jrefine.solve_delta_duals(jb, jparams, jnp.asarray(q), jp, fused=False)
    assert jrefine._delta_duals_jit._cache_size() == compiles + 1

    n = len(graphs.CAPTURES)
    res_a = lt.solve_delta_duals(a, params, torch.as_tensor(q), tp, fused=False)
    res_b = lt.solve_delta_duals(b, params, torch.as_tensor(q), tp, fused=False)
    assert len(graphs.CAPTURES) == n + 1
    for got, want in ((res_a, res_ja), (res_b, res_jb)):
        ct, cj = got.converged.numpy(), np.asarray(want.converged)
        assert (ct != cj).sum() <= max(1, n_prob // 100)
        both = ct & cj
        assert both.mean() > 0.5
        nu_err = np.abs(got.nu.numpy()[both] - np.asarray(want.nu)[both]).max()
        assert nu_err <= 2e-5, nu_err
        d_it = got.iterations.numpy().astype(int) - np.asarray(want.iterations).astype(int)
        assert np.abs(d_it).max() <= settings["check_interval"]
    assert np.abs(np.asarray(res_jb.nu) - np.asarray(res_ja.nu)).max() > 1e-3


def convert_back(jtree_, tree):
    """loik_tpu's tree ``jtree_`` with the placements and axes of the
    port's ``tree`` (of its topology)."""
    out = dataclasses.replace(jtree_, placement_p=jnp.asarray(tree.placement_p.numpy()),
                              axis=jnp.asarray(tree.axis.numpy()))
    assert torch.equal(convert.tree_from_arrays(out, device="cpu").axis, tree.axis)
    return out
