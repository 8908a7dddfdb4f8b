"""The port's joint zoo against loik_tpu: for every joint type, one tree
built by both packages' `make_tree` from the same dicts (the joint under
test on a revolute parent, with a revolute child) is compared in its static
fields and leaves (equal), `joint_S`, `fwd_kinematics`, `neutral` and
`integrate` (1e-12 in float64; constant subspaces equal).  Also composite
expansion, the URDF loader's joint types, `floating_base` and both mimic
policies, the builders, and `solve` on trees with configuration-dependent
subspaces (f64, nu within 1e-9, flags and iteration counts equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu.model import builders as jbuilders
from loik_tpu.model import tree as jtree
from loik_tpu.model.urdf import load_urdf as jload_urdf
from loik_tpu.params import SolverParams as JParams
from loik_tpu.problem import make_problem as jmake_problem
from loik_tpu.solver import solve as jsolve
from loik_tpu_torch import convert
from loik_tpu_torch.model import builders as tbuilders
from loik_tpu_torch.model import tree as ttree

from tests.test_torch_model import LEAVES, STATIC

TYPE_NAMES = ["REVOLUTE", "PRISMATIC", "FREE_FLYER", "SPHERICAL", "REVOLUTE_UNBOUNDED",
              "TRANSLATION", "PLANAR", "UNIVERSAL", "HELICAL", "SPHERICAL_ZYX",
              "MIMIC_PAIR"]


def _joint(t, name, parent):
    j = dict(name=name, parent=parent, type=t, xyz=(0.1, -0.2, 0.3), rpy=(0.3, -0.5, 0.7),
             axis=(0.36, 0.48, 0.8), axis2=(0.8, 0.0, 0.6), pitch=0.12, velocity_limit=3.0)
    if t == jtree.MIMIC_PAIR:
        j.update(mimic=(jtree.REVOLUTE, jtree.PRISMATIC, -1.3, 0.2), xyz2=(0.05, 0.1, -0.1),
                 rpy2=(0.2, 0.4, -0.6))
    return j


def _chain(t):
    """revolute -> the joint under test -> revolute."""
    return [_joint(jtree.REVOLUTE, "base", -1), _joint(t, "mid", 0),
            _joint(jtree.REVOLUTE, "tip", 1)]


def _both(joints, name="zoo"):
    return (jtree.make_tree([dict(j) for j in joints], name=name),
            ttree.make_tree([dict(j) for j in joints], name=name, device="cpu"))


def _same_tree(tt, jt):
    for name in LEAVES:
        a, b = getattr(tt, name), getattr(jt, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for name in STATIC:
        assert getattr(tt, name) == getattr(jt, name), name


def _q(jt, B=6, seed=0):
    return np.array(jt.random_configuration(jax.random.PRNGKey(seed), (B,)))


def test_joint_codes_equal_the_reference():
    for name in TYPE_NAMES:
        assert getattr(ttree, name) == getattr(jtree, name), name
    assert ttree.JOINT_NV == jtree.JOINT_NV and ttree.JOINT_NQ == jtree.JOINT_NQ
    assert ttree.COMPOSITE == jtree.COMPOSITE


@pytest.mark.parametrize("tname", TYPE_NAMES)
def test_make_tree_static_fields(tname):
    jt, tt = _both(_chain(getattr(jtree, tname)))
    _same_tree(tt, jt)


@pytest.mark.parametrize("tname", TYPE_NAMES)
def test_joint_S_per_type(tname):
    jt, tt = _both(_chain(getattr(jtree, tname)))
    q = _q(jt)
    if jt.has_q_dependent_S:
        with pytest.raises(ValueError, match="depends on the configuration"):
            tt.joint_S(1)
        np.testing.assert_allclose(tt.joint_S(1, torch.as_tensor(q)).numpy(),
                                   np.asarray(jt.joint_S(1, jnp.asarray(q))), atol=1e-12)
        # an unbatched q gives the padded stack
        np.testing.assert_allclose(tt.joint_S_padded(torch.as_tensor(q[0])).numpy(),
                                   np.asarray(jt.joint_S_padded(jnp.asarray(q[0]))),
                                   atol=1e-12)
    else:
        np.testing.assert_array_equal(tt.joint_S(1).numpy(), np.asarray(jt.joint_S(1)))
        np.testing.assert_array_equal(tt.joint_S_padded().numpy(),
                                      np.asarray(jt.joint_S_padded()))


@pytest.mark.parametrize("tname", TYPE_NAMES)
def test_fwd_kinematics_per_type(tname):
    jt, tt = _both(_chain(getattr(jtree, tname)))
    q = _q(jt, seed=1)
    for g, w in zip(tt.fwd_kinematics(torch.as_tensor(q)), jt.fwd_kinematics(jnp.asarray(q))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    # unbatched q
    for g, w in zip(tt.fwd_kinematics(torch.as_tensor(q[0])),
                    jt.fwd_kinematics(jnp.asarray(q[0]))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


@pytest.mark.parametrize("tname", TYPE_NAMES)
def test_neutral_and_integrate_per_type(tname):
    jt, tt = _both(_chain(getattr(jtree, tname)))
    np.testing.assert_array_equal(tt.neutral().numpy(), np.asarray(jt.neutral()))
    q = _q(jt, seed=2)
    dq = np.random.default_rng(3).uniform(-1.0, 1.0, (6, jt.nv))
    dq[0] *= 1e-6                      # the Taylor branches
    dq[1] = 0.0
    want = np.asarray(jt.integrate(jnp.asarray(q), jnp.asarray(dq)))
    got = tt.integrate(torch.as_tensor(q), torch.as_tensor(dq)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[1], q[1], rtol=0, atol=1e-15)


@pytest.mark.parametrize("tname", TYPE_NAMES)
def test_subspace_is_the_derivative_of_the_configuration_map(tname):
    """d/dt M(integrate(q, t dq))|_0 == S(q) dq in the joint's local frame:
    the property the solver's recursion v_i = X^-1 v_parent + S nu rests on."""
    t = getattr(ttree, tname)
    tree = ttree.make_tree([_joint(t, "j", -1)], device="cpu")
    gen = torch.Generator().manual_seed(t)
    q = tree.random_configuration((), generator=gen)
    dq = 2.0 * torch.rand(tree.nv, generator=gen, dtype=torch.float64) - 1.0
    h = 1e-6
    R0, p0 = tree.joint_calc(0, q)
    R1, p1 = tree.joint_calc(0, tree.integrate(q, h * dq))
    lin = R0.T @ (p1 - p0) / h
    dR = R0.T @ R1
    ang = torch.stack([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / (2 * h)
    v = tree.joint_S(0, q) @ dq
    np.testing.assert_allclose(torch.cat([lin, ang]).numpy(), v.numpy(), atol=2e-6)


def test_composite_expansion_matches_reference():
    joints = [
        _joint(jtree.REVOLUTE, "base", -1),
        dict(name="wrist", parent=0, type=jtree.COMPOSITE, xyz=(0.2, 0, 0.1), rpy=(0.1, 0.2, 0.3),
             sub=[dict(type=jtree.TRANSLATION),
                  dict(type=jtree.COMPOSITE, xyz=(0, 0.1, 0),
                       sub=[dict(type=jtree.REVOLUTE, axis=(1, 0, 0)),
                            dict(type=jtree.SPHERICAL, name="ball")])]),
        _joint(jtree.PRISMATIC, "tip", 1),
    ]
    jt, tt = _both(joints, name="composite")
    _same_tree(tt, jt)
    assert tt.njoints == 5 and tt.parents == (-1, 0, 1, 2, 3)
    assert tt.joint_names[1:4] == ("wrist/0", "wrist/1/0", "ball")
    q = _q(jt)
    for g, w in zip(tt.fwd_kinematics(torch.as_tensor(q)), jt.fwd_kinematics(jnp.asarray(q))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="has no subs"):
        ttree.make_tree([dict(name="c", parent=-1, type=ttree.COMPOSITE, sub=[])], device="cpu")
    # a parent that comes later is refused (by the expansion's index map, as
    # in the reference)
    for make in (jtree.make_tree, lambda j: ttree.make_tree(j, device="cpu")):
        with pytest.raises(KeyError):
            make([_joint(ttree.REVOLUTE, "a", 1)])


# --------------------------------------------------------------------------- #
# URDF
# --------------------------------------------------------------------------- #

URDF_EXTRA = {"universal": '<axis2 xyz="0 1 0"/>', "helical": '<pitch value="0.07"/>'}


def _urdf(mid_type):
    return f"""<robot name="r">
      <link name="a"/><link name="b"/><link name="c"/><link name="d"/><link name="e"/>
      <joint name="j1" type="revolute"><parent link="a"/><child link="b"/>
        <origin xyz="0 0 0.3" rpy="0.1 0.2 0.3"/><axis xyz="0 0 2"/>
        <limit velocity="2.5"/></joint>
      <joint name="j2" type="{mid_type}"><parent link="b"/><child link="c"/>
        <origin xyz="0.1 0 0" rpy="0 0.5 0"/><axis xyz="0 1 0"/>
        {URDF_EXTRA.get(mid_type, "")}<limit velocity="1.5"/></joint>
      <joint name="fix" type="fixed"><parent link="c"/><child link="d"/>
        <origin xyz="0 0.2 0" rpy="0.3 0 0"/></joint>
      <joint name="j3" type="prismatic"><parent link="d"/><child link="e"/>
        <axis xyz="1 0 0"/></joint>
    </robot>"""


@pytest.mark.parametrize("urdf_type", ["continuous", "floating", "planar", "spherical",
                                       "translation", "universal", "helical",
                                       "spherical_zyx"])
def test_urdf_joint_types(urdf_type):
    jt = jload_urdf(_urdf(urdf_type))
    tt = lt.load_urdf(_urdf(urdf_type), device="cpu")
    _same_tree(tt, jt)
    assert tt.njoints == 3
    q = _q(jt)
    for g, w in zip(tt.fwd_kinematics(torch.as_tensor(q)), jt.fwd_kinematics(jnp.asarray(q))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_urdf_floating_base(dtype):
    jt = jload_urdf(_urdf("revolute"), floating_base=True, dtype=jnp.dtype(dtype))
    tt = lt.load_urdf(_urdf("revolute"), floating_base=True, dtype=getattr(torch, dtype),
                      device="cpu")
    _same_tree(tt, jt)
    assert tt.jtypes[0] == ttree.FREE_FLYER and tt.joint_names[0] == "root_joint"
    assert tt.nv == 9 and tt.nq == 10 and tt.dtype == getattr(torch, dtype)


MIMIC_URDF = """<robot name="finger">
  <link name="palm"/><link name="p1"/><link name="p2"/><link name="tipframe"/>
  <joint name="knuckle" type="revolute"><parent link="palm"/><child link="p1"/>
    <axis xyz="0 1 0"/><limit velocity="2.0"/></joint>
  <joint name="distal" type="revolute"><parent link="p1"/><child link="p2"/>
    <origin xyz="0.04 0 0" rpy="0 0 0.1"/><axis xyz="0 1 0"/><limit velocity="3.0"/>
    <mimic joint="knuckle" multiplier="0.8" offset="0.05"/></joint>
  <joint name="tool" type="fixed"><parent link="p1"/><child link="tipframe"/></joint>
</robot>"""


def test_urdf_mimic_policies():
    with pytest.raises(ValueError, match="pass mimic='reduce'"):
        lt.load_urdf(MIMIC_URDF, device="cpu")
    jt = jload_urdf(MIMIC_URDF, mimic="reduce")
    tt = lt.load_urdf(MIMIC_URDF, mimic="reduce", device="cpu")
    _same_tree(tt, jt)
    assert tt.jtypes == (ttree.MIMIC_PAIR,) and tt.nv == 1
    assert tt.mimic == ((ttree.REVOLUTE, ttree.REVOLUTE, 0.8, 0.05),)
    assert float(tt.velocity_limit[0]) == 2.0
    q = _q(jt)
    for g, w in zip(tt.fwd_kinematics(torch.as_tensor(q)), jt.fwd_kinematics(jnp.asarray(q))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tt.joint_S(0, torch.as_tensor(q)).numpy(),
                               np.asarray(jt.joint_S(0, jnp.asarray(q))), atol=1e-12)


@pytest.mark.parametrize("edit,match", [
    (lambda u: u.replace('<parent link="p1"/><child link="p2"/>',
                         '<parent link="palm"/><child link="p2"/>'), "not serial-adjacent"),
    (lambda u: u.replace('joint="knuckle"', 'joint="nothing"'), "unknown joint"),
    (lambda u: u.replace('name="knuckle" type="revolute"', 'name="knuckle" type="continuous"'),
     "revolute/prismatic pairs"),
    (lambda u: u.replace('type="fixed"', 'type="revolute"'), "not serial-adjacent"),
])
def test_urdf_mimic_reduction_refusals(edit, match):
    with pytest.raises(ValueError, match=match):
        lt.load_urdf(edit(MIMIC_URDF), mimic="reduce", device="cpu")


def test_urdf_errors():
    two_roots = """<robot name="r"><link name="a"/><link name="b"/><link name="c"/>
      <joint name="j" type="revolute"><parent link="a"/><child link="b"/></joint></robot>"""
    with pytest.raises(ValueError, match="single root link"):
        lt.load_urdf(two_roots, device="cpu")
    with pytest.raises(ValueError, match="unsupported joint type gearbox"):
        lt.load_urdf(_urdf("gearbox"), device="cpu")


# --------------------------------------------------------------------------- #
# builders
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("tname", ["REVOLUTE", "PRISMATIC", "SPHERICAL"])
def test_serial_chain(tname):
    t = getattr(jtree, tname)
    _same_tree(tbuilders.serial_chain(5, t, device="cpu"), jbuilders.serial_chain(5, t))


@pytest.mark.parametrize("kw", [
    dict(n_joints=9),
    dict(n_joints=7, floating_base=True, allow_spherical=True),
    dict(n_joints=6, force_spherical=True, allow_prismatic=False),
    dict(n_joints=10, force_types=(jtree.PLANAR, jtree.TRANSLATION, jtree.REVOLUTE_UNBOUNDED,
                                   jtree.UNIVERSAL, jtree.HELICAL, jtree.SPHERICAL_ZYX,
                                   jtree.MIMIC_PAIR)),
], ids=["plain", "floating", "spherical", "broadened"])
def test_random_tree(kw):
    """One seed gives the same tree in both packages (the builders draw from
    the numpy generator in the same order)."""
    jt = jbuilders.random_tree(np.random.default_rng(4), **kw)
    tt = tbuilders.random_tree(np.random.default_rng(4), device="cpu", **kw)
    _same_tree(tt, jt)
    q = _q(jt)
    for g, w in zip(tt.fwd_kinematics(torch.as_tensor(q)), jt.fwd_kinematics(jnp.asarray(q))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


# --------------------------------------------------------------------------- #
# the solver on every D-block size and on configuration-dependent subspaces
# --------------------------------------------------------------------------- #

PARAMS = dict(max_iter=150, tol_abs=1e-6, tol_rel=1e-6)


@pytest.mark.parametrize("tname", ["FREE_FLYER", "SPHERICAL", "TRANSLATION", "PLANAR",
                                   "UNIVERSAL", "HELICAL", "SPHERICAL_ZYX", "MIMIC_PAIR"])
def test_solve_f64_per_joint_type(tname):
    """`solve` on the three-joint chain around each multi-dof or
    configuration-dependent type: D blocks of 1, 2, 3 and 6 dofs, `S_list`
    from q where S depends on it.  nu within 1e-9, flags and counts equal."""
    jt, tt = _both(_chain(getattr(jtree, tname)))
    # a task the chain can reach: the tip's linear velocity, or only its z
    # component where the chain has three dofs about one axis
    rows = 3 if jt.nv >= 4 else 1
    A = np.zeros((1, 6, 6))
    A[0, :rows, 3 - rows:3] = np.eye(rows)
    b = np.zeros((1, 6))
    b[0, :rows] = (0.05, -0.02, 0.1)[3 - rows:]
    jp = jmake_problem(jt, (2,), A=A, b=b, lb=-3 * np.ones(jt.nv), ub=3 * np.ones(jt.nv))
    tp = convert.problem_from_arrays(jp, device="cpu")
    q = _q(jt, B=8, seed=5)
    res_j = jsolve(jt, JParams(**PARAMS), jnp.asarray(q), jp)
    res_t = lt.solve(tt, lt.SolverParams(**PARAMS), torch.as_tensor(q), tp)
    for name in ("converged", "primal_infeasible", "dual_infeasible", "iterations"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                      np.asarray(getattr(res_j, name)), err_msg=name)
    assert not res_t.dual_infeasible.any()
    np.testing.assert_allclose(res_t.nu.numpy(), np.asarray(res_j.nu), rtol=0, atol=1e-9)
    assert res_t.converged.any()
    assert (res_t.state is not None) and res_t.nu.shape == (8, jt.nv)


def test_delta_duals_refuses_q_dependent_subspaces():
    tt = lt.robots.mobile_ur5("float32", device="cpu")
    problem = lt.make_problem(tt, (6,))
    with pytest.raises(ValueError, match="constant motion subspaces only"):
        lt.solve_delta_duals(tt, lt.SolverParams(), tt.neutral()[None], problem)
    # DiffIkSolver.solve_refined takes the two-stage path there instead; a
    # kernel it is told to require is refused by name
    with pytest.raises(ValueError, match="configuration-dependent motion subspaces"):
        lt.DiffIkSolver(tt, lt.SolverParams(), (6,), fused="require").solve_refined(
            tt.neutral()[None])
