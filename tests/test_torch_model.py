"""loik_tpu_torch model layer against loik_tpu: tree leaves, FK, the URDF
asset and the joint types the port refuses.

Also holds the pairing helpers the other `test_torch_*` files import: one
robot and one problem built in the JAX package and carried across with
`loik_tpu_torch.convert`, so both packages compute on the same leaves.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu.model import robots as jrobots
from loik_tpu.problem import make_problem as jmake_problem
from loik_tpu.solver.solve import fwd_pass_init as jfwd_pass_init
from loik_tpu_torch import convert
from loik_tpu_torch.model import tree as ttree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the flagship problem's settings (bench.py:42-53, 601-704)
FLAGSHIP = dict(max_iter=200, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
                mu_equality_scale_factor=1e5, tail_solve=False,
                check_interval=8)


def pair(robot="panda_arm", dtype="float64", b3=0.2):
    """(jax tree, port tree, jax problem, port problem) for the flagship
    task: a 6-D constraint at the last joint, v_z = b3, box bounds +-4."""
    jt = jrobots.get(robot, dtype)
    b = np.zeros((1, 6))
    b[0, 2] = b3
    jp = jmake_problem(jt, (jt.njoints - 1,), b=b, lb=-4 * np.ones(jt.nv),
                       ub=4 * np.ones(jt.nv), dtype=jnp.dtype(dtype))
    return jt, convert.tree_from_arrays(jt), jp, convert.problem_from_arrays(jp)


def q_batch(tree, B, seed, dtype="float64"):
    """B configurations uniform in [-pi, pi], from numpy."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-np.pi, np.pi, (B, tree.nq)).astype(dtype)


def shared_fk(jt, q):
    """loik_tpu's FK of q in the solver layout, as port tensors: lets a test
    feed both packages bit-identical kinematics (XLA's sin/cos and 3x3
    products differ from PyTorch's by ulps)."""
    R, p = jfwd_pass_init(jt, jnp.asarray(q))
    return torch.as_tensor(np.array(R)), torch.as_tensor(np.array(p))


@pytest.mark.parametrize("robot", ["panda", "panda_arm"])
def test_tree_matches_reference(robot):
    jt = jrobots.get(robot)
    tt = lt.robots.get(robot)
    for name in ("placement_R", "placement_p", "axis", "velocity_limit"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), err_msg=name)
    for name in ("parents", "jtypes", "idx_v", "idx_q", "joint_names", "name",
                 "njoints", "nv", "nq", "nvs", "nv_max", "padded_to_flat"):
        assert getattr(tt, name) == getattr(jt, name), name
    assert tt.dtype == torch.float64 and tt.device.type == "cpu"


@pytest.mark.parametrize("robot", ["panda", "panda_arm"])
def test_fwd_kinematics_f64(robot):
    jt = jrobots.get(robot)
    tt = lt.robots.get(robot)
    q = q_batch(jt, 16, seed=1)
    want = jt.fwd_kinematics(jnp.asarray(q))
    got = tt.fwd_kinematics(torch.as_tensor(q))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    # the solver layout (trailing batch) of the same FK
    R, p = lt.solver.fwd_pass_init(tt, torch.as_tensor(q))
    np.testing.assert_allclose(R.numpy(), np.moveaxis(np.asarray(want[0]), 0, -1),
                               atol=1e-12)
    np.testing.assert_allclose(p.numpy(), np.moveaxis(np.asarray(want[1]), 0, -1),
                               atol=1e-12)


def test_urdf_asset_copy_is_byte_identical():
    assert filecmp.cmp(
        os.path.join(REPO, "loik_tpu", "model", "assets", "panda.urdf"),
        os.path.join(REPO, "loik_tpu_torch", "model", "assets", "panda.urdf"),
        shallow=False,
    )


@pytest.mark.parametrize("urdf_type", ["continuous", "floating", "planar", "spherical"])
def test_urdf_unsupported_joint_type_raises(urdf_type):
    urdf = f"""<robot name="r">
      <link name="a"/><link name="b"/>
      <joint name="j" type="{urdf_type}"><parent link="a"/><child link="b"/></joint>
    </robot>"""
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
        lt.load_urdf(urdf)


def test_urdf_mimic_raises():
    urdf = """<robot name="r">
      <link name="a"/><link name="b"/><link name="c"/>
      <joint name="j1" type="revolute"><parent link="a"/><child link="b"/></joint>
      <joint name="j2" type="revolute"><parent link="b"/><child link="c"/>
        <mimic joint="j1"/></joint>
    </robot>"""
    with pytest.raises(ValueError, match="mimic"):
        lt.load_urdf(urdf)


@pytest.mark.parametrize("jtype", [2, 3, 4, 7])
def test_unsupported_joint_code_raises(jtype):
    tt = lt.robots.panda_arm()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
        ttree.KinematicTree(
            tt.placement_R, tt.placement_p, tt.axis, tt.velocity_limit,
            parents=tt.parents, jtypes=(jtype,) + tt.jtypes[1:], idx_v=tt.idx_v,
            idx_q=tt.idx_q, joint_names=tt.joint_names)


@pytest.mark.parametrize("robot", ["ur5", "solo12", "talos"])
def test_unported_robots_raise(robot):
    with pytest.raises(NotImplementedError):
        lt.robots.get(robot)


def test_convert_refuses_unported_joint_types():
    with pytest.raises(NotImplementedError):
        convert.tree_from_arrays(jrobots.solo12())


def test_random_configuration_generator():
    tt = lt.robots.panda_arm("float32")
    q1 = tt.random_configuration((64,), generator=torch.Generator().manual_seed(3))
    q2 = tt.random_configuration((64,), generator=torch.Generator().manual_seed(3))
    assert torch.equal(q1, q2)
    assert q1.shape == (64, 7) and q1.dtype == torch.float32
    assert float(q1.abs().max()) <= np.pi


def test_neutral_integrate_and_to():
    tt = lt.robots.panda()
    q = tt.neutral()
    assert torch.equal(q, torch.zeros(9, dtype=torch.float64))
    dq = torch.linspace(-1, 1, 9, dtype=torch.float64)
    assert torch.equal(tt.integrate(q, dq), dq)
    t32 = tt.to(dtype=torch.float32)
    assert t32.dtype == torch.float32 and t32.astype(torch.float64).dtype == torch.float64
    assert t32.parents == tt.parents
    # neutral FK: the panda_arm joint-7 origin sits at [0.088, 0, 0.333+0.316+0.384]
    _, _, _, op = lt.robots.panda_arm().fwd_kinematics(torch.zeros(7, dtype=torch.float64))
    np.testing.assert_allclose(op[6].numpy(), [0.088, 0.0, 1.033], atol=1e-12)


@pytest.mark.parametrize("robot", ["panda", "panda_arm"])
def test_joint_S_matches_reference(robot):
    jt = jrobots.get(robot)
    tt = lt.robots.get(robot)
    for i in range(jt.njoints):
        np.testing.assert_array_equal(tt.joint_S(i).numpy(), np.asarray(jt.joint_S(i)))
