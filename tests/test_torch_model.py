"""loik_tpu_torch model layer against loik_tpu: tree leaves, FK, motion
subspaces, neutral and integrate for every robot of the registry, the URDF
assets, and the constructors' device default.

Also holds the pairing helpers the other `test_torch_*` files import: one
robot and one problem built in the JAX package and carried across with
`loik_tpu_torch.convert`, so both packages compute on the same leaves.
"""

import filecmp
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu.model import robots as jrobots
from loik_tpu.problem import make_problem as jmake_problem
from loik_tpu.solver.solve import fwd_pass_init as jfwd_pass_init
from loik_tpu_torch import convert
from loik_tpu_torch.model import builders as tbuilders
from loik_tpu_torch.model import tree as ttree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the flagship problem's settings (bench.py:42-53, 601-704)
FLAGSHIP = dict(max_iter=200, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
                mu_equality_scale_factor=1e5, tail_solve=False,
                check_interval=8)


ROBOTS = ["panda", "panda_arm", "ur5", "solo12", "talos", "talos_like", "mobile_ur5"]

# the legged robots' settings (bench.py:55-101, 687-701): solo12 checks every
# 4th iteration, talos every iteration
LEGGED = dict(max_iter=200, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
              mu_equality_scale_factor=1e5, tail_solve=False)
LEGGED_K = {"solo12": 4, "talos": 1}


def _skew(r):
    return np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0.0]])


def pair(robot="panda_arm", dtype="float64", b3=0.2):
    """(jax tree, port tree, jax problem, port problem).  For solo12 and
    talos the task of bench.py's configuration of that name (solo12: a base
    twist command and four point-foot constraints, box +-12; talos: a
    gripper heave with the base held, box +-4); for every other robot the
    flagship task: a 6-D constraint at the last joint (mobile_ur5: the arm's
    last joint, the head cannot heave), v_z = b3, box +-4."""
    jt = jrobots.get(robot, dtype)
    if robot == "solo12":
        links = (0,) + jt.leaf_joints
        A = np.zeros((5, 6, 6))
        A[0] = np.eye(6)
        for k in range(1, 5):
            A[k, :3, :3] = np.eye(3)
            A[k, :3, 3:] = -_skew([0.0, 0.0, -0.16])
        b = np.zeros((5, 6))
        b[0, 2] = 0.1
        jp = jmake_problem(jt, links, A=A, b=b, lb=-12 * np.ones(jt.nv),
                           ub=12 * np.ones(jt.nv), dtype=jnp.dtype(dtype))
    elif robot == "talos":
        b = np.zeros((2, 6))
        b[0, 2] = 0.2
        jp = jmake_problem(jt, (jt.joint_names.index("gripper_left_joint"), 0), b=b,
                           lb=-4 * np.ones(jt.nv), ub=4 * np.ones(jt.nv),
                           dtype=jnp.dtype(dtype))
    else:
        b = np.zeros((1, 6))
        b[0, 2] = b3
        link = jt.joint_names.index("wrist_3_joint") if robot == "mobile_ur5" else jt.njoints - 1
        jp = jmake_problem(jt, (link,), b=b, lb=-4 * np.ones(jt.nv),
                           ub=4 * np.ones(jt.nv), dtype=jnp.dtype(dtype))
    return (jt, convert.tree_from_arrays(jt, device="cpu"), jp,
            convert.problem_from_arrays(jp, device="cpu"))


def q_batch(tree, B, seed, dtype="float64"):
    """B configurations from numpy: every entry uniform in [-pi, pi] (FK
    normalizes quaternion and cos/sin blocks), except solo12, which gets
    bench.py's stance sampler: the bent-knee configuration moved by
    0.3 U(-1, 1) on the manifold (loik_tpu's `integrate`)."""
    rng = np.random.default_rng(seed)
    if tree.name == "solo12":
        jt = jrobots.solo12("float64")
        q0 = np.asarray(jt.neutral()).copy()
        q0[7:] = [0, 0.8, -1.6] * 2 + [0, -0.8, 1.6] * 2
        dq = 0.3 * rng.uniform(-1.0, 1.0, (B, jt.nv))
        q = jax.vmap(lambda d: jt.integrate(jnp.asarray(q0), d))(jnp.asarray(dq))
        return np.asarray(q).astype(dtype)
    return rng.uniform(-np.pi, np.pi, (B, tree.nq)).astype(dtype)


def shared_fk(jt, q):
    """loik_tpu's FK of q in the solver layout, as port tensors: lets a test
    feed both packages bit-identical kinematics (XLA's sin/cos and 3x3
    products differ from PyTorch's by ulps)."""
    R, p = jfwd_pass_init(jt, jnp.asarray(q))
    return torch.as_tensor(np.array(R)), torch.as_tensor(np.array(p))


def _leaf_equal(got, want, name):
    assert (got is None) == (want is None), name
    if got is not None:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


LEAVES = ("placement_R", "placement_p", "axis", "velocity_limit", "axis2",
          "placement2_R", "placement2_p")
STATIC = ("parents", "jtypes", "idx_v", "idx_q", "joint_names", "name", "pitches",
          "mimic", "njoints", "nv", "nq", "nvs", "nv_max", "padded_to_flat", "depth",
          "leaf_joints", "dof_joint", "has_q_dependent_S")


@pytest.mark.parametrize("robot", ROBOTS)
def test_tree_matches_reference(robot):
    jt = jrobots.get(robot)
    tt = lt.robots.get(robot, device="cpu")
    for name in LEAVES:
        _leaf_equal(getattr(tt, name), getattr(jt, name), name)
    for name in STATIC:
        assert getattr(tt, name) == getattr(jt, name), name
    assert tt.children(0) == jt.children(0)
    np.testing.assert_array_equal(tt.dof_mask_padded().numpy(),
                                  np.asarray(jt.dof_mask_padded()))
    assert tt.dtype == torch.float64 and tt.device.type == "cpu"
    # cached per (dtype, device), like the reference's per dtype
    assert lt.robots.get(robot, device="cpu") is tt


@pytest.mark.parametrize("robot", ROBOTS)
def test_fwd_kinematics_f64(robot):
    jt = jrobots.get(robot)
    tt = lt.robots.get(robot, device="cpu")
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


@pytest.mark.parametrize("asset", ["panda.urdf", "talos.urdf"])
def test_urdf_asset_copy_is_byte_identical(asset):
    assert filecmp.cmp(
        os.path.join(REPO, "loik_tpu", "model", "assets", asset),
        os.path.join(REPO, "loik_tpu_torch", "model", "assets", asset),
        shallow=False,
    )


@pytest.mark.parametrize("asset", ["panda.urdf", "talos.urdf"])
def test_urdf_asset_is_package_data(asset):
    """The robots read their URDF from the package's own `assets/` folder,
    which pyproject.toml ships as package data of `loik_tpu_torch.model`."""
    from loik_tpu_torch.model import robots as trobots

    path = os.path.join(trobots._ASSETS, asset)
    assert os.path.isfile(path)
    assert os.path.dirname(trobots._ASSETS) == os.path.dirname(trobots.__file__)
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        assert '"loik_tpu_torch.model" = ["assets/*.urdf"]' in f.read()


def test_urdf_mimic_raises():
    urdf = """<robot name="r">
      <link name="a"/><link name="b"/><link name="c"/>
      <joint name="j1" type="revolute"><parent link="a"/><child link="b"/></joint>
      <joint name="j2" type="revolute"><parent link="b"/><child link="c"/>
        <mimic joint="j1"/></joint>
    </robot>"""
    with pytest.raises(ValueError, match="mimic"):
        lt.load_urdf(urdf, device="cpu")


@pytest.mark.parametrize("robot", ["solo12", "talos", "mobile_ur5"])
def test_convert_tree_round_trip(robot):
    """A reference tree carried across equals the port's own robot, leaf for
    leaf and in every static field."""
    got = convert.tree_from_arrays(jrobots.get(robot), device="cpu")
    want = lt.robots.get(robot, device="cpu")
    for name in LEAVES:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        assert a is None or torch.equal(a, b), name
    for name in STATIC:
        assert getattr(got, name) == getattr(want, name), name
    t32 = convert.tree_from_arrays(jrobots.get(robot), device="cpu", dtype=torch.float32)
    assert t32.dtype == torch.float32 and t32.parents == want.parents


def test_unknown_joint_code_raises():
    tt = lt.robots.panda_arm(device="cpu")
    with pytest.raises(ValueError, match="unknown type code 42"):
        ttree.KinematicTree(
            tt.placement_R, tt.placement_p, tt.axis, tt.velocity_limit,
            parents=tt.parents, jtypes=(42,) + tt.jtypes[1:], idx_v=tt.idx_v,
            idx_q=tt.idx_q, joint_names=tt.joint_names)


@pytest.mark.parametrize("fn", [
    lt.robots.panda, lt.robots.panda_arm, lt.robots.ur5, lt.robots.solo12,
    lt.robots.talos, lt.robots.talos_like, lt.robots.mobile_ur5, lt.robots.get,
    lt.load_urdf, lt.make_tree, tbuilders.serial_chain, tbuilders.random_tree,
    convert.tree_from_arrays, convert.problem_from_arrays, convert.state_from_arrays,
], ids=lambda f: f"{f.__module__.rsplit('.', 1)[-1]}.{f.__name__}")
def test_constructors_default_to_the_card(fn):
    """Whatever makes tensors from nothing takes device=None, and None is
    the CUDA device (no probing, no fallback to the CPU)."""
    fn = getattr(fn, "__wrapped__", fn)          # through lru_cache
    assert inspect.signature(fn).parameters["device"].default is None
    assert ttree.resolve_device(None) == torch.device("cuda")
    assert ttree.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("robot", ROBOTS)
def test_random_configuration_generator(robot):
    tt = lt.robots.get(robot, "float32", device="cpu")
    q1 = tt.random_configuration((64,), generator=torch.Generator().manual_seed(3))
    q2 = tt.random_configuration((64,), generator=torch.Generator().manual_seed(3))
    assert torch.equal(q1, q2)
    assert q1.shape == (64, tt.nq) and q1.dtype == torch.float32
    assert float(q1.abs().max()) <= np.pi
    for i, t in enumerate(tt.jtypes):     # unit quaternions and (cos, sin) pairs
        iq = tt.idx_q[i]
        block = {ttree.FREE_FLYER: q1[:, iq + 3: iq + 7], ttree.SPHERICAL: q1[:, iq: iq + 4],
                 ttree.REVOLUTE_UNBOUNDED: q1[:, iq: iq + 2],
                 ttree.PLANAR: q1[:, iq + 2: iq + 4]}.get(t)
        if block is not None:
            np.testing.assert_allclose(block.norm(dim=-1).numpy(), 1.0, atol=1e-6)
        if t == ttree.FREE_FLYER:
            assert float(q1[:, iq: iq + 3].abs().max()) <= 1.0


@pytest.mark.parametrize("robot", ROBOTS)
def test_neutral_and_integrate_match_reference(robot):
    jt = jrobots.get(robot)
    tt = lt.robots.get(robot, device="cpu")
    np.testing.assert_array_equal(tt.neutral().numpy(), np.asarray(jt.neutral()))
    rng = np.random.default_rng(5)
    q = np.array(jt.random_configuration(jax.random.PRNGKey(0), (8,)))
    dq = rng.uniform(-0.5, 0.5, (8, jt.nv))
    dq[0] = 1e-6 * dq[0]          # the small-angle branches of exp3 / exp6 / exp2
    want = np.asarray(jt.integrate(jnp.asarray(q), jnp.asarray(dq)))
    got = tt.integrate(torch.as_tensor(q), torch.as_tensor(dq)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # an unbatched q broadcasts against a batch of steps
    one = tt.integrate(torch.as_tensor(q[0]), torch.as_tensor(dq)).numpy()
    np.testing.assert_allclose(one[3], np.asarray(jt.integrate(jnp.asarray(q[0]),
                                                               jnp.asarray(dq[3]))), atol=1e-12)


def test_neutral_integrate_and_to():
    tt = lt.robots.panda(device="cpu")
    q = tt.neutral()
    assert torch.equal(q, torch.zeros(9, dtype=torch.float64))
    dq = torch.linspace(-1, 1, 9, dtype=torch.float64)
    assert torch.equal(tt.integrate(q, dq), dq)
    t32 = tt.to(dtype=torch.float32)
    assert t32.dtype == torch.float32 and t32.astype(torch.float64).dtype == torch.float64
    assert t32.parents == tt.parents
    assert tt.to(dtype=torch.float64) is tt and tt.to("cpu") is tt
    m32 = lt.robots.mobile_ur5(device="cpu").astype(torch.float32)
    assert m32.axis2.dtype == torch.float32
    # neutral FK: the panda_arm joint-7 origin sits at [0.088, 0, 0.333+0.316+0.384]
    _, _, _, op = lt.robots.panda_arm(device="cpu").fwd_kinematics(
        torch.zeros(7, dtype=torch.float64))
    np.testing.assert_allclose(op[6].numpy(), [0.088, 0.0, 1.033], atol=1e-12)


@pytest.mark.parametrize("robot", ROBOTS)
def test_joint_S_matches_reference(robot):
    """Constant subspaces equal; configuration-dependent ones (mobile_ur5's
    universal head) within 1e-12, batched over q."""
    jt = jrobots.get(robot)
    tt = lt.robots.get(robot, device="cpu")
    q = q_batch(jt, 4, seed=2)
    for i in range(jt.njoints):
        if jt.jtypes[i] in ttree._Q_DEPENDENT:
            with pytest.raises(ValueError, match="depends on the configuration"):
                tt.joint_S(i)
            np.testing.assert_allclose(tt.joint_S(i, torch.as_tensor(q)).numpy(),
                                       np.asarray(jt.joint_S(i, jnp.asarray(q))), atol=1e-12)
        else:
            np.testing.assert_array_equal(tt.joint_S(i).numpy(), np.asarray(jt.joint_S(i)))
    if not jt.has_q_dependent_S:
        np.testing.assert_array_equal(tt.joint_S_padded().numpy(),
                                      np.asarray(jt.joint_S_padded()))
