"""The port's `model/kinematics.py` against loik_tpu's on the same
numpy-seeded configurations, in float64: the geometric Jacobian of a link in
its local frame and in the world frame, the frame velocity, and the two
task-constraint builders, on `panda_arm`, the free-flyer `solo12` and
`mobile_ur5` (a universal joint: the subspace columns depend on q).  The
port takes a batch of configurations; loik_tpu's functions are mapped over
the same batch.  Held to 1e-12 (the arithmetic is the same FK and 3x3
products; measured at most a few ulps of the entries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loik_tpu.model import kinematics as jkin
from loik_tpu_torch.model import kinematics as tkin

from tests.test_torch_model import pair, q_batch

CASES = [("panda_arm", 6), ("panda_arm", 2), ("solo12", 8), ("mobile_ur5", None)]


def _case(robot, link):
    jt, tt, _, tp = pair(robot, "float64")
    link = tp.constraint_links[0] if link is None else link
    q = q_batch(jt, 4, seed=len(robot))
    return jt, tt, link, q


@pytest.mark.parametrize("frame", ["local", "world"])
@pytest.mark.parametrize("robot,link", CASES)
def test_joint_jacobian_matches_reference(robot, link, frame):
    jt, tt, link, q = _case(robot, link)
    want = jax.vmap(lambda q_: jkin.joint_jacobian(jt, q_, link, frame))(jnp.asarray(q))
    got = tkin.joint_jacobian(tt, torch.as_tensor(q), link, frame)
    assert got.shape == (4, 6, tt.nv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    # one configuration without a batch axis
    one = tkin.joint_jacobian(tt, torch.as_tensor(q[0]), link, frame)
    np.testing.assert_allclose(one.numpy(), got[0].numpy(), rtol=0, atol=1e-14)


@pytest.mark.parametrize("robot,link", CASES)
def test_frame_velocity_and_task_builders_match_reference(robot, link):
    jt, tt, link, q = _case(robot, link)
    rng = np.random.default_rng(1)
    nu = rng.standard_normal((4, jt.nv))
    v_world = rng.standard_normal((4, 6))
    jq = jnp.asarray(q)
    tq = torch.as_tensor(q)
    for frame in ("local", "world"):
        want = jax.vmap(lambda q_, n: jkin.frame_velocity(jt, q_, n, link, frame))(
            jq, jnp.asarray(nu))
        got = tkin.frame_velocity(tt, tq, torch.as_tensor(nu), link, frame)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    for name, arg in (("task_from_world_velocity", v_world),
                      ("task_linear_velocity", v_world[:, :3])):
        A_j, b_j = jax.vmap(lambda q_, v: getattr(jkin, name)(jt, q_, link, v))(
            jq, jnp.asarray(arg))
        A_t, b_t = getattr(tkin, name)(tt, tq, link, torch.as_tensor(arg))
        np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=0, atol=0)
        np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=0, atol=1e-12)


def test_world_velocity_task_is_met_by_the_jacobian():
    """A v_link = b for nu solving J_world nu = v_world (a 7-dof arm, so a
    least-squares nu realizes any twist)."""
    _, tt, _, _ = pair("panda_arm", "float64")
    q = torch.as_tensor(q_batch(tt, 3, seed=2))
    v_world = torch.as_tensor(np.random.default_rng(3).standard_normal((3, 6)))
    J = tkin.joint_jacobian(tt, q, 6, "world")
    nu = torch.linalg.lstsq(J, v_world[..., None]).solution[..., 0]
    A, b = tkin.task_from_world_velocity(tt, q, 6, v_world)
    v_local = tkin.frame_velocity(tt, q, nu, 6)
    torch.testing.assert_close((A @ v_local[..., None])[..., 0], b, rtol=0, atol=1e-10)


def test_unknown_frame_raises():
    _, tt, _, _ = pair("panda_arm", "float64")
    with pytest.raises(ValueError, match="frame must be"):
        tkin.joint_jacobian(tt, tt.neutral(), 6, "base")
