"""loik_tpu_torch spatial algebra against loik_tpu, on the same random
inputs (numpy, seeded): every trailing-batch primitive of
`solver/batched_spatial.py` at 1e-12 in float64 and 1e-5 in float32, both
`act_sym6` forms, `spd_inv` for k = 1, 2, 3, 6 (also against
`numpy.linalg.inv`, 1e-10 in float64), and the leading-batch SE(3) pieces of
`spatial.py` that FK, manifold integration and the URDF loader use, the
small-angle branches of the exponentials included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loik_tpu import spatial as jsp
from loik_tpu.solver import batched_spatial as jbsp
from loik_tpu_torch import spatial as tsp
from loik_tpu_torch.solver import batched_spatial as tbsp

B = 16
TOL = {"float64": 1e-12, "float32": 1e-5}


def _rot(rng, lead=()):
    """Random rotations (lead..., 3, 3) from QR of Gaussian matrices."""
    Q, R = np.linalg.qr(rng.standard_normal(lead + (3, 3)))
    return Q * np.sign(np.diagonal(R, axis1=-2, axis2=-1))[..., None, :]


def _trailing_rot(rng, n=2):
    return np.moveaxis(_rot(rng, (n, B)), 1, -1)              # (n, 3, 3, B)


def _sym6(rng, n=2):
    M = rng.standard_normal((n, B, 6, 6))
    return np.moveaxis(M + np.swapaxes(M, -1, -2), 1, -1)     # (n, 6, 6, B)


def _spd(rng, k):
    M = rng.standard_normal((B, k, k))
    return np.moveaxis(M @ np.swapaxes(M, -1, -2) + k * np.eye(k), 0, -1)


def _inputs(name, rng):
    g = rng.standard_normal
    R, p = _trailing_rot(rng), g((2, 3, B))
    table = {
        "mv": (g((2, 6, 6, B)), g((2, 6, B))),
        "mtv": (g((2, 6, 6, B)), g((2, 6, B))),
        "mm": (g((2, 6, 6, B)), g((2, 6, 1, B))),
        "mtm": (g((2, 6, 1, B)), g((2, 6, 1, B))),
        "mmt": (g((2, 6, 1, B)), g((2, 6, 1, B))),
        "cross": (g((2, 3, B)), g((2, 3, B))),
        "act_inv_motion": (R, p, g((2, 6, B))),
        "act_force": (R, p, g((2, 6, B))),
        "skew": (g((2, 3, B)),),
        "dual_action_matrix": (R, p),
        "skew_mm": (p, g((2, 3, 3, B))),
        "mm_skew": (g((2, 3, 3, B)), p),
        "act_sym6": (R, p, _sym6(rng)),
        "inf_norm_b": (g((2, 6, B)),),
    }
    return table[name]


PRIMITIVES = ["mv", "mtv", "mm", "mtm", "mmt", "cross", "act_inv_motion", "act_force",
              "skew", "dual_action_matrix", "skew_mm", "mm_skew", "act_sym6", "inf_norm_b"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", PRIMITIVES)
def test_batched_primitive_matches_reference(name, dtype):
    args = [a.astype(dtype) for a in _inputs(name, np.random.default_rng(7))]
    want = np.asarray(getattr(jbsp, name)(*[jnp.asarray(a) for a in args]))
    got = getattr(tbsp, name)(*[torch.as_tensor(a) for a in args]).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("form,dtype", [("dense", "float32"), ("block", "float64"),
                                        ("dense", "float64"), ("block", "float32")])
def test_act_sym6_forms(form, dtype):
    """Both congruence forms equal the reference's act_sym6 for each dtype;
    `act_sym6` itself picks the block form for float64 only, as loik_tpu."""
    R, p, H = [a.astype(dtype) for a in _inputs("act_sym6", np.random.default_rng(3))]
    want = np.asarray(jbsp.act_sym6(jnp.asarray(R), jnp.asarray(p), jnp.asarray(H)))
    fn = getattr(tbsp, f"act_sym6_{form}")
    got = fn(torch.as_tensor(R), torch.as_tensor(p), torch.as_tensor(H)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype] * 10)


@pytest.mark.parametrize("name", ["mv", "mtv", "mm", "mtm", "mmt", "act_force",
                                  "act_inv_motion", "act_sym6"])
def test_float32_sums_in_reference_order(name):
    """Bit for bit in float32 against loik_tpu run op by op: every
    contraction adds its terms in the reference's order.  The CUDA kernel
    adds in the same order, and the solver's float32 iteration counts change
    under one-ulp input changes, so this order is what lets the kernel, the
    eager loop and the reference be compared at all."""
    args = [a.astype("float32") for a in _inputs(name, np.random.default_rng(11))]
    want = np.asarray(getattr(jbsp, name)(*[jnp.asarray(a) for a in args]))
    got = getattr(tbsp, name)(*[torch.as_tensor(a) for a in args]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sum_lead_matches_jnp_sum(dtype):
    x = np.random.default_rng(5).standard_normal((3, 6, B)).astype(dtype)
    np.testing.assert_allclose(tbsp.sum_lead(torch.as_tensor(x)).numpy(),
                               np.asarray(jnp.sum(jnp.asarray(x), axis=(0, 1))),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("k", [1, 2, 3, 6])
def test_spd_inv(k, dtype):
    D = _spd(np.random.default_rng(k), k).astype(dtype)
    want = np.asarray(jbsp.spd_inv(jnp.asarray(D)))
    got = tbsp.spd_inv(torch.as_tensor(D)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    # and it is the inverse
    eye = np.einsum("ijb,jkb->ikb", got.astype(np.float64), D.astype(np.float64))
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(k)[..., None], eye.shape),
                               atol=1e3 * TOL[dtype])


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
def test_spd_inv_against_numpy(k):
    """The unrolled Cholesky inverse the solver and the CUDA kernel share,
    against LAPACK's: 1e-10 in float64 on D = M M^T + k I."""
    D = _spd(np.random.default_rng(10 + k), k)
    want = np.moveaxis(np.linalg.inv(np.moveaxis(D, -1, 0)), 0, -1)
    got = tbsp.spd_inv(torch.as_tensor(D)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, np.swapaxes(got, 0, 1), rtol=0, atol=1e-14)


def _tangents(rng, n, dtype):
    """n tangent vectors (n, 6): generic, tiny (the Taylor branches), at the
    branch cutoff's scale, and zero."""
    v = rng.uniform(-2.0, 2.0, (n, 6))
    v[0] *= 1e-9
    v[1] *= 1e-5
    v[2] *= float(np.sqrt(tsp._small_angle_cutoff(getattr(torch, dtype)))) / 2.0
    v[3] = 0.0
    return v.astype(dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["exp3_quat", "se3_exp_translation", "se2_exp", "quat_mul",
                                  "quat_to_rotmat", "rotation_about_axis_cs"])
def test_manifold_pieces_match_reference(name, dtype):
    """The exponentials and quaternion pieces behind `integrate` and the
    free-flyer / spherical / planar / continuous `joint_calc`."""
    rng = np.random.default_rng(4)
    v = _tangents(rng, B, dtype)
    q1, q2 = rng.standard_normal((2, B, 4)).astype(dtype)
    axis = rng.standard_normal((B, 3))
    axis = (axis / np.linalg.norm(axis, axis=-1, keepdims=True)).astype(dtype)
    ang = rng.uniform(-np.pi, np.pi, B)
    args = {
        "exp3_quat": (v[:, 3:],),
        "se3_exp_translation": (v,),
        "se2_exp": (v[:, 0], v[:, 1], v[:, 5]),
        "quat_mul": (q1, q2),
        "quat_to_rotmat": (q1,),
        "rotation_about_axis_cs": (axis, np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)),
    }[name]
    want = getattr(jsp, name)(*[jnp.asarray(a) for a in args])
    got = getattr(tsp, name)(*[torch.as_tensor(a) for a in args])
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_small_angle_cutoff_and_so3_coeffs(dtype):
    td = getattr(torch, dtype)
    assert tsp._small_angle_cutoff(td) == pytest.approx(jsp._small_angle_cutoff(jnp.dtype(dtype)))
    w = _tangents(np.random.default_rng(6), B, dtype)[:, 3:]
    for g, x in zip(tsp._so3_coeffs(torch.as_tensor(w)), jsp._so3_coeffs(jnp.asarray(w))):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=TOL[dtype], atol=TOL[dtype])


def test_exponentials_are_rotations_and_compose():
    """exp3_quat gives unit quaternions whose matrix is Rodrigues' rotation,
    and quat_mul composes like the matrices."""
    rng = np.random.default_rng(8)
    w = torch.as_tensor(_tangents(rng, B, "float64")[:, 3:])
    q = tsp.exp3_quat(w)
    np.testing.assert_allclose(q.norm(dim=-1).numpy(), 1.0, atol=1e-14)
    theta = w.norm(dim=-1)
    axis = w / theta.clamp_min(1e-300)[:, None]
    np.testing.assert_allclose(tsp.quat_to_rotmat(q).numpy(),
                               tsp.rotation_about_axis(axis, theta).numpy(), atol=1e-12)
    q2 = tsp.exp3_quat(torch.as_tensor(rng.uniform(-1, 1, (B, 3))))
    np.testing.assert_allclose(
        tsp.quat_to_rotmat(tsp.quat_mul(q, q2)).numpy(),
        (tsp.quat_to_rotmat(q) @ tsp.quat_to_rotmat(q2)).numpy(), atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_se3_pieces_match_reference(dtype):
    rng = np.random.default_rng(2)
    axis = rng.standard_normal((B, 3))
    axis = (axis / np.linalg.norm(axis, axis=-1, keepdims=True)).astype(dtype)
    ang = rng.uniform(-np.pi, np.pi, B).astype(dtype)
    rpy = rng.uniform(-np.pi, np.pi, (B, 3)).astype(dtype)
    Ra, Rb = _rot(rng, (B,)).astype(dtype), _rot(rng, (B,)).astype(dtype)
    pa, pb = rng.standard_normal((2, B, 3)).astype(dtype)
    v = rng.standard_normal((B, 6)).astype(dtype)
    J, T = jnp.asarray, torch.as_tensor
    pairs = [
        (tsp.skew(T(pa)), jsp.skew(J(pa))),
        (tsp.rotation_about_axis(T(axis), T(ang)), jsp.rotation_about_axis(J(axis), J(ang))),
        (tsp.rpy_to_rotmat(T(rpy)), jsp.rpy_to_rotmat(J(rpy))),
        *zip(tsp.se3_compose(T(Ra), T(pa), T(Rb), T(pb)),
             jsp.se3_compose(J(Ra), J(pa), J(Rb), J(pb))),
        (tsp.act_motion(T(Ra), T(pa), T(v)), jsp.act_motion(J(Ra), J(pa), J(v))),
        (tsp.act_inv_motion(T(Ra), T(pa), T(v)), jsp.act_inv_motion(J(Ra), J(pa), J(v))),
        (tsp.act_force(T(Ra), T(pa), T(v)), jsp.act_force(J(Ra), J(pa), J(v))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL[dtype], atol=TOL[dtype])
