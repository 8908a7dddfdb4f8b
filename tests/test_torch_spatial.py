"""loik_tpu_torch spatial algebra against loik_tpu, on the same random
inputs (numpy, seeded): every trailing-batch primitive of
`solver/batched_spatial.py` at 1e-12 in float64 and 1e-5 in float32, both
`act_sym6` forms, `spd_inv` for k = 1, 3, 6, and the leading-batch SE(3)
pieces of `spatial.py` that FK and the URDF loader use.
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
@pytest.mark.parametrize("k", [1, 3, 6])
def test_spd_inv(k, dtype):
    D = _spd(np.random.default_rng(k), k).astype(dtype)
    want = np.asarray(jbsp.spd_inv(jnp.asarray(D)))
    got = tbsp.spd_inv(torch.as_tensor(D)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    # and it is the inverse
    eye = np.einsum("ijb,jkb->ikb", got.astype(np.float64), D.astype(np.float64))
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(k)[..., None], eye.shape),
                               atol=1e3 * TOL[dtype])


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
