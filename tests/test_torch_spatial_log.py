"""The SE(3) pieces of `loik_tpu_torch.spatial` that closed-loop IK and the
kinematics helpers use, against loik_tpu's on the same numpy-seeded inputs:
the logarithms (`so3_log`, `se3_log`) in every regime — the exact identity,
the Taylor branch, the bulk, the near-pi branch (pi - 1e-3, pi - 1e-7) and
exactly pi — batched, and `se3_exp`, `se3_inverse`, `act_inv_force`, the
action matrices, `se3_act_on_sym6`, `motion_cross`, `inf_norm`.

Tolerances: 1e-12 in float64 and 1e-5 in float32 wherever the arithmetic is
well conditioned.  Near pi, theta = arccos(c) amplifies a one-ulp difference
of c between XLA's and PyTorch's elementwise kernels by 1/sin(theta) (1e7 at
pi - 1e-7), so the near-pi cases are held to 1e-8 in float64 and 1e-3 in
float32.  Every log is also checked to invert `se3_exp`: to 1e-9 (1e-7 near
pi, where the log itself is that precise) in float64, 1e-4 in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loik_tpu import spatial as jsp
from loik_tpu_torch import spatial as tsp

TOL = {"float64": 1e-12, "float32": 1e-5}
# rotation angles of each regime: identity, Taylor, bulk, near pi, pi
ANGLES = {"identity": 0.0, "taylor": 1e-5, "bulk": 1.3, "near_pi_1e-3": np.pi - 1e-3,
          "near_pi_1e-7": np.pi - 1e-7, "pi": np.pi}


def _twists(rng, angle, n=16):
    """n twists [u; angle * axis] with random unit axes (the first along x,
    the second along a diagonal) and random u."""
    axes = rng.standard_normal((n, 3))
    axes[0], axes[1] = [1.0, 0, 0], [0.6, -0.64, 0.48]
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    return np.concatenate([rng.standard_normal((n, 3)), angle * axes], axis=-1)


def _both(fn_name, *args, dtype="float64"):
    jargs = [jnp.asarray(a, dtype) for a in args]
    targs = [torch.as_tensor(np.array(a), dtype=getattr(torch, dtype)) for a in args]
    got = getattr(tsp, fn_name)(*targs)
    want = getattr(jsp, fn_name)(*jargs)
    if isinstance(got, tuple):
        return [g.numpy() for g in got], [np.asarray(w) for w in want]
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("regime", list(ANGLES))
def test_logs_match_reference(regime, dtype):
    """so3_log and se3_log of the same placements (built once in float64 by
    loik_tpu's exp, then cast) in both packages."""
    v = _twists(np.random.default_rng(len(regime)), ANGLES[regime])
    R, p = (np.asarray(x) for x in jsp.se3_exp(jnp.asarray(v)))
    R, p = R.astype(dtype), p.astype(dtype)
    near_pi = regime.startswith("near_pi") or regime == "pi"
    tol = {"float64": 1e-8 if near_pi else 1e-12, "float32": 1e-3 if near_pi else 1e-5}[dtype]
    got, want = _both("so3_log", R, dtype=dtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    got6, want6 = _both("se3_log", R, p, dtype=dtype)
    np.testing.assert_allclose(got6, want6, rtol=0, atol=tol * 10)
    assert got6.dtype == np.dtype(dtype)
    # exp(log(.)) gives back the placement (at pi the axis sign is free)
    R2, p2 = tsp.se3_exp(torch.as_tensor(got6))
    back = {"float64": 1e-7 if near_pi else 1e-9, "float32": 1e-4}[dtype]
    np.testing.assert_allclose(R2.numpy(), R, rtol=0, atol=back)
    np.testing.assert_allclose(p2.numpy(), p, rtol=0, atol=back)


def test_log_of_exact_identity_is_the_translation():
    R, p = tsp.se3_identity(torch.float64)
    w = tsp.se3_log(R, torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64))
    assert torch.equal(w, torch.tensor([1.0, 2.0, 3.0, 0.0, 0.0, 0.0], dtype=torch.float64))
    Rj, pj = jsp.se3_identity(jnp.float64)
    np.testing.assert_array_equal(R.numpy(), np.asarray(Rj))
    np.testing.assert_array_equal(p.numpy(), np.asarray(pj))


def test_log_batched_leading_dims():
    """(4, 8) leading dims of mixed regimes give the (4, 8, 6) of the
    flattened batch."""
    rng = np.random.default_rng(11)
    v = np.concatenate([_twists(rng, a, 8) for a in (1e-5, 0.7, 2.5, np.pi - 1e-3)])
    R, p = (np.asarray(x) for x in jsp.se3_exp(jnp.asarray(v)))
    flat, _ = _both("se3_log", R, p)
    got, want = _both("se3_log", R.reshape(4, 8, 3, 3), p.reshape(4, 8, 3))
    assert got.shape == (4, 8, 6)
    np.testing.assert_array_equal(got.reshape(32, 6), flat)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_se3_exp_matches_reference(dtype):
    rng = np.random.default_rng(3)
    v = np.concatenate([_twists(rng, a, 8) for a in (0.0, 1e-6, 0.4, 3.0)]).astype(dtype)
    got, want = _both("se3_exp", v, dtype=dtype)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL[dtype])


def _placement(rng, n, dtype):
    v = _twists(rng, 1.1, n)
    R, p = (np.asarray(x).astype(dtype) for x in jsp.se3_exp(jnp.asarray(v)))
    return R, p


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["se3_inverse", "act_inv_force", "se3_action_matrix",
                                  "se3_dual_action_matrix", "se3_act_on_sym6",
                                  "motion_cross"])
def test_se3_actions_match_reference(name, dtype):
    rng = np.random.default_rng(5)
    R, p = _placement(rng, 12, dtype)
    x = rng.standard_normal((12, 6)).astype(dtype)
    H = rng.standard_normal((12, 6, 6))
    H = (H + np.swapaxes(H, -1, -2)).astype(dtype)
    args = {"se3_inverse": (R, p), "act_inv_force": (R, p, x),
            "se3_action_matrix": (R, p), "se3_dual_action_matrix": (R, p),
            "se3_act_on_sym6": (R, p, H),
            "motion_cross": (x, rng.standard_normal((12, 6)).astype(dtype))}[name]
    got, want = _both(name, *args, dtype=dtype)
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL[dtype] * 10)


def test_action_matrices_are_the_actions():
    """X v = act_motion, X* f = act_force, X^-1 = X*^T, and act_inv_force
    inverts act_force."""
    rng = np.random.default_rng(9)
    R, p = (torch.as_tensor(a) for a in _placement(rng, 6, "float64"))
    v = torch.as_tensor(rng.standard_normal((6, 6)))
    X, Xd = tsp.se3_action_matrix(R, p), tsp.se3_dual_action_matrix(R, p)
    torch.testing.assert_close((X @ v[..., None])[..., 0], tsp.act_motion(R, p, v))
    torch.testing.assert_close((Xd @ v[..., None])[..., 0], tsp.act_force(R, p, v))
    torch.testing.assert_close(X @ Xd.transpose(-1, -2), torch.eye(6, dtype=torch.float64)
                               .expand(6, 6, 6))
    torch.testing.assert_close(tsp.act_inv_force(R, p, tsp.act_force(R, p, v)), v)
    Ri, pi = tsp.se3_inverse(R, p)
    torch.testing.assert_close(tsp.se3_compose(R, p, Ri, pi)[1], torch.zeros(6, 3, dtype=torch.float64))


def test_inf_norm_matches_reference():
    x = np.random.default_rng(2).standard_normal((3, 4, 5))
    for axis in (None, 0, -1, (1, 2)):
        np.testing.assert_array_equal(tsp.inf_norm(torch.as_tensor(x), axis).numpy(),
                                      np.asarray(jsp.inf_norm(jnp.asarray(x), axis)))
