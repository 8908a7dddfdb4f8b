"""The port's entry points (`loik_tpu_torch.entry`), the counterparts of
`__graft_entry__.py`, on the CPU: `entry()`'s solve against loik_tpu's
`entry()` on the same configurations, and `dryrun_multichip` over eight
repetitions of the CPU device with every check of loik_tpu's.

`entry()` solves in float32 at tol 1e-6, where float32 sits at its floor
(ROADMAP, "Float32 chaos"): the port's eager loop and loik_tpu's compiled
program round differently, so iteration counts and flags differ on a
share of the problems.  Measured on this fixture: flags on 9 of 128
problems, converged nu within 9.2e-6.  Held to: flags on at most B/8
problems, nu within 2e-5 where both converged (the budget of
`__graft_entry__.py`).
"""

import sys

import jax
import numpy as np
import pytest
import torch

from loik_tpu_torch.entry import dryrun_multichip, entry

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])
import __graft_entry__ as ge  # noqa: E402


def test_entry_solves_the_flagship():
    fn, (qs,) = entry(device="cpu")
    assert qs.shape == (128, 7) and qs.dtype == torch.float32 and qs.device.type == "cpu"
    nu, conv, iters = fn(qs)
    assert nu.shape == (128, 7) and bool(torch.isfinite(nu).all())
    assert int(conv.sum()) > 0 and iters.dtype == torch.int32

    jfn, _ = ge.entry()
    jnu, jconv, _ = jax.jit(jfn)(jax.numpy.asarray(qs.numpy()))
    jconv = np.asarray(jconv)
    both = conv.numpy() & jconv
    assert int((conv.numpy() != jconv).sum()) <= 128 // 8
    np.testing.assert_allclose(nu.numpy()[both], np.asarray(jnu)[both], rtol=0, atol=2e-5)


def test_dryrun_multichip_cpu(capsys):
    out = dryrun_multichip(8, device="cpu")
    assert out["ok"] and out["scaling"]["no_serialization_ok"]
    assert out["parity"]["converged_flag_diffs"] == 0 and out["parity"]["max_iter_delta"] == 0
    assert out["scaling"]["devices"] == 8 and out["scaling"]["total_problems"] == 2048
    printed = capsys.readouterr().out
    assert "dryrun_multichip OK: 8 devices" in printed and "stream OK" in printed


def test_dryrun_multichip_needs_the_cards():
    if torch.cuda.device_count() >= 64:
        pytest.skip("this machine has 64 cards")
    with pytest.raises(ValueError, match="need 64 devices"):
        dryrun_multichip(64)
