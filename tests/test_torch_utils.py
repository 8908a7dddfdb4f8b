"""`loik_tpu_torch.utils` on the CPU: checkpoint / resume, the steady-state
guard, `debug_mirror` (tests/test_debug_mirror.py's cases, case for case),
`debug_nans`, `trace` and `Timer`.

On CPU tensors `solve_fused` runs the eager loop, so the mirror's parity
holds trivially here; the card holds it against the kernel
(tests/test_torch_kernel.py, chip_smoke.py phase 16).  No loik_tpu compile.
"""

import dataclasses
import glob
import os
import stat

import numpy as np
import pytest
import torch

import loik_tpu_torch as lt
from loik_tpu_torch.kernels import _build, common, fused
from loik_tpu_torch.kernels.fused import solve_fused
from loik_tpu_torch.solver.state import LOG_FIELDS, init_state
from loik_tpu_torch.utils import (MirrorMismatch, Timer, debug_mirror, debug_nans,
                                  load_state, no_recompile_guard, save_state, trace)

PARAMS = lt.SolverParams(max_iter=60, tol_abs=1e-4, tol_rel=1e-4)


def _workload(B=32, dtype=torch.float32):
    """tests/test_debug_mirror.py's: panda_arm, v_z = 0.2, box +-4, B
    configurations from numpy."""
    tree = lt.robots.panda_arm(str(dtype).removeprefix("torch."), device="cpu")
    b = np.zeros((1, 6))
    b[0, 2] = 0.2
    prob = lt.make_problem(tree, (tree.njoints - 1,), b=b, lb=-4 * np.ones(tree.nv),
                           ub=4 * np.ones(tree.nv))
    q = torch.as_tensor(np.random.default_rng(3).uniform(-np.pi, np.pi, (B, tree.nq)),
                        dtype=dtype)
    return tree, prob, q


# --------------------------------------------------------------------------- #
# checkpoint / resume
# --------------------------------------------------------------------------- #


def test_checkpoint_roundtrip_and_resume(tmp_path):
    tree, prob, q = _workload(B=4, dtype=torch.float64)
    params = lt.SolverParams(max_iter=100, tol_abs=1e-6, tol_rel=1e-6)
    res = lt.solve(tree, params, q, prob)
    path = str(tmp_path / "sub" / "state.pt")
    save_state(path, res.state)
    restored = load_state(path, init_state(tree, 4, 1, torch.float64, "cpu"))
    for f in dataclasses.fields(res.state):
        a, b = getattr(res.state, f.name), getattr(restored, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name
    warm = lt.solve(tree, params.replace(warm_start=True), q, prob, restored)
    assert (warm.iterations <= res.iterations).all()


def test_checkpoint_keeps_logs_and_refuses_a_mismatch(tmp_path):
    tree, prob, q = _workload(B=4, dtype=torch.float64)
    res = lt.solve(tree, PARAMS.replace(logging=True), q, prob)
    path = str(tmp_path / "logged.pt")
    save_state(path, res.state)
    like = init_state(tree, 4, 1, torch.float64, "cpu", max_iter=PARAMS.max_iter, logging=True)
    restored = load_state(path, like)
    for name in LOG_FIELDS:
        assert torch.allclose(getattr(restored, name), getattr(res.state, name),
                              rtol=0, atol=0, equal_nan=True), name
    with pytest.raises(ValueError, match="lacks"):
        load_state(path, init_state(tree, 4, 1, torch.float64, "cpu"))
    with pytest.raises(ValueError, match="field liMi_R"):
        load_state(path, init_state(tree, 5, 1, torch.float64, "cpu",
                                    max_iter=PARAMS.max_iter, logging=True))
    with pytest.raises(ValueError, match="float32"):
        load_state(path, init_state(tree, 4, 1, torch.float32, "cpu",
                                    max_iter=PARAMS.max_iter, logging=True))


# --------------------------------------------------------------------------- #
# no_recompile_guard
# --------------------------------------------------------------------------- #


def test_no_recompile_guard_passes_when_warm():
    tree, prob, q = _workload(B=4)
    lt.solve(tree, PARAMS, q, prob)
    with no_recompile_guard() as events:
        for _ in range(3):
            lt.solve(tree, PARAMS, q, prob)
    assert events.count == 0 and events.names == []


def test_no_recompile_guard_fires_on_a_kernel_build(tmp_path, monkeypatch):
    """A build of the kernel library inside the block is an event: here a
    stand-in nvcc (a script that writes its -o file) into a scratch build
    directory, through the real `_build.build`."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then shift; : > "$1"; fi\n  shift\ndone\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no_recompile_guard: 1 events.*nvcc build"):
        with no_recompile_guard():
            _build.build()
    assert os.path.exists(_build.library_path())
    with no_recompile_guard(allowed=0) as events:   # built: no second nvcc run
        _build.build()
    assert events.count == 0
    with no_recompile_guard(allowed=1) as events:   # within the allowance
        os.unlink(_build.library_path())
        _build.build()
    assert events.names == ["nvcc build"]


# --------------------------------------------------------------------------- #
# debug_mirror — tests/test_debug_mirror.py's cases
# --------------------------------------------------------------------------- #


def test_mirror_logs_fused_run():
    """Mirror a fused production solve: parity asserted, per-iteration logs
    returned, covering exactly the iterations each problem ran."""
    tree, prob, q = _workload()
    res = solve_fused(tree, PARAMS, q, prob, batch_tile=16)
    mirror = debug_mirror(tree, PARAMS, q, prob, result=res)
    log_rp = mirror.log_rp.numpy()
    assert log_rp.shape == (PARAMS.max_iter, q.shape[0])
    iters = res.iterations.numpy()
    for i in (0, 7, 31):
        assert np.isfinite(log_rp[: iters[i], i]).all()
        assert np.isnan(log_rp[iters[i]:, i]).all()
    np.testing.assert_allclose(log_rp[iters[0] - 1, 0], float(res.primal_residual[0]), rtol=1e-6)
    for name in LOG_FIELDS:
        assert getattr(mirror, name).shape == (PARAMS.max_iter, q.shape[0])


@pytest.mark.parametrize("sample", [[3, 17, 30], np.array([3, 17, 30]),
                                    torch.tensor([3, 17, 30])], ids=["list", "numpy", "tensor"])
def test_mirror_sample_subbatch(sample):
    """sample= mirrors only the named problems — the B=16k debugging shape."""
    tree, prob, q = _workload(B=32)
    res = solve_fused(tree, PARAMS, q, prob, batch_tile=16)
    mirror = debug_mirror(tree, PARAMS, q, prob, result=res, sample=sample)
    assert mirror.log_rp.shape == (PARAMS.max_iter, 3)
    np.testing.assert_array_equal(mirror.iterations.numpy(), res.iterations.numpy()[[3, 17, 30]])


def test_mirror_sample_slices_batched_problem_leaves():
    """Per-problem (leading-batch) problem leaves are sliced with q; shared
    ones are not."""
    tree, prob, q = _workload(B=8)
    b = prob.b.expand(8, 1, 6).clone()
    b[:, 0, 2] = torch.linspace(0.05, 0.4, 8)
    prob = prob.replace(b=b)
    res = solve_fused(tree, PARAMS, q, prob, batch_tile=16)
    mirror = debug_mirror(tree, PARAMS, q, prob, result=res, sample=[6, 1])
    np.testing.assert_array_equal(mirror.iterations.numpy(), res.iterations.numpy()[[6, 1]])
    assert torch.equal(mirror.nu, res.nu[[6, 1]])


def test_mirror_detects_divergence():
    """A result that does NOT match the mirrored inputs must raise — mirror
    logs can never silently describe a different solve."""
    tree, prob, q = _workload()
    res = solve_fused(tree, PARAMS, q, prob, batch_tile=16)
    forged = dataclasses.replace(res, iterations=res.iterations + 5)
    with pytest.raises(MirrorMismatch, match="iterations"):
        debug_mirror(tree, PARAMS, q, prob, result=forged)
    forged2 = dataclasses.replace(res, primal_residual=res.primal_residual * 3)
    with pytest.raises(MirrorMismatch, match="primal_residual"):
        debug_mirror(tree, PARAMS, q, prob, result=forged2)
    # a residual off by 1e-9 raises at atol 0 and passes at atol 1e-8
    near = dataclasses.replace(res, dual_residual=res.dual_residual + 1e-9)
    with pytest.raises(MirrorMismatch, match="dual_residual"):
        debug_mirror(tree, PARAMS, q, prob, result=near)
    debug_mirror(tree, PARAMS, q, prob, result=near, atol=1e-8)


def test_mirror_warm_tick():
    """Warm ticks mirror too when given the same warm state; the sample of a
    warm tick slices the warm state's trailing batch."""
    tree, prob, q = _workload(B=16)
    p = PARAMS.replace(warm_start=True)
    cold = solve_fused(tree, p, q, prob, batch_tile=16)
    warm = solve_fused(tree, p, q, prob, warm_state=cold.state, batch_tile=16)
    mirror = debug_mirror(tree, p, q, prob, warm_state=cold.state, result=warm)
    np.testing.assert_array_equal(mirror.iterations.numpy(), warm.iterations.numpy())
    part = debug_mirror(tree, p, q, prob, warm_state=cold.state, result=warm, sample=[2, 9])
    np.testing.assert_array_equal(part.iterations.numpy(), warm.iterations.numpy()[[2, 9]])


def test_mirror_check_interval_schedule():
    """Mirroring a check_interval>1 production solve keeps the SAME K
    schedule (iteration counts on multiples of K); logs carry residuals at
    check slots and NaN on skipped iterations."""
    tree, prob, q = _workload()
    pK = PARAMS.replace(check_interval=4)
    res = solve_fused(tree, pK, q, prob, batch_tile=16)
    mirror = debug_mirror(tree, pK, q, prob, result=res)
    iters = mirror.iterations.numpy()
    assert (iters % 4 == 0).all()
    log_rp = mirror.log_rp.numpy()
    for j, it in enumerate(iters):
        ran = log_rp[:it, j]
        assert np.isfinite(ran[3::4]).all()
        assert np.isnan(ran[0::4]).all()


# --------------------------------------------------------------------------- #
# debug_nans, trace, Timer
# --------------------------------------------------------------------------- #


def test_debug_nans_raises_and_restores():
    x = torch.zeros(3)
    st = dataclasses.replace(init_state(lt.robots.ur5(device="cpu"), 2, 1, torch.float64),
                             mu=torch.tensor([0.1, float("nan")], dtype=torch.float64))
    assert not common.CHECK_NANS
    with debug_nans():
        assert common.CHECK_NANS and torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="div"):
            x / x
        y = x + 1.0                          # NaN-free work passes
        with debug_nans(False):              # and can be switched off inside
            assert torch.isnan(x / x).all()
        assert common.CHECK_NANS
        with pytest.raises(FloatingPointError, match="output mu"):
            # what a launch's output goes through
            common.check_nans("fused ADMM kernel",
                              ((n, getattr(st, n)) for n in fused._STATE_FIELDS))
    assert not common.CHECK_NANS and not torch.is_anomaly_enabled()
    assert torch.isnan(x / x).all() and torch.equal(y, torch.ones(3))


def test_debug_nans_passes_a_clean_solve():
    tree, prob, q = _workload(B=4, dtype=torch.float64)
    with debug_nans():
        res = lt.solve(tree, PARAMS, q, prob)
    assert torch.isfinite(res.nu).all()


def test_trace_writes_a_chrome_trace(tmp_path):
    tree, prob, q = _workload(B=4)
    with trace(str(tmp_path)) as log_dir:
        lt.solve(tree, PARAMS.replace(max_iter=4), q, prob)
    assert log_dir == str(tmp_path)
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        text = f.read()
    assert '"traceEvents"' in text and "aten::" in text


def test_timer():
    t = Timer()
    for _ in range(3):
        with t.measure():
            torch.ones(100).sum()
    assert len(t.samples) == 3 and t.mean_us > 0
    assert 0 < t.percentile_ms(50) <= t.percentile_ms(100)
    assert Timer().mean_us == 0.0
