"""The port's multi-process scale-out (`parallel.distributed`): 2 and 4
gloo processes on the CPU, each with its own local mesh of repeated CPU
devices, solve one global batch; every rank's rows are held against
loik_tpu's single-process `solve` of the whole batch, as
tests/test_distributed.py holds loik_tpu's own multi-process run:
float64, nu within 1e-9, converged flags and iteration counts equal, and
the aggregated metrics identical on every rank.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loik_tpu.model import robots
from loik_tpu.params import SolverParams
from loik_tpu.problem import make_problem
from loik_tpu.solver import solve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_distributed_worker.py")
B = 16


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def reference():
    tree = robots.panda_arm("float64")
    q = np.array(tree.random_configuration(jax.random.PRNGKey(7), (B,)))
    b = np.zeros((1, 6))
    b[0, 2] = 0.2
    problem = make_problem(tree, (tree.njoints - 1,), b=b, lb=-4.0 * np.ones(tree.nv),
                           ub=4.0 * np.ones(tree.nv), dtype=jnp.float64)
    ref = solve(tree, SolverParams(max_iter=60, tol_abs=1e-6, tol_rel=1e-6),
                jnp.asarray(q), problem)
    conv = np.asarray(ref.converged)
    assert conv.sum() >= B - 2, "fixture batch must mostly converge"
    return q, np.asarray(ref.nu), conv, np.asarray(ref.iterations)


@pytest.mark.parametrize("nproc,per_proc", [(2, 4), (4, 2)], ids=["2procs_x4dev", "4procs_x2dev"])
def test_gloo_ranks_match_single_process(tmp_path, reference, nproc, per_proc):
    q, ref_nu, ref_conv, ref_iters = reference
    np.savez(tmp_path / "fixture.npz", q=q)
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(nproc), coord, str(tmp_path), str(per_proc)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(nproc)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"

    B_local = B // nproc
    metrics = []
    for r in range(nproc):
        got = np.load(tmp_path / f"out_{r}.npz")
        rows = slice(r * B_local, (r + 1) * B_local)
        np.testing.assert_allclose(got["nu"], ref_nu[rows], rtol=1e-9, atol=1e-9)
        np.testing.assert_array_equal(got["converged"], ref_conv[rows])
        np.testing.assert_array_equal(got["iterations"], ref_iters[rows])
        assert bool(got["raised"]), "an indivisible global batch must raise"
        metrics.append({k: got[k].item() for k in got.files if k.startswith("m_")})
    assert all(m == metrics[0] for m in metrics), metrics
    m = metrics[0]
    assert m["m_num_converged"] == int(ref_conv.sum())
    assert m["m_max_iterations"] == int(ref_iters.max())
    assert m["m_mean_iterations"] == ref_iters.astype(np.float64).mean()
    assert m["m_mean_iterations_converged"] == (
        ref_iters[ref_conv].astype(np.float64).sum() / max(ref_conv.sum(), 1))
