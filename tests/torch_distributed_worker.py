"""One process of tests/test_torch_distributed.py (NOT a pytest file).

    python tests/torch_distributed_worker.py <rank> <world> <host:port> <dir> <devices>

Joins a gloo process group of <world> processes through
`loik_tpu_torch.parallel.distributed`, with <devices> repetitions of the
CPU device as its local mesh, solves its block of the global batch in
<dir>/fixture.npz and writes its rows and the global metrics to
<dir>/out_<rank>.npz.  Imports no jax.
"""

import sys


def main():
    rank, world, coord, outdir, per_proc = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], int(sys.argv[5]))
    import numpy as np
    import torch

    import loik_tpu_torch as lt
    from loik_tpu_torch.parallel import distributed as dist

    dist.initialize(coordinator_address=coord, num_processes=world, process_id=rank,
                    local_device_ids=range(per_proc), device="cpu")
    dist.initialize(coordinator_address=coord, num_processes=world, process_id=rank,
                    device="cpu")  # idempotent
    assert dist.process_count() == world and torch.distributed.get_rank() == rank
    assert torch.distributed.get_backend() == "gloo"

    q = np.load(f"{outdir}/fixture.npz")["q"]
    B_local = q.shape[0] // world
    q_local = q[rank * B_local:(rank + 1) * B_local]

    tree = lt.robots.panda_arm("float64", device="cpu")
    b = np.zeros((1, 6))
    b[0, 2] = 0.2
    problem = lt.make_problem(tree, (tree.njoints - 1,), b=b,
                              lb=-4.0 * np.ones(tree.nv), ub=4.0 * np.ones(tree.nv))
    params = lt.SolverParams(max_iter=60, tol_abs=1e-6, tol_rel=1e-6)

    mesh = dist.global_mesh()
    assert mesh.size == per_proc
    blocks = dist.from_local_batch(mesh, q_local)
    assert len(blocks) == per_proc and np.array_equal(dist.local_shard(blocks), q_local)
    assert len(dist.replicated(mesh, b)) == per_proc

    res = dist.solve_global(tree, params, q_local, problem, mesh=mesh)
    m = dist.global_metrics(res)
    try:
        dist.solve_global(tree, params, q_local[:1], problem, mesh=mesh)
        raised = per_proc == 1
    except ValueError as e:
        raised = "not divisible" in str(e)
    np.savez(
        f"{outdir}/out_{rank}.npz",
        nu=dist.local_shard(res.nu),
        converged=dist.local_shard(res.converged),
        iterations=dist.local_shard(res.iterations),
        raised=raised,
        **{f"m_{k}": v for k, v in m.items()},
    )
    dist.shutdown()


if __name__ == "__main__":
    main()
