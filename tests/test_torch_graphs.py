"""Captured CUDA graphs (`loik_tpu_torch.utils.graphs`), the port's
counterpart of `jax.jit`, on the CPU: the keys, `disable_graphs`, the
static buffers of a call and of a scan of ticks, fresh results, launch
accounting and failed captures; and that no captured body reads the device
from the host.

The CPU has no CUDA graphs.  The fixture `fake_graphs` puts a stand-in
into `graphs._capture`: after the warm-up call of the body (the first
call's own work, as on the card) it makes one recorded call (the
"capture"); a "replay" calls the body again on the same static buffers and
writes its outputs into the recorded call's outputs, as a graph replay
rewrites its output buffers.  So on CPU tensors
every entry point takes its graph path: copy in, replay, clone out, the
carry kept in static buffers, each tick's inputs read at the device tick
counter.  That path must equal the eager one bit for bit.

The host-read checks run the recorded call under a `TorchFunctionMode`
that records `__bool__`, `item`, `tolist`, `__float__`, `__int__`,
`__index__`, `numpy` and `cpu` on tensors, tensors built from host data
(`torch.tensor`, `as_tensor`, `asarray`) and moves of CPU tensors to a
device; a capture on the card fails on any of them.  There the eager loop of the kernel's CPU branch is replaced
by a stand-in with the kernel's contract (three body calls, no read).

The tests marked `cuda` run the real graphs on a card and skip here:

    python -m pytest tests/test_torch_graphs.py -m cuda --noconftest -q
"""

import dataclasses
import gc
import sys
import weakref

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import loik_tpu_torch as lt
import loik_tpu_torch.solver.solve  # noqa: F401  (the module; the package exports a function)
from loik_tpu_torch.kernels import fused
from loik_tpu_torch.model import tree as ttree
from loik_tpu_torch.utils import graphs

tsm = sys.modules["loik_tpu_torch.solver.solve"]

FLAGSHIP = dict(max_iter=60, tol_abs=1e-6, tol_rel=1e-6, mu=0.1,
                mu_equality_scale_factor=1e5, tail_solve=False)
TRACK = dict(max_iter=60, tol_abs=1e-4, tol_rel=1e-4, warm_start=True)


class HostReads(TorchFunctionMode):
    """Records every tensor method that hands a device value to the host,
    and every copy of host data to the device: a tensor built from Python
    or numpy data (`torch.tensor`, `as_tensor`, `asarray`, on whatever
    device: on the card that is a copy from pageable host memory) and a
    `to`, `copy_` or `cuda` that moves a CPU tensor to another device."""

    NAMES = {"__bool__", "item", "tolist", "__float__", "__int__", "__index__",
             "numpy", "cpu"}
    HOST_DATA = {"tensor", "as_tensor", "asarray"}
    MOVES = {"to", "copy_", "cuda"}

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        out = func(*args, **(kwargs or {}))
        if name in self.NAMES:
            self.calls.append(name)
        elif name in self.HOST_DATA and not isinstance(args[0], torch.Tensor):
            self.calls.append(f"{name} of host data")
        elif name in self.MOVES and isinstance(args[0], torch.Tensor):
            src, dst = (args[1], args[0]) if name == "copy_" else (args[0], out)
            if src.device.type == "cpu" and dst.device.type != "cpu":
                self.calls.append(f"{name} to the device")
        return out


class FakeCapture:
    """The CPU stand-in of `graphs._capture_cuda` (the module docstring).
    ``mode`` says which call of the body runs: "capture", "replay" or
    None (the warm-up, or an eager call).  A replay runs the body as the
    capture did: inside a capture, its entry points inline and its while
    loops through the WHILE node's stand-in."""

    def __init__(self):
        self.reads = []        # host reads of each recorded call
        self.mode = None

    def _call(self, mode, fn):
        self.mode = mode
        try:
            return fn()
        finally:
            self.mode = None

    def __call__(self, device, fn, generators=()):
        n0 = fused.captured_launches()
        # a capture draws nothing from the generators registered with it
        # (torch's default one among them); a replay advances them
        states = [g.get_state() for g in generators]
        default = torch.random.get_rng_state()
        with HostReads() as reads:
            out = self._call("capture", fn)
        for g, st in zip(generators, states):
            g.set_state(st)
        torch.random.set_rng_state(default)
        self.reads.append(reads.calls)
        launches = fused.captured_launches() - n0
        leaves = []
        graphs._flatten(out, leaves)

        def replay():
            new = []
            with graphs.inline():
                graphs._INSIDE.capturing = True
                try:
                    graphs._flatten(self._call("replay", fn), new)
                finally:
                    graphs._INSIDE.capturing = False
            for a, b in zip(leaves, new):
                a.copy_(b)

        return replay, out, launches, 0, 0, 0.0, None


def standin_while(device, pred, step, trips):
    """The CPU stand-in of `graphs._while_node_cuda`: ``step()`` (one trip
    of the body, returning the next predicate) runs while the predicate
    holds, and each trip adds one to ``trips``, as the kernel that ends a
    body on the card does.  The node reads its predicate on the device;
    here it is read out of the sight of `HostReads`.  Returns the body's
    nodes and its graph, none here."""
    while True:
        with torch._C.DisableTorchFunction():
            go = bool(pred)
        if not go:
            return 0, None
        pred = step()
        with torch._C.DisableTorchFunction():
            trips.add_(1)


@pytest.fixture
def fake_graphs(monkeypatch):
    """Graphs on CPU tensors through `FakeCapture`; yields it."""
    fake = FakeCapture()
    monkeypatch.setattr(graphs, "_capture", fake)
    monkeypatch.setattr(graphs, "_while_node", standin_while)
    monkeypatch.setattr(graphs, "_graph_device", lambda device: True)
    graphs.clear_graphs()
    yield fake
    graphs.clear_graphs()


@pytest.fixture
def standin_loop(monkeypatch, fake_graphs):
    """The kernel's CPU branch as a stand-in with the kernel's contract:
    the state in, the state out, no host read (three body calls).  It
    counts its launches as `kernels.fused._launch` does: a launch outside a
    graph adds one to the count, a captured one is recorded by the capture,
    and a replay's are added by `utils.graphs`."""
    def loop(tree, prob, params, st):
        body = tsm.make_loop_body(tree, prob, params)
        for _ in range(3):
            st = body(st)
        if fake_graphs.mode == "capture":
            fused._CAPTURED.n = fused.captured_launches() + 1
        elif fake_graphs.mode != "replay":
            fused.count_launches(1)
        return st

    monkeypatch.setattr(fused, "_solve_loop", loop)


def flagship(B=6, seed=0, dtype=torch.float32):
    tree = lt.robots.panda_arm(str(dtype).removeprefix("torch."), device="cpu")
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.uniform(-np.pi, np.pi, (B, 7)), dtype=dtype)
    problem = lt.make_problem(tree, (6,), b=np.array([[0, 0, 0.2, 0, 0, 0]]),
                              lb=-4 * np.ones(7), ub=4 * np.ones(7))
    return tree, q, problem


def b_sweep(T, B=None):
    b = np.zeros((T, 6), np.float32)
    b[:, 2] = 0.1 * np.cos(2 * np.pi * np.arange(T) / T)
    b[:, 0] = 0.05 * np.sin(2 * np.pi * np.arange(T) / T)
    return torch.as_tensor(b if B is None else np.repeat(b[:, None], B, 1))


def planar_base(dtype="float32"):
    """A planar mobile base (x, y, yaw: a three-dof PLANAR joint) carrying a
    four-joint arm: constant motion subspaces, so the kernel takes it."""
    J = [dict(name="base", parent=-1, type=ttree.PLANAR, velocity_limit=1.5),
         dict(name="pan", parent=0, type=ttree.REVOLUTE, xyz=(0.2, 0, 0.5),
              axis=(0, 0, 1)),
         dict(name="lift", parent=1, type=ttree.REVOLUTE, xyz=(0, 0.13, 0),
              axis=(0, 1, 0)),
         dict(name="elbow", parent=2, type=ttree.REVOLUTE, xyz=(0, -0.12, 0.42),
              axis=(0, 1, 0)),
         dict(name="wrist", parent=3, type=ttree.REVOLUTE_UNBOUNDED, xyz=(0, 0, 0.39),
              axis=(0, 0, 1))]
    return ttree.make_tree(J, name="planar_base", dtype=getattr(torch, dtype),
                           device="cpu")


def task(robot, B=6, seed=0):
    """(tree, q, problem, constraint links, CLIK link) of one robot's task
    in float32: the flagship's on panda_arm, a heave of the end effector on
    the planar base, solo12's base heave on its four feet, talos' gripper
    heave with the base held, and the mixed super-batch's padded chain of
    B/2 UR5 + B/2 panda_arm."""
    rng = np.random.default_rng(seed)
    heave = np.array([[0, 0, 0.2, 0, 0, 0]])
    if robot == "panda_arm":
        tree, q, problem = flagship(B, seed)
        return tree, q, problem, (6,), 6
    if robot == "mixed":
        groups = []
        for name in ("ur5", "panda_arm"):
            t = lt.robots.get(name, "float32", device="cpu")
            qg = torch.as_tensor(rng.uniform(-np.pi, np.pi, (B // 2, t.nq)),
                                 dtype=torch.float32)
            pg = lt.make_problem(t, (t.njoints - 1,), b=heave, lb=-4 * np.ones(t.nv),
                                 ub=4 * np.ones(t.nv))
            groups.append((t, qg, pg))
        mp = lt.parallel.prepare_mixed_padded([(t, B // 2, p) for t, _, p in groups])
        ee = mp.chain.njoints - 1
        return mp.chain, mp.pack_q([g[1] for g in groups]), mp.problem, (ee,), ee
    if robot == "planar_base":
        tree = planar_base()
        links, b = (tree.njoints - 1,), heave
    elif robot == "solo12":
        tree = lt.robots.solo12("float32", device="cpu")
        links = (0,) + tree.leaf_joints
        b = np.zeros((5, 6))
        b[0, 2] = 0.1
    else:
        tree = lt.robots.talos("float32", device="cpu")
        links = (tree.joint_names.index("gripper_left_joint"), 0)
        b = np.zeros((2, 6))
        b[0, 2] = 0.2
    dq = torch.as_tensor(0.3 * rng.normal(size=(B, tree.nv)), dtype=torch.float32)
    q = tree.integrate(tree.neutral().expand(B, tree.nq), dq)
    problem = lt.make_problem(tree, links, b=b, lb=-4 * np.ones(tree.nv),
                              ub=4 * np.ones(tree.nv))
    return tree, q, problem, links, links[-1]


ROBOTS = ["panda_arm", "planar_base", "solo12", "talos", "mixed"]


def run_path(name, robot="panda_arm", B=6, steps=3, T=4):
    """One entry point's call on ``robot``'s task; returns its result."""
    tree, q, problem, links, ee = task(robot, B)
    if name == "solve_delta_duals":
        return lt.solve_delta_duals(tree, lt.SolverParams(**FLAGSHIP), q, problem,
                                    fused=True)
    if name == "solve_fused":
        return fused.solve_fused(tree, lt.SolverParams(**FLAGSHIP), q, problem)
    if name in ("solve_tracking", "track_scan", "track_scan_delta"):
        solver = lt.DiffIkSolver(tree, lt.SolverParams(**TRACK), links,
                                 problem=problem, fused=True)
        if name == "solve_tracking":
            return [solver.solve_tracking(q, links[0], b=b) for b in b_sweep(T)]
        return solver.track_scan(q, b_sweep(T), links[0],
                                 refine="delta" if name == "track_scan_delta" else None)
    if name == "reach":
        dq = torch.as_tensor(0.35 * np.random.default_rng(1).normal(size=(B, tree.nv)),
                             dtype=torch.float32)
        _, _, oR, op = tree.fwd_kinematics(tree.integrate(q, dq))
        solver = lt.DiffIkSolver(tree, lt.SolverParams(max_iter=30, tol_abs=1e-4,
                                                       tol_rel=1e-4), (ee,), fused=True)
        return solver.reach(q, oR[:, ee].contiguous(), op[:, ee].contiguous(), steps=steps,
                            dt=0.1, gain=2.0, max_task_velocity=0.5)
    raise KeyError(name)


PATHS = ["solve_delta_duals", "solve_fused", "solve_tracking", "track_scan",
         "track_scan_delta", "reach"]


def leaves_of(x):
    out = []
    graphs._flatten(x, out)
    return out


def assert_bits(a, b):
    la, lb = leaves_of(a), leaves_of(b)
    assert len(la) == len(lb)
    assert graphs._flatten(a, []) == graphs._flatten(b, [])
    for x, y in zip(la, lb):
        assert torch.equal(x.nan_to_num(), y.nan_to_num())
        assert torch.equal(x.isnan(), y.isnan())


# --------------------------------------------------------------------------- #


def test_host_read_instrument_sees_reads():
    """The instrument first: the mode sees each way a value leaves a CPU
    tensor for the host."""
    x = torch.ones(3)
    with HostReads() as mode:
        bool(x[0])
        x.sum().item()
        x.tolist()
        float(x[0])
        int(x[0])
        [0, 1][x[0].long()]
        x.numpy()
        x.cpu()
        torch.tensor([0.0, 1.0])
        torch.as_tensor(np.ones(2))
        torch.asarray(1.0)
        torch.as_tensor(x)                # a tensor already: no host data
        x.to(torch.float64)
        x.copy_(x + 1)
    assert mode.calls == ["__bool__", "item", "tolist", "__float__", "__int__",
                          "__index__", "numpy", "cpu", "tensor of host data",
                          "as_tensor of host data", "asarray of host data"]
    moves = HostReads()
    moves.__torch_function__(torch.Tensor.to, (), (x, "cpu"))
    assert moves.calls == []
    meta = torch.empty(3, device="meta")
    moves.__torch_function__(torch.Tensor.to, (), (x, "meta"))
    moves.__torch_function__(torch.Tensor.copy_, (), (meta, x))
    assert moves.calls == ["to to the device", "copy_ to the device"]


@pytest.mark.parametrize("robot", ROBOTS)
@pytest.mark.parametrize("name", PATHS)
def test_captured_bodies_read_nothing_on_the_host(name, robot, fake_graphs, standin_loop):
    """The recorded call of every captured body (the flagship's
    `_delta_duals`, `solve_fused`, the tracking tick, the stream tick in
    both forms and the CLIK tick) hands no device value to the host and
    copies no host data to the device, on every kind of tree the kernel
    takes: one-dof joints, a PLANAR base, free-flyer trees with multi-dof
    joints and several constraints, and the batched-geometry chain."""
    run_path(name, robot)
    assert fake_graphs.reads, "no capture happened"
    assert all(reads == [] for reads in fake_graphs.reads), fake_graphs.reads


@pytest.mark.parametrize("name", PATHS)
def test_graphed_path_equals_eager_path_bit_for_bit(name, fake_graphs):
    """The graph path (static inputs, replay, fresh outputs; for the
    streams and CLIK the carry in static buffers and the tick counter)
    gives the eager path's bits on every field."""
    n0 = len(graphs.CAPTURES)
    first = run_path(name)               # captures (answered by its warm-up)
    assert len(graphs.CAPTURES) > n0
    n1 = len(graphs.CAPTURES)
    got = run_path(name)                 # replays
    assert len(graphs.CAPTURES) == n1
    with graphs.disable_graphs():
        want = run_path(name)
    assert_bits(got, want)
    assert_bits(first, want)


def test_results_are_fresh_tensors(fake_graphs):
    """A second call with other inputs leaves the first call's result as
    it was (no output aliases the graph's buffers), and a repeated call
    replays the same graph."""
    tree, q, problem = flagship()
    params = lt.SolverParams(**FLAGSHIP)
    lt.solve_delta_duals(tree, params, q.flip(0), problem, fused=True)   # captures
    n = len(graphs.CAPTURES)
    first = lt.solve_delta_duals(tree, params, q, problem, fused=True)
    kept = [t.clone() for t in leaves_of(first)]
    second = lt.solve_delta_duals(tree, params, q.flip(0), problem, fused=True)
    assert len(graphs.CAPTURES) == n
    assert not torch.equal(first.nu, second.nu)
    for a, b in zip(leaves_of(first), kept):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    # the result's state and its flags are one tensor, as on the eager path
    assert first.converged is first.state.converged


def test_warm_state_is_copied_never_written(fake_graphs):
    """A caller's warm state goes into the graph by copy; the graph never
    writes into its tensors."""
    tree, q, problem = flagship()
    params = lt.SolverParams(**FLAGSHIP)
    warm = lt.solve_delta_duals(tree, params, q, problem, fused=True).state
    kept = [t.clone() for t in leaves_of(warm)]
    lt.solve_delta_duals(tree, params, q, problem, fused=True, warm_state=warm)
    lt.solve_delta_duals(tree, params, q.flip(0), problem, fused=True, warm_state=warm)
    for a, b in zip(leaves_of(warm), kept):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


def _variant(change, tree):
    """(tree, params, q, problem, warm) of the flagship at B=6 on ``tree``,
    with one thing changed."""
    _, q, problem = flagship(B=8 if change == "B" else 6)
    params = lt.SolverParams(**FLAGSHIP)
    warm = None
    if change == "dtype":
        q = q.double()
    elif change == "params":
        params = params.replace(mu=0.05)
    elif change == "tree":
        # another topology: a joint renamed (another tree of the same
        # topology hits: tests/test_torch_topology.py)
        tree = dataclasses.replace(tree, joint_names=tree.joint_names[:-1] + ("tool",))
    elif change == "warm":
        with graphs.disable_graphs():       # the eager loop's solve is captured too
            warm = lt.solve_delta_duals(tree, params, q, problem, fused=False).state
    elif change == "A shape":
        problem = problem.replace(A=problem.A[None].expand(q.shape[0], 1, 6, 6).clone())
    return tree, params, q, problem, warm


@pytest.mark.parametrize("change", ["B", "dtype", "params", "tree", "warm", "A shape"])
def test_key_misses_on_what_the_body_bakes_in(change, fake_graphs):
    """The same inputs hit; a new batch size, input dtype, parameter,
    tree topology, warm state or a per-problem A misses."""
    tree, params, q, problem, warm = _variant(None, flagship()[0])
    solve = lt.solve_delta_duals
    solve(tree, params, q, problem, fused=True, warm_state=warm)
    n = len(graphs.CAPTURES)
    solve(tree, params, q + 0.1, problem.replace(b=problem.b * 2), fused=True,
          warm_state=warm)
    assert len(graphs.CAPTURES) == n, "same shapes and statics must hit"
    tree2, params2, q2, problem2, warm2 = _variant(change, tree)
    solve(tree2, params2, q2, problem2, fused=True, warm_state=warm2)
    assert len(graphs.CAPTURES) == n + 1, f"a new {change} must miss"
    solve(tree2, params2, q2, problem2, fused=True, warm_state=warm2)
    assert len(graphs.CAPTURES) == n + 1


def test_stream_key_covers_ticks_and_optional_inputs(fake_graphs):
    """A stream's graph is keyed by its tick count, whether A_seq and a
    per-tick q were given, and the slot's statics."""
    tree, q, problem = flagship(B=4)
    params = lt.SolverParams(**TRACK)
    b = b_sweep(3)
    calls = [dict(b_seq=b), dict(b_seq=b_sweep(4)),
             dict(b_seq=b, A_seq=torch.eye(6).expand(3, 6, 6)),
             dict(b_seq=b, q=q.expand(3, 4, 7))]
    n = len(graphs.CAPTURES)
    for i, kw in enumerate(calls):
        qq = kw.pop("q", q)
        lt.solve_stream(tree, params, qq, problem, 0, fused=True, **kw)
        lt.solve_stream(tree, params, qq, problem, 0, fused=True, **kw)
        assert len(graphs.CAPTURES) == n + i + 1


def test_disable_graphs_nests_and_restores():
    assert not graphs._DISABLED
    with graphs.disable_graphs():
        assert graphs._DISABLED
        with graphs.disable_graphs(False):
            assert not graphs._DISABLED
            with graphs.disable_graphs():
                assert graphs._DISABLED
            assert not graphs._DISABLED
        assert graphs._DISABLED
    assert not graphs._DISABLED
    with pytest.raises(KeyError):
        with graphs.disable_graphs():
            raise KeyError("restored on the way out")
    assert not graphs._DISABLED


@pytest.mark.parametrize("block", ["disable_graphs", "debug_nans", "requires_grad"])
def test_uncaptured_blocks(block, fake_graphs):
    """Under `disable_graphs()`, under `debug_nans()` (it reads the device
    after every operator) and for inputs that require a gradient the entry
    points run eagerly: nothing is captured."""
    tree, q, problem = flagship()
    params = lt.SolverParams(**FLAGSHIP)
    n = len(graphs.CAPTURES)
    if block == "disable_graphs":
        with graphs.disable_graphs():
            lt.solve_delta_duals(tree, params, q, problem, fused=True)
    elif block == "debug_nans":
        with lt.utils.debug_nans():
            lt.solve_delta_duals(tree, params, q, problem, fused=True)
    else:
        lt.solve_delta_duals(tree, params, q.requires_grad_(), problem, fused=True)
    assert len(graphs.CAPTURES) == n
    lt.solve_delta_duals(tree, params, q.detach(), problem, fused=True)
    assert len(graphs.CAPTURES) == n + 1


def test_eager_loop_and_cpu_run_uncaptured():
    """Without the stand-in, CPU tensors never capture, and neither does
    the eager loop (fused=False), which reads the device every body call."""
    tree, q, problem = flagship()
    n = len(graphs.CAPTURES)
    lt.solve_delta_duals(tree, lt.SolverParams(**FLAGSHIP), q, problem, fused=True)
    assert len(graphs.CAPTURES) == n
    assert graphs.cached_graphs() == 0


def test_fused_false_runs_uncaptured(fake_graphs):
    """Off the kernel the masked while loop is captured as a WHILE node
    (`graphs.while_loop`); only a verbose solve, which prints from the host
    every body call, runs uncaptured."""
    tree, q, problem = flagship()
    n = len(graphs.CAPTURES)
    verbose = dict(FLAGSHIP, verbose=True)
    lt.solve_delta_duals(tree, lt.SolverParams(**verbose), q, problem, fused=False)
    lt.solve_stream(tree, lt.SolverParams(**dict(TRACK, verbose=True)), q, problem, 0,
                    b_sweep(2), fused=False)
    assert len(graphs.CAPTURES) == n
    lt.solve_delta_duals(tree, lt.SolverParams(**FLAGSHIP), q, problem, fused=False)
    lt.solve_stream(tree, lt.SolverParams(**TRACK), q, problem, 0, b_sweep(2), fused=False)
    assert len(graphs.CAPTURES) == n + 2
    for cap in graphs.CAPTURES[n:]:
        assert cap.launches == 0 and cap.loops, cap


@pytest.mark.parametrize("name,launches,ticks", [
    ("solve_delta_duals", 2, 1), ("solve_fused", 1, 1), ("track_scan", 1, 4), ("reach", 1, 3)])
def test_replays_count_the_launches_they_recorded(name, launches, ticks, fake_graphs,
                                                  standin_loop):
    """A capture records its launches; each replay (a scan: each tick)
    adds them to the launch count.  A first call launches as an eager call
    does (its warm-up is its work); a first scan adds its warm-up tick."""
    n0 = fused.LAUNCHES
    run_path(name)
    assert graphs.CAPTURES[-1].launches == launches
    first = launches * (ticks + 1 if ticks > 1 else 1)
    assert fused.LAUNCHES - n0 == first
    run_path(name)
    assert fused.LAUNCHES - n0 == first + launches * ticks
    with graphs.disable_graphs():
        run_path(name)
    assert fused.LAUNCHES - n0 == first + 2 * launches * ticks


def test_failed_capture_raises_and_caches_nothing(fake_graphs):
    """A body that fails in its capture raises under the entry point's
    name; nothing is cached and the next good call captures."""
    tree, q, _ = flagship()
    calls = []

    def bad(tree, x):
        calls.append(1)
        if len(calls) == 2:        # the warm-up passes, the capture fails
            raise ValueError("not capturable")
        return x * 2

    n = graphs.cached_graphs()
    with pytest.raises(RuntimeError, match="bad body: capturing the CUDA graph failed"):
        graphs.run("bad body", tree, (), bad, (q,))
    assert graphs.cached_graphs() == n
    assert not graphs._INSIDE.active
    out = graphs.run("good body", tree, (), lambda tree, x: x * 2, (q,))
    assert torch.equal(out, q * 2) and graphs.cached_graphs() == n + 1


def test_scan_refuses_a_carry_that_changes(fake_graphs):
    """A tick must hand back a carry like the one it was given (its first,
    warm-up tick raises as an eager call would)."""
    tree, q, _ = flagship()
    with pytest.raises(ValueError, match="another structure"):
        graphs.scan("growing", tree, (), lambda t, c, x, k: (c.double(), c), q, None, None, 2)


def test_scan_carry_that_swaps_buffers(fake_graphs):
    """A tick whose new carry is another carry buffer as it was (a swap)
    reads it before it is overwritten, as the eager ticks do."""
    tree, q, _ = flagship()
    a, b = q[:, :3].contiguous(), q[:, 3:6].contiguous() * 2

    def tick(t, c, x, k):
        return (c[1], c[0] + 1), c[0]

    got = graphs.scan("swap", tree, (), tick, (a, b), None, None, 3)
    with graphs.disable_graphs():
        want = graphs.scan("swap", tree, (), tick, (a, b), None, None, 3)
    assert_bits(got, want)


def test_no_recompile_guard_counts_captures(fake_graphs):
    """A capture inside the guard is an event ("cuda graph capture", the
    counterpart of the JAX guard's backend compile); a replay is none."""
    tree, q, problem = flagship()
    params = lt.SolverParams(**FLAGSHIP)
    with pytest.raises(RuntimeError, match="cuda graph capture"):
        with lt.utils.no_recompile_guard():
            lt.solve_delta_duals(tree, params, q, problem, fused=True)
    with lt.utils.no_recompile_guard() as events:
        lt.solve_delta_duals(tree, params, q, problem, fused=True)
    assert events.count == 0
    with lt.utils.no_recompile_guard(allowed=1) as events:
        lt.solve_delta_duals(tree, params, q[:3], problem, fused=True)
    assert events.names == ["cuda graph capture"]


def test_graphs_and_casts_go_with_their_tree(fake_graphs):
    """A tree's cast trees are dropped when the tree is; its graphs are not
    (they are keyed by its topology and hold no reference to it, as JAX's
    compile cache holds none to a pytree) and go at `clear_graphs`.
    `astype` hands back one cast tree per (tree, dtype), and the tree
    itself for its own dtype."""
    tree, q, _ = flagship()
    tree = dataclasses.replace(tree)           # one that the robot cache does not hold
    assert tree.astype(torch.float32) is tree
    t64 = tree.astype(torch.float64)
    assert tree.astype(torch.float64) is t64 and t64.dtype == torch.float64
    assert torch.equal(t64.placement_p, tree.placement_p.double())
    graphs.run("twice", tree, (), lambda tree, x: x * 2, (q,))
    assert graphs.cached_graphs() == 1
    tid, ref = id(tree), weakref.ref(tree)
    assert tid in ttree._DERIVED
    del tree, t64
    gc.collect()
    assert ref() is None and tid not in ttree._DERIVED
    assert graphs.cached_graphs() == 1
    graphs.clear_graphs()
    assert graphs.cached_graphs() == 0


def test_tracking_keeps_the_problems_bound_tensors(fake_graphs):
    """The graphed tracking tick updates the solver's A and b and keeps its
    lb / ub tensors (their lb > ub check is cached by identity)."""
    tree, q, problem = flagship(B=4)
    solver = lt.DiffIkSolver(tree, lt.SolverParams(**TRACK), (6,), problem=problem,
                             fused=True)
    lb, ub = solver.problem.lb, solver.problem.ub
    A = torch.eye(6) * 0.5
    solver.solve_tracking(q, 6, A=A, b=torch.full((6,), 0.1))
    assert solver.problem.lb is lb and solver.problem.ub is ub
    assert torch.equal(solver.problem.A[0], A)
    assert torch.equal(solver.problem.b[0], torch.full((6,), 0.1))


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python -m pytest tests/test_torch_graphs.py -m cuda --noconftest`")


def _on_card(x):
    return graphs._map(lambda t: t.cuda(), x)


def card_path(name, B=512, T=5, steps=4):
    """The flagship task on the card through one entry point."""
    tree = lt.robots.panda_arm("float32", device="cuda")
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.uniform(-np.pi, np.pi, (B, 7)), dtype=torch.float32, device="cuda")
    problem = lt.make_problem(tree, (6,), b=np.array([[0, 0, 0.2, 0, 0, 0]]),
                              lb=-4 * np.ones(7), ub=4 * np.ones(7))

    def run():
        if name == "solve_delta_duals":
            return lt.DiffIkSolver(tree, lt.SolverParams(**FLAGSHIP), (6,), problem=problem,
                                   fused="require").solve_refined(q)
        solver = lt.DiffIkSolver(tree, lt.SolverParams(**TRACK), (6,), problem=problem,
                                 fused="require")
        if name == "solve_tracking":
            return [solver.solve_tracking(q, 6, b=b) for b in _on_card(b_sweep(T))]
        if name == "track_scan":
            return solver.track_scan(q, _on_card(b_sweep(T)))
        q0 = tree.neutral().expand(B, 7).contiguous()
        _, _, oR, op = tree.fwd_kinematics(q)
        return solver.reach(q0, oR[:, 6].contiguous(), op[:, 6].contiguous(), 6,
                            steps=steps, dt=0.1, gain=2.0)

    return run


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["solve_delta_duals", "solve_tracking", "track_scan", "reach"])
def test_card_graph_equals_eager_launches_bit_for_bit(name):
    _need_card()
    run = card_path(name)
    first = run()                           # the capture
    got = run()                             # a replay
    with graphs.disable_graphs():
        want = run()
    torch.cuda.synchronize()
    assert_bits(got, want)
    assert_bits(first, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,launches", [
    ("solve_delta_duals", 2), ("track_scan", 5), ("reach", 4)])
def test_card_replay_counts_launches(name, launches):
    _need_card()
    run = card_path(name)
    run()
    torch.cuda.synchronize()
    fused.LAUNCHES = 0
    run()
    torch.cuda.synchronize()
    assert fused.LAUNCHES == launches


@pytest.mark.cuda
def test_card_results_are_fresh_and_calls_do_not_sync():
    _need_card()
    tree = lt.robots.panda_arm("float32", device="cuda")
    q = torch.rand((256, 7), device="cuda") * 2 - 1
    problem = lt.make_problem(tree, (6,), b=np.array([[0, 0, 0.2, 0, 0, 0]]),
                              lb=-4 * np.ones(7), ub=4 * np.ones(7))
    params = lt.SolverParams(**FLAGSHIP)
    first = lt.solve_delta_duals(tree, params, q, problem, fused="require")
    kept = first.nu.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = lt.solve_delta_duals(tree, params, q.flip(0), problem, fused="require")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(first.nu, kept) and not torch.equal(first.nu, second.nu)


@pytest.mark.cuda
def test_card_failed_capture_raises():
    _need_card()
    tree = lt.robots.panda_arm("float32", device="cuda")
    x = torch.ones(4, device="cuda")
    with pytest.raises(RuntimeError, match="capturing the CUDA graph failed"):
        graphs.run("host read", tree, (), lambda _, t: t * float(t.sum()), (x,))
    torch.cuda.synchronize()
    assert torch.equal(graphs.run("after", tree, (), lambda _, t: t + 1, (x,)), x + 1)


def card_task(robot, B=512):
    """``task(robot, B)`` on the card."""
    tree, q, problem, links, ee = task(robot, B)
    return tree.to(device="cuda"), _on_card(q), _on_card(problem), links, ee


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ROBOTS[1:])
def test_card_graph_equals_eager_on_every_tree(robot):
    """The flagship's delta-duals solve on each other kind of tree the
    kernel takes (a PLANAR base, multi-dof joints with several constraints,
    the batched-geometry chain): captured, replayed, and equal to the same
    call launched eagerly, bit for bit."""
    _need_card()
    graphs.clear_graphs()                    # a graph of the topology may be held
    tree, q, problem, links, _ = card_task(robot)
    solver = lt.DiffIkSolver(tree, lt.SolverParams(**FLAGSHIP), links, problem=problem,
                             fused="require")
    n = len(graphs.CAPTURES)
    first = solver.solve_refined(q)
    got = solver.solve_refined(q)
    assert len(graphs.CAPTURES) == n + 1
    with graphs.disable_graphs():
        want = solver.solve_refined(q)
    torch.cuda.synchronize()
    assert_bits(got, want)
    assert_bits(first, want)


@pytest.mark.cuda
def test_card_multistart_batch_equals_eager():
    """A multistart batch scored by the delta-duals solve (a graph) ranks
    what the eagerly launched one ranks, bit for bit."""
    _need_card()
    tree, _, problem, _, _ = card_task("panda_arm")
    params = lt.SolverParams(**FLAGSHIP)

    def batch():
        gen = torch.Generator(device="cuda").manual_seed(3)
        return lt.parallel.solve_multistart(
            tree, params, problem, gen, 1024, k=4,
            solve_fn=lambda t, p, qs, pr: lt.solve_delta_duals(t, p, qs, pr,
                                                                fused="require"))

    first, got = batch(), batch()
    with graphs.disable_graphs():
        want = batch()
    torch.cuda.synchronize()
    assert_bits(got, want)
    assert_bits(first, want)


@pytest.mark.cuda
def test_card_graph_replays_after_a_smaller_frame():
    """Two graphs of one kernel instantiation with different shared memory
    a block: the larger one replayed after the smaller one's warm-up and
    capture still launches, and equals the eager call."""
    _need_card()
    tree, q, problem, _, _ = card_task("panda_arm")
    params = lt.SolverParams(**FLAGSHIP)
    big, small = 16, 2
    sizes = {fused.problems_per_block(tree.nvs, 1, torch.float32, t) for t in (big, small)}
    assert sizes == {big, small}

    def run(tile):
        return fused.solve_fused(tree, params, q, problem, batch_tile=tile)

    run(big)
    run(small)
    got = run(big)
    with graphs.disable_graphs():
        want = run(big)
    torch.cuda.synchronize()
    assert_bits(got, want)


def turned_copy(tree, seed, deg=3.0, dp=0.02):
    """A tree of ``tree``'s topology with each axis turned by up to ``deg``
    degrees about a random direction and each placement moved by up to
    ``dp`` per coordinate (numpy, ``seed``), on its device."""
    rng = np.random.default_rng(seed)
    a = tree.axis.double().cpu().numpy()
    k = rng.normal(size=a.shape)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    ang = np.deg2rad(rng.uniform(0, deg, (a.shape[0], 1)))
    a = a * np.cos(ang) + np.cross(k, a) * np.sin(ang) + k * (k * a).sum(-1, keepdims=True) * (
        1 - np.cos(ang))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    kw = dict(dtype=tree.dtype, device=tree.device)
    dpos = torch.as_tensor(rng.uniform(-dp, dp, tuple(tree.placement_p.shape)), **kw)
    return dataclasses.replace(tree, axis=torch.as_tensor(a, **kw),
                               placement_p=tree.placement_p + dpos)


@pytest.mark.cuda
@pytest.mark.parametrize("path,dtype", [("solve_delta_duals", "float32"),
                                        ("solve_delta_duals", "float64"),
                                        ("solve_fused", "float32")])
def test_card_graph_reads_each_trees_subspaces(path, dtype):
    """A graph of the kernel's path on panda_arm, then on a copy with its
    axes turned and placements moved, then on panda_arm again: one capture,
    and each result equals the eagerly launched call on its own tree bit
    for bit, so the kernel's S operand (and, for a float64 tree, its float32
    cast) was recomputed from the copy's leaves."""
    _need_card()
    graphs.clear_graphs()
    tree = dataclasses.replace(lt.robots.panda_arm(dtype, device="cuda"))
    other = turned_copy(tree, 3)
    _, q, problem, _, _ = card_task("panda_arm")
    q = q.to(tree.dtype)
    params = lt.SolverParams(**FLAGSHIP)

    def run(t):
        if path == "solve_fused":
            return fused.solve_fused(t, params, q, problem)
        return lt.solve_delta_duals(t, params, q, problem, fused="require")

    n = len(graphs.CAPTURES)
    got = [run(tree), run(other), run(tree)]
    assert len(graphs.CAPTURES) == n + 1
    with graphs.disable_graphs():
        want = [run(tree), run(other)]
    torch.cuda.synchronize()
    assert_bits(got[0], want[0])
    assert_bits(got[1], want[1])
    assert_bits(got[2], want[0])
    assert not torch.equal(got[0].nu, got[1].nu)


@pytest.mark.cuda
def test_card_jit_step_over_the_tree():
    """A `utils.jit` step whose tree is an argument: another tree of the
    topology replays the capture and answers with its own geometry (the
    float32 cast and S operand of a float64 tree), equal to the eager step
    on it bit for bit."""
    _need_card()
    tree = dataclasses.replace(lt.robots.panda_arm("float64", device="cuda"))
    other = turned_copy(tree, 4)
    _, q, problem, _, _ = card_task("panda_arm", B=64)
    q = q.double()
    params = lt.SolverParams(**FLAGSHIP)
    step = lt.utils.jit(
        lambda t, qq, pr: lt.solve_delta_duals(t, params, qq, pr, fused="require").nu)
    step(tree, q, problem)
    n = len(graphs.CAPTURES)
    got = [step(other, q, problem), step(tree, q, problem)]
    assert len(graphs.CAPTURES) == n
    with graphs.disable_graphs():
        want = [step(other, q, problem), step(tree, q, problem)]
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[0], got[1])
