"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's entry in BENCHMARK.json names its
configuration (`configs/`) and traffic mix (`traffic/`); its metrics are read
by `metrics/<name>.py` (or `metrics/<name before the first dot>.py`), its
limits are `limits/<cell>.json`.  The run makes its inputs from the seed,
warms up (set-up), sends requests in a closed loop for the window, with
``--trace 1`` profiles one cycle of the traffic after it (the request
loop's `cycle()`: a pool's batches, a trajectory's ticks), then checks the answers
kept from the window against the plain reference (`reference/`) and prints
one JSON line.  Without a CUDA device it exits with an error; ``--rehearse``
runs the same path on the CPU at a tiny batch and prints no device metric.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "loik_tpu")
STRETCH_TRIES = 3


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def metric_reader(name: str):
    """`metrics/<name>.py`, else `metrics/<name up to its first dot>.py`."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.isfile(path):
            from inputs import load_module

            return load_module(path, f"bench_metric_{stem}").read
    raise FileNotFoundError(f"no reader for metric {name!r} in {HERE}/metrics")


def cell_metrics(spec: dict, kind: str, workload: str) -> List[dict]:
    """The `end_to_end` or `per_layer` metrics this cell reports."""
    return [m for m in spec[kind] if "workloads" not in m or workload in m["workloads"]]


@dataclasses.dataclass
class Shape:
    nvs: List[int]
    parents: List[int]
    NC: int
    B: int


@dataclasses.dataclass
class Context:
    """What the metric readers read."""
    setup_s: float
    window: object                     # drive.Window
    shape: Shape
    launches_per_call: int
    trace: object = None               # trace.Trace of the profiled stretch
    calls: int = 0
    iterations: list = dataclasses.field(default_factory=list)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
        return out.strip().splitlines()[0].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def profile_stretch(torch, req, first: int, count: int):
    """Profile ``count`` calls from request ``first``; (window, trace)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import devtrace
    import drive

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        win = drive.run_calls(req, first, count=count, iters=True, label=record_function)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        tr = devtrace.Trace.load(path)
    return win, tr


def check(torch, req, kept: Dict, precision: str = "float64", block: int = 65536):
    """The comparison's numbers over every kept answer (`reference.check`),
    the reference run in blocks of about ``block`` problems.  With another
    ``precision`` the reference's own answers in that precision take the
    program's place (a control)."""
    from reference import check as ref

    cell = req.prog.cell
    answers = [req.answer(i, nu, conv) for i, nu, conv in kept.values()]
    A, lo, hi = req.prog.A, req.prog.lo, req.prog.hi
    parts = []
    per = max(1, block // cell.batch)
    for a in range(0, len(answers), per):
        grp = answers[a:a + per]
        q = torch.cat([g.q for g in grp])
        b = torch.cat([g.b.expand(g.q.shape[0], *g.b.shape[-2:]) for g in grp])
        nu = torch.cat([g.nu for g in grp])
        conv = torch.cat([g.converged for g in grp])
        x, solved = ref.optimum(cell.robot, cell.links, q, A, b, lo, hi)
        if precision != "float64":
            nu, conv = ref.optimum(cell.robot, cell.links, q, A, b, lo, hi, precision)
        parts.append(ref.judge(cell.robot, cell.links, q, A, b, lo, hi, nu, conv, x, solved))
    return ref.numbers(ref.Judged.cat(parts), cell.limits["residual"])


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): each number at most its limit."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(numbers[k] <= limits[k] for k in limits), shown


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="run on the CPU at a tiny batch; prints no device metric")
    p.add_argument("--batch", type=int, default=8, help="the rehearsal's batch")
    p.add_argument("--samples", help="write each call of the window (start s, latency ms, "
                   "host ms) to this JSON file")
    args = p.parse_args(argv)

    # caches of the program inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, ".bench_cache", "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".bench_cache", "triton"))
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import torch

    import drive
    import inputs
    import stats

    spec = inputs.benchmark_spec(ROOT)
    entry = {w["name"]: w for w in spec["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"needs {entry['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cell = inputs.load_cell(args.workload, spec)
    if args.rehearse:
        cell.config["batch"] = args.batch
        cell.traffic = {**cell.traffic, "batch": None}
    card = card_line() if device.type == "cuda" else "cpu"

    parts = {"imports": process_age_s()}
    prog = drive.Program(cell, device)
    parts["program"] = process_age_s()
    req = drive.requests(prog, args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    parts["inputs"] = process_age_s()
    drive.run_calls(req, 0, count=req.settle)                    # warm-up: the captures
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    setup_s = process_age_s()
    parts["warm-up"] = setup_s
    win = drive.run_calls(req, req.settle, seconds=args.seconds)
    kept = dict(win.kept)
    if args.samples:
        with open(args.samples, "w") as f:
            json.dump({"start_s": win.start_s, "latency_ms": win.latency_ms,
                       "host_ms": win.host_ms}, f)
    shape = Shape(nvs=[j.nv for j in cell.robot.joints],
                  parents=[j.parent for j in cell.robot.joints],
                  NC=len(cell.links), B=cell.batch)
    ctx = Context(setup_s, win, shape, req.launches_per_call)

    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                   "count": entry["chips"]}
    breakdown = None
    if args.trace and device.type == "cuda":
        first = req.settle + win.calls
        # one cycle of the traffic, so that the stretch does the window's work
        count = req.cycle()
        for _ in range(STRETCH_TRIES):
            swin, tr = profile_stretch(torch, req, first, count)
            kept.update(swin.kept)
            first += swin.calls
            if tr.launches() >= req.launches_per_call * swin.calls:
                break
            print(f"trace holds {tr.launches()} launches of "
                  f"{req.launches_per_call * swin.calls}: profiling a longer stretch",
                  file=sys.stderr)
            count *= 2
        ctx.trace, ctx.calls, ctx.iterations = tr, swin.calls, swin.iters
        busy_us, _ = tr.busy_span_us()
        device_info["busy_s"] = busy_us * 1e-6
        device_info["window_s"] = swin.seconds
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    if device.type == "cuda":
        device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())

    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 4

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    if device.type == "cuda":
        for m in cell_metrics(spec, kind, args.workload):
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the program's state goes before the reference runs
    req.release()
    if device.type == "cuda":
        from loik_tpu_torch.utils import graphs

        graphs.clear_graphs()
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = check(torch, req, kept)
    t_ref = time.perf_counter() - t_ref
    correct, shown = verdict(numbers, cell.limits)
    lat, q = win.latency_ms, max(1, len(win.latency_ms) // 4)
    ends = list(parts.values())
    print("set-up s: " + ", ".join(f"{k} {b - a:.3f}" for k, a, b in
                                   zip(parts, [0.0] + ends, ends)), file=sys.stderr)
    print(f"window: {win.calls} calls in {win.seconds:.3f} s, latency ms p50 "
          f"{stats.percentile(lat, 50):.4f} p95 {stats.percentile(lat, 95):.4f}, mean of the "
          f"first and last quarter {sum(lat[:q]) / q:.4f} {sum(lat[-q:]) / q:.4f}, host ms "
          f"a call {sum(win.host_ms) / len(win.host_ms):.4f}", file=sys.stderr)
    print(f"checked {numbers['n']} answers, {numbers['n_converged']} flagged converged, "
          f"{numbers['n_solved']} solved by the reference, in {t_ref:.2f} s", file=sys.stderr)
    for k, v in shown.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    out = {"correct": correct, "attempted": win.calls, "failed": 0, "metrics": metrics,
           "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["card"] = card
    out["checks"] = shown
    if args.rehearse:
        print("rehearsal (CPU, no device metric): " + json.dumps(out))
        return 0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
