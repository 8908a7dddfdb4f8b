"""Split one benchmark cell's traced stretch by the program's phases and spans.

    python3 tools/phase_split.py --workload panda_arm.plan --seed 7 [--seconds 2]
        [--root DIR] [--out FILE]

Runs the cell as `benchmark/run.py` does (set-up, a closed-loop window of
``--seconds``), profiles one cycle of its traffic (`run.profile_stretch`)
and prints one JSON line, every time per call of the stretch:

- ``phases_ms``: device ms of each solver phase in the graph replays
  (`utils.observability.phase_device_us`; ``null``: outside every phase),
  ``replays`` and ``unattributed``;
- ``kernel_ms``, ``small_ops_ms``, ``copy_ms``: the benchmark's split of all
  device time (`devtrace.Trace.split_us`), ``replay_ms``: the device time of
  the operations the graph launches ran, and ``outside_ms``: every other
  device operation, by name;
- ``spans_ms``: each span prefix's host ms and the CUDA runtime ms inside it
  (``bench.call``, ``api.``, ``graphs.key:``, ``graphs.copy_in:``,
  ``graphs.replay:``, ``graphs.clone_out:``), under the profiler;
- ``window_host_ms``: the host's time a call in the untraced window (the
  benchmark's ``host_ms``), and ``steps_host_ms``: per tag, the graph
  layer's steps a call on the host clock off the profiler
  (`utils.graphs.copy_stats`: key, copy-in, replay, clone-out);
- ``captures``: each capture's tag, nodes and phases.

``--root``: the checkout whose program and benchmark run (default: this
one; an older checkout without phases gives ``phases_ms`` null).  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PREFIXES = ("bench.call", "api.", "graphs.key:", "graphs.copy_in:", "graphs.replay:",
            "graphs.clone_out:")
STEPS = ("key_ns", "copy_in_ns", "replay_ns", "clone_out_ns")


def span_ms(tr, prefix, calls):
    """(host ms, CUDA runtime ms inside) per call of the spans ``prefix...``."""
    spans = [e for e in tr.host if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(prefix)]
    runtime = [e for e in tr.host if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    total = inner = 0.0
    for s in spans:
        a = float(s["ts"])
        b = a + float(s["dur"])
        total += b - a
        inner += sum(float(e["dur"]) for e in runtime if e.get("tid") == s.get("tid")
                     and a <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= b)
    return [total / 1e3 / calls, inner / 1e3 / calls]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--root", default=os.path.dirname(HERE))
    p.add_argument("--out", help="also write the line to this file")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "benchmark"), root]
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import drive
    import inputs
    import run
    from loik_tpu_torch.utils import graphs
    from loik_tpu_torch.utils import observability

    spec = inputs.benchmark_spec(root)
    cell = inputs.load_cell(args.workload, spec)
    prog = drive.Program(cell, torch.device("cuda", 0))
    req = drive.requests(prog, args.seed)
    drive.run_calls(req, 0, count=req.settle)
    torch.cuda.synchronize()
    gc.collect()
    win = drive.run_calls(req, req.settle, seconds=args.seconds)
    window_host_ms = sum(win.host_ms) / len(win.host_ms)
    stats = getattr(graphs, "copy_stats", dict)()
    win, tr = run.profile_stretch(torch, req, req.settle + win.calls, req.cycle())
    calls = win.calls

    fn = getattr(observability, "phase_device_us", None)
    split = fn(tr.device + tr.host) if fn is not None else None
    launched = {(e.get("args") or {}).get("correlation") for e in tr.host
                if "GraphLaunch" in e.get("name", "")}
    replay_us = 0.0
    outside = collections.defaultdict(float)
    for e in tr.device:
        if (e.get("args") or {}).get("correlation") in launched:
            replay_us += float(e.get("dur", 0))
        else:
            outside[e.get("name", "?")[:100]] += float(e.get("dur", 0))
    line = dict(
        workload=args.workload, seed=args.seed, calls=calls, card=run.card_line(),
        phases_ms=None if split is None else {
            str(k): v / 1e3 / calls for k, v in sorted(split.us.items(), key=str)},
        replays=None if split is None else split.replays,
        unattributed=None if split is None else split.unattributed,
        **{f"{k}_ms": v / 1e3 / calls for k, v in tr.split_us().items()},
        replay_ms=replay_us / 1e3 / calls,
        outside_ms={k: v / 1e3 / calls
                    for k, v in sorted(outside.items(), key=lambda kv: -kv[1])},
        spans_ms={pfx: span_ms(tr, pfx, calls) for pfx in PREFIXES},
        window_host_ms=window_host_ms,
        steps_host_ms={tag: {k[:-3]: v[k] / 1e6 / v["timed"] for k in STEPS}
                       for tag, v in stats.items() if v.get("timed")},
        captures=[[c.tag, c.nodes, [list(ph) for ph in getattr(c, "phases", ())]]
                  for c in graphs.CAPTURES],
    )
    text = json.dumps(line)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
