"""Nodes per call of the refined solve's float64 KKT evaluation, its
scales, the delta problem and the delta state (the program's phase
``solver.kkt64``) in the graphs replayed in the profiled stretch (the
program's counters, `utils.graphs.copy_stats`, taken at capture)."""

import os

from inputs import load_module

_nodes = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "graph_nodes.py"),
                     "bench_metric_graph_nodes")


def read(ctx):
    return _nodes.per_call(ctx, "solver.kkt64")
