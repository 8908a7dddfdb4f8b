"""CUDA runtime calls per call that launch a kernel or a graph or copy or
set memory, inside the program's request span (``api.<method>``)."""

import spans


def read(ctx):
    return spans.host_launches(ctx)
