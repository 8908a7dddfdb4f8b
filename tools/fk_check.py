#!/usr/bin/env python3
"""The FK kernel (`loik_tpu_torch/kernels/csrc/fk.cu`) against the plain FK
on the card: the order of cuBLAS's and PyTorch's sums, the kernel's bits
per joint type, and the times.

    python3 tools/fk_check.py [--B 1 333 4096 16384] [--out FILE]

Three parts, one JSON object (a summary printed; the whole object also
written to ``--out``):

- ``orders``: the plain FK's 3 x 3 products (`spatial.se3_compose`, the
  universal joint's and the mimic pair's `@`: a shared 3 x 3 times a batch,
  and a batch times a batch, each of matrices and of vectors) go through
  cuBLAS, and its norm of a quaternion (`spatial.quat_to_rotmat`) through
  a PyTorch reduction.  A small CUDA probe, built with the kernels'
  flags, computes each element in every candidate order of its three
  (four) terms, plain or with fused multiply-adds; the share of elements
  equal to PyTorch's, in float32 and float64, at each B.  csrc/fk.cu
  sums in the order that matches.
- ``bits``: `kernels.fk.fk_limi` against `fwd_kinematics` (the plain FK)
  per joint type on trees that hold every type (`builders.random_tree`
  with `force_types`), batched geometry, panda_arm and talos: the entries
  that differ and the largest difference, in units of 2^-22 (rotations)
  and 2^-22 max(1, |p|) (translations).
- ``times``: at panda_arm's B 16384 and talos' B 4096 (float32), the
  kernel's device time a launch (torch.profiler), the plain FK's device
  time and its operations a call as a captured graph, and the byte bound
  (q read once, liMi written once, at 3.35 TB/s).

Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import loik_tpu_torch as lt  # noqa: E402
from loik_tpu_torch import spatial  # noqa: E402
from loik_tpu_torch.kernels import _build, fk  # noqa: E402
from loik_tpu_torch.solver.solve import full_f32_matmul  # noqa: E402

from fk_fixtures import configurations, per_problem, plain, zoo  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
DEVICE = "cuda"

# the candidate orders of a sum of three products x_k y_k (p_k, rounded) and
# of four squares; `fma(k, acc)` is x_k y_k + acc rounded once
PROBE = r"""
#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ float f(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double f(double a, double b, double c) { return fma(a, b, c); }

// variant v < 6: fma chain over the permutation v; v < 9: (p_a + p_b) + p_c;
// v < 12: fma(c, p_a + p_b); v < 18: p_a + fma(b, p_c)
template <typename T>
__global__ void dot3(const T* X, const T* Y, T* out, long long n, int v) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int perm[6][3] = {{0, 1, 2}, {0, 2, 1}, {1, 0, 2}, {1, 2, 0}, {2, 0, 1}, {2, 1, 0}};
  const int pair[3][3] = {{0, 1, 2}, {0, 2, 1}, {1, 2, 0}};
  const T* x = X + 3 * i;
  const T* y = Y + 3 * i;
  T r;
  if (v < 6) {
    const int* o = perm[v];
    r = f(x[o[2]], y[o[2]], f(x[o[1]], y[o[1]], x[o[0]] * y[o[0]]));
  } else if (v < 9) {
    const int* o = pair[v - 6];
    r = (x[o[0]] * y[o[0]] + x[o[1]] * y[o[1]]) + x[o[2]] * y[o[2]];
  } else if (v < 12) {
    const int* o = pair[v - 9];
    r = f(x[o[2]], y[o[2]], x[o[0]] * y[o[0]] + x[o[1]] * y[o[1]]);
  } else {
    const int* o = perm[v - 12];
    r = x[o[0]] * y[o[0]] + f(x[o[1]], y[o[1]], x[o[2]] * y[o[2]]);
  }
  out[i] = r;
}

// variant 0: (s0 + s1) + (s2 + s3); 1: (s0 + s2) + (s1 + s3);
// 2: ((s0 + s1) + s2) + s3; 3: fma chain 0..3; 4: fma(1, s0) + fma(3, s2);
// 5: ((s3 + s2) + s1) + s0; then the square root
template <typename T>
__global__ void norm4(const T* X, T* out, long long n, int v) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T* x = X + 4 * i;
  const T s0 = x[0] * x[0], s1 = x[1] * x[1], s2 = x[2] * x[2], s3 = x[3] * x[3];
  T r;
  switch (v) {
    case 0: r = (s0 + s1) + (s2 + s3); break;
    case 1: r = (s0 + s2) + (s1 + s3); break;
    case 2: r = ((s0 + s1) + s2) + s3; break;
    case 3: r = f(x[3], x[3], f(x[2], x[2], f(x[1], x[1], s0))); break;
    case 4: r = f(x[1], x[1], s0) + f(x[3], x[3], s2); break;
    default: r = ((s3 + s2) + s1) + s0; break;
  }
  out[i] = sqrt(r);
}

extern "C" {
int probe_dot3_f32(const float* X, const float* Y, float* out, long long n, int v, void* s) {
  dot3<float><<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)s>>>(X, Y, out, n, v);
  return (int)cudaGetLastError();
}
int probe_dot3_f64(const double* X, const double* Y, double* out, long long n, int v, void* s) {
  dot3<double><<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)s>>>(X, Y, out, n, v);
  return (int)cudaGetLastError();
}
int probe_norm4_f32(const float* X, float* out, long long n, int v, void* s) {
  norm4<float><<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)s>>>(X, out, n, v);
  return (int)cudaGetLastError();
}
int probe_norm4_f64(const double* X, double* out, long long n, int v, void* s) {
  norm4<double><<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)s>>>(X, out, n, v);
  return (int)cudaGetLastError();
}
}
"""

DOT_NAMES = ([f"fma {''.join(map(str, p))}" for p in itertools.permutations(range(3))]
             + [f"({a}+{b})+{c}" for a, b, c in ((0, 1, 2), (0, 2, 1), (1, 2, 0))]
             + [f"fma {c} on ({a}+{b})" for a, b, c in ((0, 1, 2), (0, 2, 1), (1, 2, 0))]
             + [f"{p[0]} + fma {p[1]} on {p[2]}" for p in itertools.permutations(range(3))])
NORM_NAMES = ["(0+1)+(2+3)", "(0+2)+(1+3)", "((0+1)+2)+3", "fma chain", "fma 1 on 0 + fma 3 on 2",
              "((3+2)+1)+0"]


def build_probe(tmp):
    src = os.path.join(tmp, "fk_probe.cu")
    with open(src, "w") as f:
        f.write(PROBE)
    out = os.path.join(tmp, "libfk_probe.so")
    flags = [x for x in _build.NVCC_FLAGS if x not in ("-Xptxas", "-v")]
    proc = subprocess.run([_build.find_nvcc(), *flags, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(out)
    for name in ("probe_dot3_f32", "probe_dot3_f64"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                                ctypes.c_void_p]
    for name in ("probe_norm4_f32", "probe_norm4_f64"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                                                ctypes.c_void_p]
    return lib


def rotations(B, gen, dtype):
    quat = torch.randn((B, 4), generator=gen, device=DEVICE, dtype=torch.float64)
    return spatial.quat_to_rotmat(quat).to(dtype)


def same(a, b):
    """Share of entries of a equal to b's (as values; NaN never occurs)."""
    return float((a == b).double().mean())


def orders(lib, Bs):
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    rows = []
    for dtype in (torch.float32, torch.float64):
        sfx = "f32" if dtype == torch.float32 else "f64"
        for B in Bs:
            A1 = rotations(1, gen, dtype)[0]
            AB = rotations(B, gen, dtype)
            MB = rotations(B, gen, dtype)
            v = (2 * torch.rand((B, 3), generator=gen, device=DEVICE, dtype=torch.float64)
                 - 1).to(dtype)
            with full_f32_matmul():
                cases = {
                    "shared @ batch (3x3)": (A1 @ MB, A1.expand(B, 3, 3)[:, :, None, :],
                                             MB.mT[:, None, :, :]),
                    "shared @ batch (3x1)": ((A1 @ v[..., None])[..., 0], A1.expand(B, 3, 3),
                                             v[:, None, :]),
                    "batch @ batch (3x3)": (AB @ MB, AB[:, :, None, :], MB.mT[:, None, :, :]),
                    "batch @ batch (3x1)": ((AB @ v[..., None])[..., 0], AB, v[:, None, :]),
                }
            for name, (ref, X, Y) in cases.items():
                shape = ref.shape + (3,)
                X = X.expand(shape).contiguous()
                Y = Y.expand(shape).contiguous()
                n = ref.numel()
                shares = []
                for k in range(len(DOT_NAMES)):
                    out = torch.empty(n, dtype=dtype, device=DEVICE)
                    err = getattr(lib, f"probe_dot3_{sfx}")(X.data_ptr(), Y.data_ptr(),
                                                            out.data_ptr(), n, k, stream)
                    if err:
                        raise RuntimeError(f"probe launch failed: cuda error {err}")
                    shares.append(same(out, ref.reshape(-1)))
                rows.append(dict(op=name, dtype=sfx, B=B, matches={
                    DOT_NAMES[k]: s for k, s in enumerate(shares) if s > 0.5}))
            quat = torch.randn((B, 39), generator=gen, device=DEVICE, dtype=dtype)
            ref = torch.linalg.norm(quat[:, 3:7], dim=-1)
            X = quat[:, 3:7].contiguous()
            shares = []
            for k in range(len(NORM_NAMES)):
                out = torch.empty(B, dtype=dtype, device=DEVICE)
                err = getattr(lib, f"probe_norm4_{sfx}")(X.data_ptr(), out.data_ptr(), B, k,
                                                         stream)
                if err:
                    raise RuntimeError(f"probe launch failed: cuda error {err}")
                shares.append(same(out, ref))
            rows.append(dict(op="norm of a quaternion", dtype=sfx, B=B, matches={
                NORM_NAMES[k]: s for k, s in enumerate(shares) if s > 0.5}))
    torch.cuda.synchronize()
    return rows


def diff(a, b, scale):
    """(entries that differ, the largest |a - b| / scale)."""
    d = (a - b).abs() / scale
    return int((a != b).sum()), float(d.max()) if d.numel() else 0.0


def compare(tree, q, by_type=True):
    with full_f32_matmul():
        R, p = fk.fk_limi(tree, q)
        lR, lp = plain(tree, q)
    out = {}
    unit = 2.0 ** -22 if q.dtype == torch.float32 else 2.0 ** -51
    for j, t in enumerate(tree.jtypes):
        key = t if by_type else "all"
        r = diff(R[j], lR[j], unit)
        s = diff(p[j], lp[j], unit * lp[j].abs().clamp(min=1))
        cur = out.setdefault(key, [0, 0.0, 0, 0.0, 0])
        cur[0] += r[0]
        cur[1] = max(cur[1], r[1])
        cur[2] += s[0]
        cur[3] = max(cur[3], s[1])
        cur[4] += R[j].numel() + p[j].numel()
    return {str(k): dict(R_diffs=v[0], R_max_units=v[1], p_diffs=v[2], p_max_units=v[3],
                         entries=v[4]) for k, v in out.items()}


def bits(Bs):
    rows = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        for B in Bs:
            for seed in (0, 1):
                tree = zoo(seed, dtype, DEVICE)
                rows.append(dict(tree=tree.name, dtype=name, B=B,
                                 types=compare(tree, configurations(tree, B, 11))))
            chain = per_problem(lt.robots.panda_arm(name, device=DEVICE), B)
            rows.append(dict(tree="panda_arm batched geometry", dtype=name, B=B,
                             types=compare(chain, configurations(chain, B, 11))))
            for robot in ("panda_arm", "talos"):
                tree = lt.robots.get(robot, name, device=DEVICE)
                rows.append(dict(tree=robot, dtype=name, B=B,
                                 types=compare(tree, configurations(tree, B, 11), by_type=False)))
    return rows


def graphed(fn, reps=50):
    """Milliseconds a replay of ``fn`` captured as one CUDA graph (CUDA
    events over ``reps`` replays)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, name, reps=20):
    """(device ms a call of the kernels whose name holds ``name``, of every
    device operation, and the device operations a call), torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    mine = sum(e.self_device_time_total for e in ev if name in e.key)
    every = sum(e.self_device_time_total for e in ev)
    return mine / 1e3 / reps, every / 1e3 / reps, sum(e.count for e in ev) / reps


def times():
    rows = []
    for robot, B in (("panda_arm", 16384), ("talos", 4096)):
        tree = lt.robots.get(robot, "float32", device=DEVICE)
        q = configurations(tree, B, 3)
        with full_f32_matmul():
            k_ms, _, _ = device_ms(lambda: fk.fk_limi(tree, q), "fk_limi_kernel")
            k_graph = graphed(lambda: fk.fk_limi(tree, q))
            _, p_ms, p_ops = device_ms(lambda: plain(tree, q), "", reps=5)
            p_graph = graphed(lambda: plain(tree, q))
        size = q.element_size()
        nbytes = B * tree.nq * size + B * tree.njoints * 12 * size
        rows.append(dict(tree=robot, B=B, N=tree.njoints, nq=tree.nq, bytes=nbytes,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         kernel_device_ms=k_ms, kernel_graph_ms=k_graph,
                         plain_device_ms=p_ms, plain_ops=p_ops, plain_graph_ms=p_graph))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, nargs="+", default=[1, 333, 4096, 16384])
    ap.add_argument("--out", help="also write the whole result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fk_check: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    with tempfile.TemporaryDirectory() as tmp:
        result = dict(card=card.strip(), torch=torch.__version__, cuda=torch.version.cuda,
                      orders=orders(build_probe(tmp), args.B))
    result["bits"] = bits(args.B)
    result["times"] = times()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(result["card"], result["torch"], result["cuda"])
    for r in result["orders"]:
        print("order", r["dtype"], r["B"], r["op"], json.dumps(r["matches"]))
    for r in result["bits"]:
        worst = {k: (v["R_diffs"] + v["p_diffs"], round(max(v["R_max_units"], v["p_max_units"]), 3))
                 for k, v in r["types"].items() if v["R_diffs"] + v["p_diffs"]}
        print("bits", r["dtype"], r["B"], r["tree"], "differ (entries, units) by type:",
              json.dumps(worst))
    for r in result["times"]:
        print("time", json.dumps(r))


if __name__ == "__main__":
    main()
