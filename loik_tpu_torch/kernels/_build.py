"""Build the CUDA kernels of `csrc/` on first use and load them with ctypes.

`nvcc` compiles every `csrc/*.cu` into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  The library is
written under `kernels/_build/`, named by the SHA-256 of the sources and
flags, so a changed source is rebuilt and an unchanged one is reused.  The
`ptxas -v` report (registers, stack, spills) is kept beside it as a `.log`.

This is not a fallback: a missing `nvcc` or a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
# the CUDA toolkit's default install prefix, the last place searched
_DEFAULT_CUDA_HOME = "/usr/local/cuda"
# nvcc runs in this process (`utils.no_recompile_guard` counts them)
BUILDS = 0

# -fmad=false: no multiply-add is contracted into an FMA, so the kernels
# round operation for operation like their eager PyTorch versions (see the
# note at the top of csrc/fused_admm.cu)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """`$CUDA_HOME/bin/nvcc`, else `nvcc` on PATH, else the toolkit's
    default prefix; raises RuntimeError when none exists."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(_DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        f"{_DEFAULT_CUDA_HOME}/bin): the CUDA kernels of loik_tpu_torch are "
        "compiled on first use and need the CUDA toolkit"
    )


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _key() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    return os.path.join(BUILD_DIR, f"libloik_kernels_{_key()}.so")


def build_log() -> str:
    """The compiler's report of the current library's build ('' if none)."""
    path = library_path()[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def build() -> str:
    """Compile the sources if the library for them does not exist yet;
    returns its path.  Raises RuntimeError with nvcc's output on failure."""
    global BUILDS
    out = library_path()
    if os.path.exists(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a temporary name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *_sources()]
    BUILDS += 1
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
    with open(out[:-3] + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    return ctypes.CDLL(build())
