"""ctypes binding of the native C++ URDF parser (cpp/urdf_parser.cpp).

Port of `loik_tpu.model.native`.  The shared library is built with g++ on
first use into the port's own build directory, `kernels/_build/` (named by
the SHA-256 of the source and flags, like the CUDA kernels), never next to
the source, where loik_tpu keeps its own build.  There is no fallback: a
missing g++ or a failed build raises with the compiler's output.
`load_urdf_native` has `load_urdf`'s surface (the same joint types, the
helical / spherical_zyx extensions, the same mimic policy), held against it
and against loik_tpu's loader in tests/test_torch_native.py.

Not exported from `loik_tpu_torch.model`, so importing the model builds
nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np
import torch

from ..kernels._build import BUILD_DIR
from .tree import (FREE_FLYER, HELICAL, JOINT_NQ, JOINT_NV, MIMIC_PAIR, PLANAR,
                   PRISMATIC, REVOLUTE, REVOLUTE_UNBOUNDED, SPHERICAL, SPHERICAL_ZYX,
                   TRANSLATION, UNIVERSAL, KinematicTree, resolve_device)

SRC_PATH = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..", "cpp",
                                         "urdf_parser.cpp"))
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
# the parser keeps its last result in globals: one parse and read at a time
_lock = threading.Lock()
_lib = None

# the C side's joint codes
_TYPES = {0: REVOLUTE, 1: PRISMATIC, 2: FREE_FLYER, 3: SPHERICAL,
          4: REVOLUTE_UNBOUNDED, 5: TRANSLATION, 6: PLANAR,
          7: UNIVERSAL, 8: HELICAL, 9: SPHERICAL_ZYX, 10: MIMIC_PAIR}


def library_path() -> str:
    """Where the parser's library for the current source and flags lives."""
    h = hashlib.sha256()
    with open(SRC_PATH, "rb") as f:
        h.update(f.read())
    h.update("\0".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"liburdf_loik_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the parser if its library does not exist yet; returns the
    path.  Raises RuntimeError with g++'s output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a temporary name, then a rename: no half-written library under `out`
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, SRC_PATH, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError("g++ not found: the native URDF parser is built on first use") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"g++ failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """Build if needed and load the parser (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            dp = ctypes.POINTER(ctypes.c_double)
            ip = ctypes.POINTER(ctypes.c_int)
            lib.loik_urdf_parse.restype = ctypes.c_int
            lib.loik_urdf_parse.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
            lib.loik_urdf_error.restype = ctypes.c_char_p
            lib.loik_urdf_error.argtypes = []
            lib.loik_urdf_names.restype = ctypes.c_char_p
            lib.loik_urdf_names.argtypes = []
            lib.loik_urdf_get.restype = ctypes.c_int
            lib.loik_urdf_get.argtypes = [ip, ip, dp, dp, dp, dp]
            lib.loik_urdf_get_axis2.restype = ctypes.c_int
            lib.loik_urdf_get_axis2.argtypes = [dp]
            lib.loik_urdf_get_extras.restype = ctypes.c_int
            lib.loik_urdf_get_extras.argtypes = [dp, dp, dp, dp]
            _lib = lib
    return _lib


def native_available() -> bool:
    """True when the parser builds and loads here."""
    try:
        get_lib()
        return True
    except (RuntimeError, OSError):
        return False


def _d(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def load_urdf_native(source: str, name: str | None = None,
                     dtype: torch.dtype = torch.float64, floating_base: bool = False,
                     mimic: str = "raise", device=None) -> KinematicTree:
    """Parse a URDF string or file path with the native parser into a tree
    on ``device`` (None: the CUDA device).

    Same surface as `load_urdf`: mimic="raise" (default) rejects <mimic>
    couplings; mimic="reduce" folds serial-adjacent pairs into MIMIC_PAIR
    joints (the folding runs natively).  A parse error raises ValueError
    with the parser's message."""
    if mimic not in ("raise", "reduce"):
        raise ValueError(f"mimic must be 'raise' or 'reduce'; got {mimic!r}")
    if "<robot" not in source:
        with open(source) as f:
            source = f.read()
    lib = get_lib()
    with _lock:
        n = lib.loik_urdf_parse(source.encode(), int(floating_base), int(mimic == "reduce"))
        if n == 0:
            raise ValueError("native URDF parse failed: " + lib.loik_urdf_error().decode())
        parents = np.zeros(n, np.int32)
        jtypes = np.zeros(n, np.int32)
        pR = np.zeros((n, 3, 3))
        pp = np.zeros((n, 3))
        axis = np.zeros((n, 3))
        vel = np.zeros(n)
        lib.loik_urdf_get(parents.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                          jtypes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                          _d(pR), _d(pp), _d(axis), _d(vel))
        names = tuple(lib.loik_urdf_names().decode().split("\n")[:n])
        axis2 = np.zeros((n, 3))
        lib.loik_urdf_get_axis2(_d(axis2))
        pitch = np.zeros(n)
        mimic_meta = np.zeros((n, 4))
        p2R = np.zeros((n, 3, 3))
        p2p = np.zeros((n, 3))
        lib.loik_urdf_get_extras(_d(pitch), _d(mimic_meta), _d(p2R), _d(p2p))

    jt = tuple(_TYPES[int(t)] for t in jtypes)
    idx_v, idx_q = [], []
    nv = nq = 0
    for t in jt:
        idx_v.append(nv)
        idx_q.append(nq)
        nv += JOINT_NV[t]
        nq += JOINT_NQ[t]
    vel_full = np.full(nv, np.inf)
    for i, t in enumerate(jt):
        vel_full[idx_v[i]: idx_v[i] + JOINT_NV[t]] = vel[i] if vel[i] < 1e29 else np.inf
    has_mimic = MIMIC_PAIR in jt
    dev = resolve_device(device)

    def tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    return KinematicTree(
        placement_R=tensor(pR),
        placement_p=tensor(pp),
        axis=tensor(axis),
        velocity_limit=tensor(vel_full),
        parents=tuple(int(p) for p in parents),
        jtypes=jt,
        idx_v=tuple(idx_v),
        idx_q=tuple(idx_q),
        joint_names=names,
        name=name or "robot",
        axis2=tensor(axis2) if any(t in (UNIVERSAL, MIMIC_PAIR) for t in jt) else None,
        pitches=tuple(float(h) for h in pitch) if HELICAL in jt else None,
        mimic=(tuple((int(m[0]), int(m[1]), float(m[2]), float(m[3]))
                     if t == MIMIC_PAIR else None for t, m in zip(jt, mimic_meta))
               if has_mimic else None),
        placement2_R=tensor(p2R) if has_mimic else None,
        placement2_p=tensor(p2p) if has_mimic else None,
    )
