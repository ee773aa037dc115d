"""The native SAH treelet builder (`csrc/bvh_builder.cpp`), loaded by ctypes.

`build_ranges` gives the same `RangeBvh` as `accel/sah.py::build_ranges`,
its plain version, node for node (tests/test_torch_bigmesh.py); it takes
~3 s where the numpy builder takes ~13 s on a 1M-triangle mesh.

The library is compiled at first use by the host C++ compiler (`$CXX`, else
`c++`) into `build/` beside this package, named by a hash of the source and
flags. The compiler writes a temporary file that is moved into place, so
processes that build at once do not see each other's half-written library.
A failed build raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .sah import RangeBvh, build_ranges as plain_build_ranges

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "bvh_builder.cpp"
BUILD_DIR = _PKG / "build"
# No contraction: the SAH costs round as the numpy builder's do, so both
# pick the same splits.
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-fPIC", "-std=c++17", "-shared")

_lib = None


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbvh_builder-{h.hexdigest()[:16]}.so"


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler found ($CXX, c++, g++): the native "
                       "BVH builder cannot be built")


def build() -> Path:
    """Compile the library unless it is built; returns its path."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"native BVH builder failed to build "
                           f"({' '.join(cmd)}):\n{p.stdout}{p.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.lumilly_bvh_build_ranges.restype = ctypes.c_int32
        lib.lumilly_bvh_build_ranges.argtypes = [
            ctypes.c_int32, ctypes.c_int32, f64, f64, f64, f32, f32, i32,
            i32, i32, i32,
        ]
        _lib = lib
    return _lib


def build_ranges(mins, maxs, centers, max_leaf: int) -> RangeBvh:
    """SAH build that stops splitting at `max_leaf` prims per leaf; see
    `sah.build_ranges`."""
    p = int(mins.shape[0])
    if p == 0:
        return plain_build_ranges(mins, maxs, centers, max_leaf)
    lib = _load()
    mins = np.ascontiguousarray(mins, np.float64)
    maxs = np.ascontiguousarray(maxs, np.float64)
    centers = np.ascontiguousarray(centers, np.float64)
    cap = 2 * p - 1
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_miss = np.empty((cap,), np.int32)
    leaf_start = np.empty((cap,), np.int32)
    leaf_count = np.empty((cap,), np.int32)
    perm = np.empty((p,), np.int32)
    count = lib.lumilly_bvh_build_ranges(
        p, max_leaf, mins, maxs, centers, node_min, node_max, node_miss,
        leaf_start, leaf_count, perm,
    )
    if count <= 0:
        raise RuntimeError(f"native BVH range build failed: {count}")
    return RangeBvh(
        node_min=node_min[:count].copy(),
        node_max=node_max[:count].copy(),
        node_miss=node_miss[:count].copy(),
        leaf_start=leaf_start[:count].copy(),
        leaf_count=leaf_count[:count].copy(),
        perm=perm,
    )
