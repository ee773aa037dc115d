"""Build and load the hand-written CUDA kernels (csrc/*.cu) for Hopper.

Each source is compiled at first use by `nvcc` into a shared library with a
plain C interface (loaded with ctypes), in `build/` beside this package,
named by a hash of the sources, headers and flags. `build()` starts one
`nvcc` per source, all at once. Flags: `-gencode arch=compute_90a,
code=sm_90a -std=c++17 -O3 -fmad=false`: no fast math, and no FMA
contraction, so the kernels round every operation as the plain versions'
separate PyTorch ops do.

Every entry point returns `cudaGetLastError()` after its launch; `check`
raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
# library name -> source; each exports `llr_<name>`, except bvh_aov.cu,
# which exports `llr_bvh_wide` and `llr_bvh_streamed`, and probes.cu, which
# exports one `llr_probe_<probe>` per capability probe (PROBE_ARGS).
SOURCES = {"raygen": "raygen.cu", "bounce": "bounce.cu", "bvh": "bvh.cu",
           "bounce_bvh": "bounce_bvh.cu", "bounce_bwd": "bounce_bwd.cu",
           "bvh_aov": "bvh_aov.cu", "probes": "probes.cu"}
HEADERS = ("common.cuh", "bounce_body.cuh", "bvh_walk.cuh", "bvh_warp_walk.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
# The sky arguments the forward bounce entry points end with: the equirect
# texture (null for a uniform or simple sky), its width and height and
# whether the sky is the simple one, then the stream.
_SKY = [_P, _I, _I, _I, _P]
# The bounce entry points start with the PathState in and out (12 pointers)
# and share this tail: spheres, the sampling and evaluation material tables,
# lights, total light area, lanes, bounce, the argument block on the card
# (seed, sky colours, longitude: cuda_bounce.kernel_args), flags, RR scale.
_SHADE = [_P, _I, _P, _P, _I, _P, _I, _F, _I, _I, _P, _I, _F]
ARGTYPES = {
    # ... the camera row, the launch's constants (raygen_consts), then the
    # mixer (1: threefry) and the stream.
    "llr_raygen": [_P, _P, _P, _P, _I, _U, _U, _I, _I, _I, _I, _I, _P, _P, _I, _P],
    # ... then the instance bits, threads per lane and the host copy of the
    # small scene's prim rows (csrc/bounce.cu), and the stream.
    "llr_bounce": [_P] * 12 + [_P, _I] + _SHADE + _SKY[:-1] + [_I, _I, _P, _P],
    # ... then nodes, leaves, ids, the leaves' valid counts and K.
    "llr_bounce_bvh": [_P] * 12 + [_P, _P, _P, _P, _I] + _SHADE + _SKY,
    # rays (4), nodes, leaves, ids, [counts,] K, lanes, outputs (4), stream.
    "llr_bvh": [_P] * 8 + [_I, _I] + [_P] * 4 + [_P],
    "llr_bvh_wide": [_P] * 7 + [_I, _I] + [_P] * 4 + [_P],
    "llr_bvh_streamed": [_P] * 7 + [_I, _I] + [_P] * 4 + [_P],
    # state in (5), cotangents in (4), out (5), triangles, then _SHADE, the
    # instance bits, the small scene's prim rows, the partial table and its
    # columns, the ticket and the stream.
    "llr_bounce_bwd": [_P] * 14 + [_P, _I] + _SHADE + [_I, _P, _P, _I, _P, _P],
    "llr_probe_smem_limit": [ctypes.POINTER(_I), _I],
}
# The signature of every capability probe's entry `llr_probe_<probe>` (two
# inputs, a scratch buffer, the output, one integer, the stream; null or 0
# where a probe has no use for them); each probe registers its entry in
# ARGTYPES (lumillyrender_tpu_torch/probes/kernel.py).
PROBE_ARGS = [_P, _P, _P, _P, _I, _P]

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, object] = {}  # entry name -> loaded C function
# nvcc's output of each source compiled by `build` in this process (with
# `verbose`, ptxas's registers, shared memory and spills per kernel).
LOGS: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((SRC_DIR / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(SOURCES), verbose: bool = False) -> dict:
    """Compile the named kernels that are not built yet, one nvcc process
    per source, all started together. Returns {name: seconds} for those
    compiled here; raises with nvcc's output if one fails. `verbose` prints
    nvcc's output with `-Xptxas -v` (registers, spills)."""
    todo = [nm for nm in names if not lib_path(nm).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.monotonic()
    for nm in todo:
        out = lib_path(nm)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        extra = ["-Xptxas", "-v"] if verbose else []
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(SRC_DIR / SOURCES[nm])]
        procs[nm] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True),
                     tmp, out)
    seconds = {}
    failed = []
    for nm, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        LOGS[nm] = log
        seconds[nm] = time.monotonic() - t0
        if verbose and log:
            print(f"[nvcc {SOURCES[nm]}]\n{log}")
        if p.returncode != 0:
            failed.append(f"{nm}: nvcc exited {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def fn(name: str, entry: str | None = None):
    """The C entry point `entry` (default `llr_<name>`) of the named
    library, built and loaded at first use, with the argument types
    ARGTYPES[entry]."""
    sym = entry or f"llr_{name}"
    if sym not in _fns:
        if name not in _libs:
            build((name,))
            _libs[name] = ctypes.CDLL(str(lib_path(name)))
        f = getattr(_libs[name], sym)
        f.argtypes = ARGTYPES[sym]
        f.restype = ctypes.c_int
        _fns[sym] = f
    return _fns[sym]


def check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()
