"""Counter-based per-lane RNG: pcg4d, bit for bit as the JAX package draws it.

Every lane derives an independent stream from (lane, ctr, seed, salt)
counters (Jarzynski & Olano, "Hash Functions for GPU Rendering", JCGT 2020,
listing pcg4d). Counter-based bits are what make lane-by-lane parity with
the JAX package possible, so this is the renderer's only randomness.

PyTorch has no uint32 add or right shift on every backend, so the mixer
runs in int64 and masks to 32 bits after every wrapping step. Lane ids are
carried as the uint32 bit pattern in an int32 tensor.
"""

from __future__ import annotations

import torch

_M = 1664525
_INC = 1013904223
_SALT = 0xB5297A4D
_MASK = 0xFFFFFFFF
_U24 = 1.0 / (1 << 24)


def as_u32(x, device=None) -> torch.Tensor:
    """Python int / int tensor (uint32 bit pattern) -> int64 in [0, 2^32).
    A Python int becomes a fill on the device, not a copy from the host, so
    a CUDA graph can capture it."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return torch.full((), int(x) & _MASK, dtype=torch.int64, device=device)


def pcg4d(a, b, c, d):
    """pcg4d mixer over int64 tensors holding uint32 values: 4 in, 4 out."""
    v = [(x * _M + _INC) & _MASK for x in (a, b, c, d)]
    for it in range(2):
        v[0] = (v[0] + v[1] * v[3]) & _MASK
        v[1] = (v[1] + v[2] * v[0]) & _MASK
        v[2] = (v[2] + v[0] * v[1]) & _MASK
        v[3] = (v[3] + v[1] * v[2]) & _MASK
        if it == 0:
            v = [x ^ (x >> 16) for x in v]
    return v[0], v[1], v[2], v[3]


def _to_f32(x):
    # 24 high bits -> [0, 1) float32 (exact: the integer is below 2^24).
    return (x >> 8).to(torch.float32) * _U24


def uniform4(seed, lane, ctr):
    """Four independent U[0,1) float32 per lane from one mixer evaluation.

    seed: Python int or integer tensor; lane: int32 tensor of uint32 bit
    patterns (or int64 values); ctr: Python int or integer tensor."""
    lane = as_u32(lane)
    dev = lane.device
    s = as_u32(seed, dev)
    c = as_u32(ctr, dev)
    salt = as_u32(_SALT, dev)
    x0, x1, x2, x3 = pcg4d(lane, c, s, salt)
    return _to_f32(x0), _to_f32(x1), _to_f32(x2), _to_f32(x3)


def uniform2(seed, lane, ctr):
    """Two independent U[0,1) float32 per lane."""
    f0, f1, _, _ = uniform4(seed, lane, ctr)
    return f0, f1


def uniform(seed, lane, ctr):
    return uniform2(seed, lane, ctr)[0]
