"""Counter-based per-lane RNG, bit for bit as the JAX package draws it.

Every lane derives an independent stream from (lane, ctr, seed) counters.
Counter-based bits are what make lane-by-lane parity with the JAX package
possible. Two mixers, chosen by `LLR_RNG` when this module is imported, as
the JAX package chooses (`_MIXER`; a test sets the attribute):

* "pcg4d" (the default): Jarzynski & Olano, "Hash Functions for GPU
  Rendering", JCGT 2020, listing pcg4d; one evaluation gives four words.
  The kernels (csrc/common.cuh, csrc/raygen.cu) draw it too.
* "threefry": Threefry-2x32 (20 rounds), the JAX package's reference mixer
  for A/B statistical checks; a block gives two words. Only the plain
  step and kernel 1's threefry instance draw it: on the card the bounce
  kernels draw pcg4d, so `cuda_bounce.step_mode` refuses them under it.

PyTorch has no uint32 add or right shift on every backend, so the mixers
run in int64 and mask to 32 bits after every wrapping step. Lane ids are
carried as the uint32 bit pattern in an int32 tensor. Constants stay
Python ints (fills on the device), so a CUDA graph can capture a draw.
"""

from __future__ import annotations

import os

import torch

_MIXER = os.environ.get("LLR_RNG", "pcg4d")

_M = 1664525
_INC = 1013904223
_SALT = 0xB5297A4D
_MASK = 0xFFFFFFFF
_U24 = 1.0 / (1 << 24)
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_KS_PARITY = 0x1BD11BDA
_KEY2 = 0x9E3779B9  # the second key word: seed ^ _KEY2
_BLOCK2 = 0x80000000  # uniform4's second block: counter ^ _BLOCK2


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


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1, rounds: int = 20):
    """Threefry-2x32 over int64 tensors holding uint32 values: key (k0, k1),
    counter (x0, x1) -> two words, the key injected every 4 rounds (the
    JAX package's `threefry2x32`)."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(rounds):
        x0 = (x0 + x1) & _MASK
        x1 = _rotl(x1, _ROT[i % 8]) ^ x0
        if i % 4 == 3:
            j = i // 4 + 1
            x0 = (x0 + ks[j % 3]) & _MASK
            x1 = (x1 + ks[(j + 1) % 3] + j) & _MASK
    return x0, x1


def _to_f32(x):
    # 24 high bits -> [0, 1) float32 (exact: the integer is below 2^24).
    return (x >> 8).to(torch.float32) * _U24


def _counters(seed, lane, ctr):
    """(seed, lane, ctr) as int64 tensors of uint32 values on lane's device."""
    lane = as_u32(lane)
    dev = lane.device
    return as_u32(seed, dev), lane, as_u32(ctr, dev)


def uniform4(seed, lane, ctr):
    """Four independent U[0,1) float32 per lane: one pcg4d evaluation, or
    two threefry blocks keyed (seed, seed ^ 0x9E3779B9) on (lane, ctr) and
    (lane, ctr ^ 0x80000000).

    seed: Python int or integer tensor; lane: int32 tensor of uint32 bit
    patterns (or int64 values); ctr: Python int or integer tensor."""
    s, lane, c = _counters(seed, lane, ctr)
    if _MIXER == "threefry":
        s2 = s ^ _KEY2
        x0, x1 = threefry2x32(s, s2, lane, c)
        x2, x3 = threefry2x32(s, s2, lane, c ^ _BLOCK2)
    else:
        x0, x1, x2, x3 = pcg4d(lane, c, s, as_u32(_SALT, lane.device))
    return _to_f32(x0), _to_f32(x1), _to_f32(x2), _to_f32(x3)


def uniform2(seed, lane, ctr):
    """Two independent U[0,1) float32 per lane: under threefry one block of
    its own (on (lane, ctr), so the same two words as uniform4's first
    block, without its second); under pcg4d uniform4's first two words."""
    if _MIXER == "threefry":
        s, lane, c = _counters(seed, lane, ctr)
        x0, x1 = threefry2x32(s, s ^ _KEY2, lane, c)
        return _to_f32(x0), _to_f32(x1)
    f0, f1, _, _ = uniform4(seed, lane, ctr)
    return f0, f1


def uniform(seed, lane, ctr):
    return uniform2(seed, lane, ctr)[0]
