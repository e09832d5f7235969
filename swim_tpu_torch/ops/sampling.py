"""Keyed Feistel permutation of [0, m) (port of `swim_tpu/ops/sampling.py`).

`feistel` works elementwise on int32 carriers (u32 bit patterns);
`py_feistel` and `_py_mix32` are the Python-int twins.  The rotor
engine evaluates its per-period probe offsets with the Python twins on
the host (models/ring.py `rotor_offsets`): the cycle-walk is a
data-dependent loop, which on the device would need a host sync.
"""
from __future__ import annotations

import torch

from swim_tpu_torch.ops import u32

ROUNDS = 4
_GOLD = 0x9E3779B9


def _half_bits(m: int) -> int:
    """b such that the 2b-bit Feistel domain covers [0, m)."""
    if m < 2:
        return 1
    return max(1, ((m - 1).bit_length() + 1) // 2)


# ------------------------------------------------------------- torch path

def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on u32 carriers."""
    x = x ^ u32.lsr(x, 16)
    x = u32.mul_const(x, 0x7FEB352D)
    x = x ^ u32.lsr(x, 15)
    x = u32.mul_const(x, 0x846CA68B)
    return x ^ u32.lsr(x, 16)


def _perm2b(x: torch.Tensor, b: int, ka: torch.Tensor,
            kb: torch.Tensor) -> torch.Tensor:
    mask = (1 << b) - 1
    left = u32.lsr(x, b)
    right = x & mask
    for r in range(ROUNDS):
        rk = _mix32(u32.add(ka, (r * _GOLD) & u32.MASK32)) ^ kb
        f = _mix32(u32.add(right, rk)) & mask
        left, right = right, left ^ f
    return (left << b) | right


def feistel(x: torch.Tensor, m: int, ka: torch.Tensor,
            kb: torch.Tensor) -> torch.Tensor:
    """Keyed permutation of [0, m) evaluated at x (elementwise, int32).

    Cycle-walks values that land outside [0, m).  The loop condition is
    read on the host, so on a CUDA tensor each extra walk costs a sync;
    the engine's hot path uses `py_feistel` instead."""
    b = _half_bits(m)
    y = _perm2b(x, b, ka, kb)
    while bool(u32.uge(y, u32.carrier(m)).any()):
        y = torch.where(u32.uge(y, u32.carrier(m)), _perm2b(y, b, ka, kb), y)
    return y


# ------------------------------------------------------------ python twin

def _py_mix32(x: int) -> int:
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


def _py_perm2b(x: int, b: int, ka: int, kb: int) -> int:
    mask = (1 << b) - 1
    left, right = x >> b, x & mask
    for r in range(ROUNDS):
        rk = _py_mix32((ka + r * _GOLD) & 0xFFFFFFFF) ^ kb
        f = _py_mix32((right + rk) & 0xFFFFFFFF) & mask
        left, right = right, left ^ f
    return (left << b) | right


def py_feistel(x: int, m: int, ka: int, kb: int) -> int:
    b = _half_bits(m)
    y = _py_perm2b(x, b, ka, kb)
    while y >= m:
        y = _py_perm2b(y, b, ka, kb)
    return y
