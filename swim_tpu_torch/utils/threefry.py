"""JAX's threefry2x32 PRNG, bit for bit, in its partitionable layout.

The reference draws each period's randomness as

    kk = jax.random.fold_in(root_key, step)
    ks = jax.random.split(kk, 4)
    bits = jax.random.bits(ks[i], shape, jnp.uint32)

with `jax_threefry_partitionable=True` (JAX's default).  A key is a pair
of u32.  The key arithmetic (`key`, `fold_in`, `split`) is a handful of
hashes, done here on the host in Python ints; only `bits`, the [N] and
[N, k] arrays, runs on the device.  Sources mirrored (jax/_src/prng.py):

  * key(seed):        threefry_seed — (seed >> 32, seed & 0xFFFFFFFF)
                      for a 32-bit seed, i.e. (0, seed mod 2**32);
  * fold_in(key, d):  threefry_2x32(key, threefry_seed(d)) — one hash of
                      the counter pair (0, d);
  * split(key, num):  _threefry_split_foldlike — hash of the counters
                      (0, i), i < num; key i is (out0[i], out1[i]);
  * bits(key, shape): _threefry_random_bits_partitionable — hash of the
                      counters (hi, lo) of the flat index, out0 ^ out1.
"""
from __future__ import annotations

import math

import torch

from swim_tpu_torch.ops import u32

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M


def _hash(k1: int, k2: int, x0, x1):
    """threefry2x32 (20 rounds).  x0/x1 are Python ints or int64
    tensors holding u32 values; the keys are Python ints."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """The key of `jax.random.key(seed)` for a 32-bit integer seed."""
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return (0, seed & _M)


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    return _hash(k[0], k[1], 0, data & _M)


def split(k: tuple[int, int], num: int) -> list[tuple[int, int]]:
    return [_hash(k[0], k[1], 0, i) for i in range(num)]


def bits(k: tuple[int, int], shape, device) -> torch.Tensor:
    """int32 carrier of `jax.random.bits(key, shape, jnp.uint32)`."""
    shape = tuple(shape)
    size = math.prod(shape)
    if size >= (1 << 32):
        raise ValueError("bits: more than 2**32 counters")
    lo = torch.arange(size, dtype=torch.int64, device=device)
    o0, o1 = _hash(k[0], k[1], torch.zeros_like(lo), lo)
    return u32.from_u64(o0 ^ o1).reshape(shape)
