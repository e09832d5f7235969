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

On top of `bits`, jax/_src/random.py's `_uniform` (f32 in [0, 1): the
mantissa bits under exponent 0) and `_randint` (two split keys, u32
remainders with a 2**16 mod span multiplier) as `uniform` and
`randint`.

Every function also takes a list of P keys, one per lane of a batched
study: `fold_in` and `split` work lane by lane on the host, and `bits`,
`uniform` and `randint` send the keys to the device as [P, 1] tensors
and hash the [P, size] counters in one pass, lane p bitwise the draw of
key p (what the reference's vmapped `jax.random` calls give).
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
    """threefry2x32 (20 rounds) of Python ints holding u32 values: the
    host's key arithmetic (`_hash_` is the tensor form)."""
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


def _hash_(k1, k2, x0: torch.Tensor, x1: torch.Tensor):
    """`_hash` of int64 tensors x0, x1 already of the output's shape,
    in place: the two counters and one scratch tensor are all it
    holds, where the expression form allocates a tensor for each of
    its 170 steps."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0.add_(ks[0]).bitwise_and_(_M)
    x1.add_(ks[1]).bitwise_and_(_M)
    hi = torch.empty_like(x1)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1).bitwise_and_(_M)
            torch.bitwise_right_shift(x1, 32 - r, out=hi)
            x1.bitwise_left_shift_(r).bitwise_and_(_M).bitwise_or_(hi)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M)
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """The key of `jax.random.key(seed)` for a 32-bit integer seed."""
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return (0, seed & _M)


def fold_in(k, data: int):
    """The key folded with `data`; for a list of keys, the list of the
    lanes' folded keys."""
    if not isinstance(k, tuple):
        return [fold_in(kp, data) for kp in k]
    return _hash(k[0], k[1], 0, data & _M)


def split(k, num: int) -> list:
    """`num` keys; for a list of P keys, `num` lists of P keys (entry i
    holds every lane's key i)."""
    if not isinstance(k, tuple):
        return [list(col) for col in zip(*(split(kp, num) for kp in k))]
    return [_hash(k[0], k[1], 0, i) for i in range(num)]


def _lanes(k, device):
    """(k1, k2, lane shape) of one key (ints, no lane axis) or of a list
    of keys (int64 [P, 1] tensors on `device`, lane shape (P,)).  A card
    gets the keys from pinned memory without blocking: a copy from
    pageable memory would wait for the card."""
    if isinstance(k, tuple):
        return k[0], k[1], ()
    kt = torch.tensor(k, dtype=torch.int64).reshape(-1, 2)
    if torch.device(device).type == "cuda":
        kt = kt.pin_memory()
    kt = kt.to(device, non_blocking=True)
    return kt[:, :1], kt[:, 1:], (kt.shape[0],)


def bits(k, shape, device, at: torch.Tensor | None = None
         ) -> torch.Tensor:
    """int32 carrier of `jax.random.bits(key, shape, jnp.uint32)`; for a
    list of P keys, [P, *shape] with lane p the draw of key p.  `at`
    (one key only) names flat indices of `shape`: the draw's elements
    there, in `at`'s shape (each element hashes its own counter)."""
    shape = tuple(shape)
    size = math.prod(shape)
    if size >= (1 << 32):
        raise ValueError("bits: more than 2**32 counters")
    k1, k2, lanes = _lanes(k, device)
    if at is not None:
        if lanes:
            raise ValueError("bits: `at` takes one key")
        lo = at.to(torch.int64, copy=True)
        o0, o1 = _hash_(k1, k2, torch.zeros_like(lo), lo)
        return u32.from_u64(o0.bitwise_xor_(o1))
    lo = torch.arange(size, dtype=torch.int64, device=device)
    if lanes:
        lo = lo.expand(*lanes, size).clone()
    o0, o1 = _hash_(k1, k2, torch.zeros_like(lo), lo)
    return u32.from_u64(o0.bitwise_xor_(o1)).reshape(lanes + shape)


def uniform(k, shape, device) -> torch.Tensor:
    """float32 `jax.random.uniform(key, shape)` in [0, 1): the top 23
    bits as the mantissa of a float in [1, 2), minus 1 (exact)."""
    b = bits(k, shape, device)
    return (u32.lsr(b, 9) | 0x3F800000).view(torch.float32) - 1.0


def randint(k, shape, lo: int, hi: int, device,
            at: torch.Tensor | None = None) -> torch.Tensor:
    """int32 `jax.random.randint(key, shape, lo, hi)`: u32 arithmetic,
    done in int64 and cut to 32 bits after every step.  `at` as in
    `bits`."""
    k1, k2 = split(k, 2)
    higher = u32.to_u64(bits(k1, shape, device, at))
    lower = u32.to_u64(bits(k2, shape, device, at))
    span = (hi - lo) & _M if hi > lo else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M) % span
    off = ((higher % span) * mult) & _M
    off = ((off + lower % span) & _M) % span
    return u32.from_u64(off + lo)
