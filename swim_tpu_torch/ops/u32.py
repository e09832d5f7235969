"""u32 arithmetic on torch.int32 carriers.

The reference keeps its heard-bit words and lattice keys in uint32
arrays.  PyTorch's CPU build lacks `<<`, `>>`, `+`, `<`, `maximum` and
`scatter_reduce("amax")` for torch.uint32, so the port stores every u32
array as a torch.int32 tensor holding the same 32 bits (the same bytes,
which lets a CUDA kernel read it as `uint32_t*` with no copy).  Bitwise
and, or, xor, not and equality need nothing; everything else that
depends on the sign bit goes through these helpers:

  * order: flipping bit 31 maps unsigned order onto signed order, so
    `a <u b` is `(a ^ SIGN) < (b ^ SIGN)` (lattice keys keep DEAD in
    bit 31, so a signed max would rank DEAD below ALIVE);
  * logical right shift: the arithmetic shift, then mask off the copies
    of the sign bit;
  * popcount, add and multiply: in int64, where the u32 value is exact,
    then back to the carrier modulo 2**32.
"""
from __future__ import annotations

import torch

SIGN = -(1 << 31)           # bit 31 in the int32 carrier
MASK32 = 0xFFFFFFFF


def carrier(v: int) -> int:
    """A Python u32 value as the int32 that carries its bits."""
    v &= MASK32
    return v - (1 << 32) if v >> 31 else v


def to_u64(x: torch.Tensor) -> torch.Tensor:
    """The u32 value of each carrier element, as int64 in [0, 2**32)."""
    return x.to(torch.int64) & MASK32


def from_u64(x: torch.Tensor) -> torch.Tensor:
    """int64 values back to int32 carriers, modulo 2**32."""
    return (x & MASK32).to(torch.int32)


def flip(x):
    """Map unsigned order onto signed order (an involution)."""
    return x ^ SIGN


def ult(a, b):
    return flip(a) < flip(b)


def ugt(a, b):
    return flip(a) > flip(b)


def uge(a, b):
    return flip(a) >= flip(b)


def umax(a: torch.Tensor, b) -> torch.Tensor:
    return torch.where(ult(a, b), b, a)


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift by a constant 0 <= s < 32."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def bit_of(x: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """bool: bit `bit` (0..31, elementwise) of x.  The arithmetic shift
    keeps bit `bit` in place, so no mask beyond the low bit is needed."""
    return ((x >> bit) & 1) > 0


def popcount(x: torch.Tensor) -> torch.Tensor:
    """int32: number of set bits of each u32 (SWAR, in int64)."""
    v = to_u64(x)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def add(a: torch.Tensor, b) -> torch.Tensor:
    """Wrapping u32 add; `b` a carrier tensor or a Python u32 value."""
    bb = to_u64(b) if isinstance(b, torch.Tensor) else (b & MASK32)
    return from_u64(to_u64(a) + bb)


def mul_const(a: torch.Tensor, c: int) -> torch.Tensor:
    """Wrapping u32 multiply by a Python constant.  The product is split
    into 16-bit halves of `c` so that no int64 intermediate overflows."""
    a64 = to_u64(a)
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return from_u64(a64 * lo + (((a64 * hi) & 0xFFFF) << 16))


def pack_bits(flags: torch.Tensor) -> torch.Tensor:
    """bool[..., 32] -> u32 carrier [...]: flag b becomes bit b.  The
    weights 1 << b are disjoint, so their sum is their OR."""
    sh = torch.arange(32, dtype=torch.int64, device=flags.device)
    return from_u64((flags.to(torch.int64) << sh).sum(-1))
