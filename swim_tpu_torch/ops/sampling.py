"""Keyed Feistel permutation of [0, m) (port of `swim_tpu/ops/sampling.py`).

`feistel` works elementwise on int32 carriers (u32 bit patterns);
`py_feistel` and `_py_mix32` are the Python-int twins.  The rotor
engine evaluates its per-period probe offsets with the Python twins on
the host (models/ring.py `rotor_offsets`): the cycle-walk is a
data-dependent loop, which on the device would need a host sync.

`round_robin_target` is SWIM's randomized round-robin probe target
(paper section 4.3) of the dense and rumor engines: node i walks its
own per-epoch shuffle of the other n - 1 ids.  It runs on the device
and reads the cycle-walk's loop condition on the host, once and then
once every WALK_BATCH walks: one sync a period when no value needs
more than WALK_BATCH walks.
"""
from __future__ import annotations

import torch

from swim_tpu_torch.ops import u32

ROUNDS = 4
_GOLD = 0x9E3779B9
# masked cycle-walks between two host reads of the walk's loop condition
WALK_BATCH = 8


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


def _round_keys(ka: torch.Tensor, kb: torch.Tensor) -> list:
    """The ROUNDS round keys of (ka, kb); the same for every walk."""
    return [_mix32(u32.add(ka, (r * _GOLD) & u32.MASK32)) ^ kb
            for r in range(ROUNDS)]


def _perm2b(x: torch.Tensor, b: int, rks: list) -> torch.Tensor:
    mask = (1 << b) - 1
    left = u32.lsr(x, b)
    right = x & mask
    for rk in rks:
        f = _mix32(u32.add(right, rk)) & mask
        left, right = right, left ^ f
    return (left << b) | right


def feistel(x: torch.Tensor, m: int, ka: torch.Tensor,
            kb: torch.Tensor) -> torch.Tensor:
    """Keyed permutation of [0, m) evaluated at x (elementwise, int32).

    Cycle-walks values that land outside [0, m), WALK_BATCH masked walks
    between two reads of the loop condition on the host (a walk leaves
    a value in [0, m) as it is, so the result is the reference's).  On
    a CUDA tensor each read is a sync; the rotor engine's hot path uses
    `py_feistel` instead.  Under `torch.func.vmap` the walk runs once
    over every lane's values (`_walk`'s vmap rule): a host read of a
    batched condition cannot run inside the vmap."""
    return _walk(x, ka, kb, m)


@torch.library.custom_op("swim_tpu_torch::feistel_walk", mutates_args=())
def _walk(x: torch.Tensor, ka: torch.Tensor, kb: torch.Tensor,
          m: int) -> torch.Tensor:
    """`feistel` on tensors of one broadcast shape."""
    b = _half_bits(m)
    rks = _round_keys(ka, kb)
    mm = u32.carrier(m)
    y = _perm2b(x, b, rks)
    while bool(u32.uge(y, mm).any()):
        for _ in range(WALK_BATCH):
            y = torch.where(u32.uge(y, mm), _perm2b(y, b, rks), y)
    return y


def _walk_vmap(info, in_dims, x, ka, kb, m):
    """The walk over all lanes at once: each operand broadcast to
    [P, *shape] (elementwise, so each lane gets its own bits)."""
    ts = (x, ka, kb)
    logical = [tuple(t.shape) if d is None
               else tuple(t.shape[:d] + t.shape[d + 1:])
               for t, d in zip(ts, in_dims[:3])]
    shape = torch.broadcast_shapes(*logical)
    lanes = []
    for t, d, ls in zip(ts, in_dims[:3], logical):
        if d is not None:
            t = t.movedim(d, 0).reshape(
                (info.batch_size,) + (1,) * (len(shape) - len(ls)) + ls)
        lanes.append(t.expand((info.batch_size,) + shape))
    return _walk(*lanes, m), 0


_walk.register_vmap(_walk_vmap)


def round_robin_target(node: torch.Tensor, epoch: torch.Tensor,
                       pos: torch.Tensor, n: int) -> torch.Tensor:
    """int32 probe target of `node` at position `pos` of `epoch` (int32
    tensors of one shape): a (node, epoch)-keyed permutation of
    [0, n - 1), then skip-self, so each epoch visits the other n - 1
    members once."""
    ka = _mix32(u32.add(u32.mul_const(node, _GOLD),
                        u32.mul_const(epoch, 0x85EBCA6B)))
    kb = _mix32(node ^ u32.add(epoch, 1))
    p = feistel(pos, n - 1, ka, kb)
    return p + (p >= node).to(torch.int32)


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


def py_round_robin_target(node: int, epoch: int, pos: int, n: int) -> int:
    ka = _py_mix32((node * _GOLD + epoch * 0x85EBCA6B) & 0xFFFFFFFF)
    kb = _py_mix32((node ^ ((epoch + 1) & 0xFFFFFFFF)) & 0xFFFFFFFF)
    p = py_feistel(pos, n - 1, ka, kb)
    return p + (1 if p >= node else 0)
