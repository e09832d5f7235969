"""Wire widths and payloads of the packed waves (port of
`swim_tpu/ops/wavepack.py`).

The reference narrows what its sharded wave exchange ships: the first-B
piggyback as slot indices (`slot_dtype`, the compact ICI wire) and the
per-wave scalars of the packed scalar wire (`code_dtype`: slot + 1 codes,
buddy window columns and bit codes; bool vectors at 1 bit per node,
`packed_words`).  On one device the packed wire does the same rolls on
the narrowed values, so its state equals the wide wire's bit for bit;
what the widths still decide is the byte tally of `obs/ici.py`.

PyTorch's uint16 is only partly supported, so a width is a `WireDtype`:
the torch dtype that carries the values in this port (uint8 for u8,
int32 for u16 and for u32, as every u32 array of the port) and the
bytes per value the reference's dtype puts on the wire (1, 2 or 4).
The tally counts the wire bytes, never the carrier's.

The payloads the sharded engine (parallel/ring_shard.py) exchanges are
built here, byte for byte the reference's:

  * `pack_bits` / `unpack_bits`: bool[s] <-> u32[ceil(s/32)], bit i of
    word w is flag 32*w + i;
  * `pack_bundle` / `unpack_bundle`: same-length node vectors fused into
    one u8 payload, bools bit-packed, every other part as the
    little-endian bytes of its wire width (`itemsizes`: the reference's
    bytes per value where the carrier is wider, e.g. 2 for a u16 lane
    in int32); `bundle_nbytes` is one part's share;
  * `pack_slots` / `unpack_slots`: a first-B-selected u32[S, WW] block
    <-> its slot indices [S, b] (slot = column * 32 + bit, ascending,
    empty entries the wire dtype's max), in `slot_dtype(ww)`'s carrier.

Every round trip is exact; `unpack_slots(pack_slots(sel, b), ww) == sel`
whenever no row of `sel` has more than b set bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from swim_tpu_torch.ops import u32

WORD = 32


class WireDtype(NamedTuple):
    """A narrow unsigned wire dtype of the reference, as this port
    carries it."""

    carrier: torch.dtype   # torch dtype holding the values losslessly
    itemsize: int          # bytes per value on the reference's wire


U8 = WireDtype(torch.uint8, 1)
U16 = WireDtype(torch.int32, 2)
U32 = WireDtype(torch.int32, 4)


def slot_dtype(ww: int) -> WireDtype:
    """Narrowest unsigned dtype that can index ww*32 slots and spare its
    max value as the empty sentinel (hence <=, not <)."""
    nbits = ww * WORD
    if nbits < 255:
        return U8
    if nbits < 65535:
        return U16
    return U32


def packed_itemsize(ww: int) -> int:
    """Bytes per packed slot entry: the compact wire's tally unit."""
    return slot_dtype(ww).itemsize


def code_dtype(max_code: int) -> WireDtype:
    """Narrowest unsigned dtype that can hold values in [0, max_code]."""
    if max_code <= 255:
        return U8
    if max_code <= 65535:
        return U16
    return U32


def packed_words(s: int) -> int:
    """u32 words a bit-packed bool[s] occupies."""
    return -(-s // WORD)


def pack_bits(flags: torch.Tensor) -> torch.Tensor:
    """bool[s] -> u32 carrier [ceil(s/32)], bit i of word w = flags[32*w
    + i] (the pad bits are 0)."""
    s = flags.shape[0]
    w = packed_words(s)
    padded = torch.zeros((w * WORD,), dtype=torch.bool, device=flags.device)
    padded[:s] = flags
    return u32.pack_bits(padded.reshape(w, WORD))


def unpack_bits(words: torch.Tensor, s: int) -> torch.Tensor:
    """Inverse of pack_bits: u32 carrier [ceil(s/32)] -> bool[s]."""
    bit = torch.arange(WORD, dtype=torch.int32, device=words.device)
    return (((words[:, None] >> bit[None, :]) & 1) > 0).reshape(-1)[:s]


def _width(x: torch.Tensor, itemsize) -> int:
    return itemsize or x.element_size()


def narrow_bytes(x: torch.Tensor, itemsize=None) -> torch.Tensor:
    """uint8[*x.shape, itemsize]: the little-endian low `itemsize` bytes
    of each value of an integer carrier (its own bytes by default)."""
    if x.dtype == torch.uint8:
        return x.reshape(*x.shape, 1)
    w = _width(x, itemsize)
    b = x.contiguous().view(torch.uint8).reshape(*x.shape,
                                                  x.element_size())
    return b[..., :w]


def widen_bytes(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of narrow_bytes: uint8[..., w] -> `dtype` [...],
    zero-extended from w bytes."""
    w = b.shape[-1]
    if dtype == torch.uint8:
        return b[..., 0]
    size = torch.empty((), dtype=dtype).element_size()
    if w == size:
        # a fresh copy: a slice of a payload may sit at any byte offset
        return b.clone().view(dtype).reshape(b.shape[:-1])
    out = b[..., 0].to(dtype)
    for j in range(1, w):
        out = out | (b[..., j].to(dtype) << (8 * j))
    return out


def _byte_view(x: torch.Tensor, itemsize=None) -> torch.Tensor:
    """Flat u8 bytes of a 1-D part (bools bit-pack first)."""
    if x.dtype == torch.bool:
        x = pack_bits(x)
    return narrow_bytes(x, itemsize).reshape(-1)


def bundle_nbytes(x: torch.Tensor, itemsize=None) -> int:
    """Bytes one part contributes to a packed bundle payload."""
    if x.dtype == torch.bool:
        return 4 * packed_words(x.shape[0])
    return x.shape[0] * _width(x, itemsize)


def pack_bundle(parts, itemsizes=None) -> torch.Tensor:
    """Fuse same-length 1-D node vectors into one u8 payload: bools
    bit-packed to u32 words, every other part as its wire bytes."""
    itemsizes = itemsizes or (None,) * len(parts)
    return torch.cat([_byte_view(x, sz) for x, sz in zip(parts, itemsizes)])


def unpack_bundle(payload: torch.Tensor, like, itemsizes=None) -> list:
    """Split a pack_bundle payload back into parts shaped and typed like
    the tensors `like` (the exact inverse of pack_bundle)."""
    itemsizes = itemsizes or (None,) * len(like)
    outs, off = [], 0
    for x, sz in zip(like, itemsizes):
        nb = bundle_nbytes(x, sz)
        seg = payload[off:off + nb]
        off += nb
        if x.dtype == torch.bool:
            words = widen_bytes(seg.reshape(-1, 4), torch.int32)
            outs.append(unpack_bits(words, x.shape[0]))
        else:
            outs.append(widen_bytes(seg.reshape(-1, _width(x, sz)),
                                    x.dtype))
    return outs


def pack_slots(sel: torch.Tensor, b: int) -> torch.Tensor:
    """u32 carrier [S, WW] with at most b set bits a row -> slot indices
    [S, b] in slot_dtype(WW)'s carrier, ascending, empty entries the
    wire dtype's max.  A pass takes each row's first nonzero word and
    its lowest set bit, then clears that bit; bits past the b-th drop
    (callers pack only first-B-selected blocks)."""
    _, ww = sel.shape
    dt = slot_dtype(ww)
    sentinel = u32.carrier((1 << (8 * dt.itemsize)) - 1)
    wids = torch.arange(ww, dtype=torch.int64, device=sel.device)[None, :]
    m = sel
    cols = []
    for _ in range(b):
        nz = m != 0
        has = nz.any(dim=1)
        w = nz.to(torch.int32).argmax(dim=1).to(torch.int64)
        hit = w[:, None] == wids
        word = u32.to_u64(m.gather(1, w[:, None])[:, 0])
        low = word & (-word)
        bit = u32.popcount(u32.from_u64(low - 1)).to(torch.int64)
        slot = w * WORD + torch.where(has, bit, 0)
        cols.append(torch.where(has, slot, sentinel).to(dt.carrier))
        m = m ^ torch.where(hit, u32.from_u64(low)[:, None], 0)
    if not cols:
        return torch.zeros((sel.shape[0], 0), dtype=dt.carrier,
                           device=sel.device)
    return torch.stack(cols, dim=1)


def unpack_slots(idx: torch.Tensor, ww: int) -> torch.Tensor:
    """Slot indices [S, b] -> u32 carrier [S, ww] (the inverse of
    pack_slots on first-B-bounded input); sentinel entries (>= ww*32)
    add nothing."""
    s, b = idx.shape
    ii = (idx.to(torch.int64) if idx.dtype == torch.uint8
          else u32.to_u64(idx))
    valid = ii < ww * WORD
    col = torch.where(valid, ii // WORD, ww)
    bit = torch.where(valid, ii & (WORD - 1), 0)
    wids = torch.arange(ww, dtype=torch.int64, device=idx.device)[None, :]
    out = torch.zeros((s, ww), dtype=torch.int32, device=idx.device)
    for j in range(b):
        val = torch.where(valid[:, j], u32.from_u64(1 << bit[:, j]), 0)
        out = out | torch.where(col[:, j:j + 1] == wids, val[:, None], 0)
    return out
