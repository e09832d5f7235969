"""Wire widths of the packed waves (port of the single-device part of
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

The sharded payload itself (`pack_bits`, `pack_bundle`, `unpack_bundle`,
`pack_slots`) waits for the sharded engine (ROADMAP.md Queue 1: sharding).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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
