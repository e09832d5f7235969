"""Membership-state lattice on int32 carriers (port of
`swim_tpu/ops/lattice.py`).

    key = dead << 31 | inc << 1 | suspect

DEAD lives in bit 31, the carrier's sign bit: every comparison or max
over keys goes through the unsigned helpers of ops/u32.py.
"""
from __future__ import annotations

import torch

from swim_tpu_torch.ops import u32
from swim_tpu_torch.types import INC_MAX, Status


def pack(status, incarnation: torch.Tensor) -> torch.Tensor:
    """status (int tensor or int), incarnation (u32 carrier) -> key."""
    inc = torch.where(u32.ugt(incarnation, INC_MAX),
                      torch.full_like(incarnation, INC_MAX), incarnation)
    if isinstance(status, torch.Tensor):
        dead = torch.where(status == Status.DEAD, u32.SIGN, 0)
        suspect = (status == Status.SUSPECT).to(torch.int32)
        return (dead.to(torch.int32) | (inc << 1) | suspect).to(torch.int32)
    # an int status stays on the host: a tensor made from it would be
    # copied to the card, and that copy waits for the card
    dead = u32.SIGN if status == Status.DEAD else 0
    return ((inc << 1) | dead | int(status == Status.SUSPECT)).to(torch.int32)


def merge(a: torch.Tensor, b) -> torch.Tensor:
    """Lattice join: the unsigned max over packed keys (a signed max
    would rank a DEAD key, bit 31 set, below every live one)."""
    return u32.umax(a, b)


def is_dead(key: torch.Tensor) -> torch.Tensor:
    return key < 0


def is_suspect(key: torch.Tensor) -> torch.Tensor:
    return ~is_dead(key) & ((key & 1) == 1)


def status_of(key: torch.Tensor) -> torch.Tensor:
    """uint8 Status of each key."""
    return torch.where(
        is_dead(key), int(Status.DEAD),
        torch.where((key & 1) == 1, int(Status.SUSPECT),
                    int(Status.ALIVE))).to(torch.uint8)


def incarnation_of(key: torch.Tensor) -> torch.Tensor:
    return (key >> 1) & INC_MAX


def alive_key(incarnation: torch.Tensor) -> torch.Tensor:
    return pack(int(Status.ALIVE), incarnation)


def suspect_key(incarnation: torch.Tensor) -> torch.Tensor:
    return pack(int(Status.SUSPECT), incarnation)


def dead_key(incarnation: torch.Tensor) -> torch.Tensor:
    return pack(int(Status.DEAD), incarnation)
