"""The part of `swim_tpu/types.py` that the lattice needs.

An opinion (status, incarnation) packs into one u32 priority key,

    key = (is_dead << 31) | (incarnation << 1) | is_suspect

so the SWIM merge rule (DEAD sticky, then higher incarnation, then
SUSPECT > ALIVE) is an unsigned max over keys.
"""
from __future__ import annotations

import enum

INC_MAX = (1 << 30) - 1


class Status(enum.IntEnum):
    ALIVE = 0
    SUSPECT = 1
    DEAD = 2
