"""Protocol types and the opinion lattice (port of `swim_tpu/types.py`):
pure Python ints.

An opinion (status, incarnation) packs into one u32 priority key,

    key = (is_dead << 31) | (incarnation << 1) | is_suspect

so the SWIM merge rule (DEAD sticky, then higher incarnation, then
SUSPECT > ALIVE) is an unsigned max over keys.  The wire half
(`Opinion`, `Update`, `MsgKind` and the key helpers) serves the codec
(core/codec.py) and the serving hub (serve/hub.py).
"""
from __future__ import annotations

import dataclasses
import enum

INC_MAX = (1 << 30) - 1


class Status(enum.IntEnum):
    ALIVE = 0
    SUSPECT = 1
    DEAD = 2


@dataclasses.dataclass(frozen=True)
class Opinion:
    """One node's belief about one member.  Not orderable: precedence is
    `merge` / `key()`, which a lexicographic order would contradict."""

    status: Status
    incarnation: int

    def key(self) -> int:
        return opinion_key(int(self.status), self.incarnation)


def opinion_key(status: int, incarnation: int) -> int:
    """Total-order key; the lattice join is the max over keys."""
    inc = min(incarnation, INC_MAX)
    if status == Status.DEAD:
        return (1 << 31) | (inc << 1)
    return (inc << 1) | (1 if status == Status.SUSPECT else 0)


def key_status(key: int) -> int:
    if key >> 31:
        return int(Status.DEAD)
    return int(Status.SUSPECT) if (key & 1) else int(Status.ALIVE)


def key_incarnation(key: int) -> int:
    return (key >> 1) & INC_MAX


def merge(a: Opinion, b: Opinion) -> Opinion:
    """Lattice join of two opinions (associative, commutative,
    idempotent)."""
    return a if a.key() >= b.key() else b


def supersedes(a: Opinion, b: Opinion) -> bool:
    """True iff learning `a` changes a view holding `b` (new
    information, which resets an update's retransmit count)."""
    return a.key() > b.key()


@dataclasses.dataclass(frozen=True)
class Update:
    """A membership update as gossip carries it: member + opinion."""

    member: int
    status: Status
    incarnation: int

    @property
    def opinion(self) -> Opinion:
        return Opinion(self.status, self.incarnation)


class MsgKind(enum.IntEnum):
    """Wire message kinds."""

    PING = 0
    PING_REQ = 1
    ACK = 2
    NACK = 3        # Lifeguard: explicit negative ack from a probe relay
    JOIN = 4        # join request to a seed
    JOIN_REPLY = 5  # membership snapshot
