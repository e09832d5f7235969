"""Gossip piggyback queue: bounded infection-style dissemination (port
of `swim_tpu/core/gossip.py`).

Recent membership updates ride on every outgoing ping and ack.  Each
update is retransmitted a bounded number of times (lambda * log N sends
reach everyone w.h.p.); selection prefers the least-retransmitted
(freshest) updates, ties by member id: the rule the engines implement.
"""

from __future__ import annotations

import dataclasses

from swim_tpu_torch.core.codec import WireUpdate

Address = tuple[str, int]


@dataclasses.dataclass
class _Entry:
    update: WireUpdate
    transmits: int = 0


class PiggybackQueue:
    def __init__(self, max_piggyback: int):
        self.max_piggyback = max_piggyback
        self._entries: dict[int, _Entry] = {}   # member → freshest update

    def enqueue(self, update: WireUpdate) -> None:
        """Queue new information about a member (replaces any older entry,
        resetting its retransmit budget)."""
        self._entries[update.member] = _Entry(update)

    def select(self, limit: int) -> list[WireUpdate]:
        """Pick ≤ max_piggyback updates still under the retransmit `limit`,
        fewest-transmits-first (ties by member id); counts the sends.

        Lifeguard's buddy priority is NOT handled here: buddy updates are
        asserted from the membership table by the Node (they must survive
        this queue's budget exhaustion and gc).
        """
        live = [e for e in self._entries.values() if e.transmits < limit]
        live.sort(key=lambda e: (e.transmits, e.update.member))
        sel = live[:self.max_piggyback]
        for e in sel:
            e.transmits += 1
        return [e.update for e in sel]

    def refund(self, update: WireUpdate) -> None:
        """Un-count one send of an update that was selected but then
        displaced from the outgoing message (Lifeguard buddy force)."""
        e = self._entries.get(update.member)
        if e is not None and e.update == update and e.transmits > 0:
            e.transmits -= 1

    def gc(self, limit: int) -> None:
        """Drop entries whose retransmit budget is exhausted."""
        self._entries = {m: e for m, e in self._entries.items()
                         if e.transmits < limit}

    def __len__(self) -> int:
        return len(self._entries)
