"""Membership table: statuses, incarnations, probe ordering (port of
`swim_tpu/core/membership.py`).

A node's view of the cluster: a map member -> (Opinion, address), merged
under the types.py lattice, plus SWIM's randomized round-robin probe
order: shuffle the member list, walk it, re-shuffle when exhausted;
newly learned members insert at a random position of the remaining walk
so they cannot be starved.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Iterable

from swim_tpu_torch.types import Opinion, Status, merge, supersedes

Address = tuple[str, int]


@dataclasses.dataclass
class Member:
    id: int
    addr: Address
    opinion: Opinion


class MembershipTable:
    def __init__(self, self_id: int, self_addr: Address,
                 rng: random.Random | None = None):
        self.self_id = self_id
        self.incarnation = 0          # own incarnation (grows by refutation)
        self._members: dict[int, Member] = {
            self_id: Member(self_id, self_addr, Opinion(Status.ALIVE, 0))}
        self._rng = rng or random.Random()
        self._probe_order: list[int] = []
        # hooks: fired on effective status changes (the reference's event
        # callbacks); signature (member_id, old Opinion|None, new Opinion)
        self.listeners: list[Callable[[int, Opinion | None, Opinion], None]] \
            = []

    # -- queries ------------------------------------------------------------

    def get(self, member: int) -> Member | None:
        return self._members.get(member)

    def opinion(self, member: int) -> Opinion | None:
        m = self._members.get(member)
        return m.opinion if m else None

    def addr(self, member: int) -> Address | None:
        m = self._members.get(member)
        return m.addr if m else None

    def members(self) -> list[Member]:
        return list(self._members.values())

    def ids(self, statuses: Iterable[Status] | None = None) -> list[int]:
        if statuses is None:
            return list(self._members)
        allowed = set(statuses)
        return [m.id for m in self._members.values()
                if m.opinion.status in allowed]

    def alive_count(self) -> int:
        return sum(1 for m in self._members.values()
                   if m.opinion.status != Status.DEAD)

    def __len__(self) -> int:
        return len(self._members)

    # -- mutation -----------------------------------------------------------

    def note_member(self, member: int, addr: Address) -> bool:
        """Learn a member exists (e.g. from a join) without an opinion yet.

        Returns True iff the member was new — callers gossip the discovery
        so joins disseminate infection-style in O(log N) periods rather
        than by O(N) direct contact."""
        if member not in self._members:
            self._apply_new(member, addr, Opinion(Status.ALIVE, 0))
            return True
        return False

    def apply(self, member: int, addr: Address, op: Opinion) -> bool:
        """Lattice-merge a received update. True iff it was new information.

        Self-updates are special: a SUSPECT/DEAD claim about *us* at our
        incarnation (or higher) triggers refutation handling in the Node —
        here it merges like any update so callers can inspect it.
        """
        cur = self._members.get(member)
        if cur is None:
            self._apply_new(member, addr, op)
            return True
        if not supersedes(op, cur.opinion):
            return False
        old = cur.opinion
        cur.opinion = merge(cur.opinion, op)
        if cur.addr[0] == "" and addr[0] != "":
            cur.addr = addr
        self._notify(member, old, cur.opinion)
        return True

    def refute(self) -> Opinion:
        """Bump own incarnation above any suspicion of us; returns new self
        opinion (to be gossiped)."""
        me = self._members[self.self_id]
        contested = me.opinion.incarnation
        self.incarnation = max(self.incarnation, contested) + 1
        old = me.opinion
        me.opinion = Opinion(Status.ALIVE, self.incarnation)
        self._notify(self.self_id, old, me.opinion)
        return me.opinion

    def _apply_new(self, member: int, addr: Address, op: Opinion) -> None:
        self._members[member] = Member(member, addr, op)
        # insert into the remaining probe walk at a random position so new
        # members are probed within one round (SWIM §4.3)
        if member != self.self_id:
            pos = self._rng.randint(0, len(self._probe_order))
            self._probe_order.insert(pos, member)
        self._notify(member, None, op)

    def _notify(self, member: int, old: Opinion | None, new: Opinion):
        for fn in self.listeners:
            fn(member, old, new)

    # -- probe ordering (randomized round-robin, SWIM §4.3) -----------------

    def next_probe_target(self) -> int | None:
        """Next member to probe: walk a shuffled list, skip the dead,
        re-shuffle when exhausted. None if nobody is probeable."""
        for _ in range(2):
            while self._probe_order:
                m = self._probe_order.pop()
                mem = self._members.get(m)
                if mem is not None and mem.opinion.status != Status.DEAD:
                    return m
            fresh = [m.id for m in self._members.values()
                     if m.id != self.self_id
                     and m.opinion.status != Status.DEAD]
            self._rng.shuffle(fresh)
            self._probe_order = fresh
            if not fresh:
                return None
        return None

    def random_members(self, k: int, exclude: set[int]) -> list[int]:
        """k distinct members for indirect probing, excluding the given ids
        and the dead."""
        pool = [m.id for m in self._members.values()
                if m.id not in exclude and m.id != self.self_id
                and m.opinion.status != Status.DEAD]
        self._rng.shuffle(pool)
        return pool[:k]
