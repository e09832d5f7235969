"""SWIM node runtime: the event-driven protocol state machine (port of
`swim_tpu/core/node.py`).

A periodic probe loop (direct ping, then k indirect ping-reqs, then
suspect), the receive path (ping / ping-req / ack / nack / join handlers
with piggyback merge), the suspicion subprotocol with incarnation
refutation, and the Lifeguard extensions (local health aware timeouts,
nacks, buddy priority) behind cfg flags.

Time and wire are injected (Clock + Transport), so the same Node runs
many to a process over SimNetwork / SimClock (deterministic tests, the
real-node scenario arm, the bridge server) or one to a host over a UDP
transport and AsyncioClock.  Its randomness is one `random.Random(seed)`
drawn in the reference's order, so a seed gives the reference's events.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import random
from typing import Callable

from swim_tpu_torch.config import SwimConfig, log_n_of
from swim_tpu_torch.core.clock import Clock, TimerHandle
from swim_tpu_torch.core.codec import (Address, DecodeError, Message,
                                       WireUpdate, decode, encode)
from swim_tpu_torch.core.gossip import PiggybackQueue
from swim_tpu_torch.core.membership import MembershipTable
from swim_tpu_torch.obs.registry import MetricsRegistry
from swim_tpu_torch.obs.trace import Span, TraceSink
from swim_tpu_torch.types import MsgKind, Opinion, Status


class _Probe:
    __slots__ = ("target", "acked", "nacked", "timers", "started", "span")

    def __init__(self, target: int):
        self.target = target
        self.acked = False
        self.nacked = False
        self.timers: list[TimerHandle] = []
        self.started = 0.0
        self.span: Span | None = None


class _Suspicion:
    __slots__ = ("incarnation", "timer", "confirmers", "started", "span")

    def __init__(self, incarnation: int, timer: TimerHandle, started: float):
        self.incarnation = incarnation
        self.timer = timer
        self.confirmers: set[int] = set()
        self.started = started
        self.span: Span | None = None


class Node:
    def __init__(self, cfg: SwimConfig, node_id: int, transport, clock: Clock,
                 seed: int | None = None,
                 on_event: Callable[[int, Opinion | None, Opinion], None]
                 | None = None,
                 trace: TraceSink | None = None):
        self.cfg = cfg
        self.id = node_id
        self.transport = transport
        self.clock = clock
        self.rng = random.Random(seed if seed is not None else node_id)
        self.members = MembershipTable(node_id, transport.local_address,
                                       self.rng)
        if on_event is not None:
            self.members.listeners.append(on_event)
        self.gossip = PiggybackQueue(cfg.max_piggyback)
        self.lha = 0  # Lifeguard local health score
        self._probes: dict[int, _Probe] = {}
        self._relays: dict[int, tuple[Address, int, int]] = {}
        self._suspicions: dict[int, _Suspicion] = {}
        self._seq = itertools.count(1)
        self._tick_timer: TimerHandle | None = None
        self._running = False
        # observability: a typed counter/histogram registry; `stats` is a
        # dict-compatible view over its counters (aggregation in
        # utils/metrics.py; undeclared keys raise).  `trace` receives
        # probe/suspicion lifecycle spans; None = off.
        self.registry = MetricsRegistry.node_default()
        self.stats = self.registry.stats_view()
        self.trace = trace

    # ------------------------------------------------------------------ API

    def start(self, seeds: list[Address] = ()) -> None:
        self.transport.set_receiver(self._on_datagram)
        self._running = True
        for s in seeds:
            if s != self.transport.local_address:
                self._send_to_addr(s, Message(kind=MsgKind.JOIN,
                                              sender=self.id))
        # desynchronize first ticks across nodes
        delay = self.rng.uniform(0, self.cfg.protocol_period)
        self._tick_timer = self.clock.call_later(delay, self._tick)

    def stop(self) -> None:
        self._running = False
        if self._tick_timer:
            self._tick_timer.cancel()
        for p in self._probes.values():
            for t in p.timers:
                t.cancel()
        for s in self._suspicions.values():
            s.timer.cancel()
        self._probes.clear()
        self._suspicions.clear()
        self._relays.clear()

    def bootstrap(self, members: list[tuple[int, Address]]) -> None:
        """Statically seed the membership table (demo/test convenience)."""
        for mid, addr in members:
            self.members.note_member(mid, addr)

    # ---------------------------------------------------------- protocol tick

    def _tick(self) -> None:
        if not self._running:
            return
        self._tick_timer = self.clock.call_later(self.cfg.protocol_period,
                                                 self._tick)
        self.gossip.gc(self._retransmit_limit())
        target = self.members.next_probe_target()
        if target is None:
            return
        self.stats["probes"] += 1
        seq = next(self._seq)
        probe = _Probe(target)
        probe.started = self.clock.now()
        if self.trace is not None:
            probe.span = Span("probe", self.id, target, probe.started)
            probe.span.event(probe.started, "ping")
        self._probes[seq] = probe
        self._send(target, Message(kind=MsgKind.PING, sender=self.id,
                                   probe_seq=seq),
                   forced=self._buddy(target))
        probe.timers.append(self.clock.call_later(
            self._probe_timeout(), lambda: self._on_probe_timeout(seq)))
        probe.timers.append(self.clock.call_later(
            self.cfg.protocol_period * 0.95,
            lambda: self._on_probe_period_end(seq)))

    def _probe_timeout(self) -> float:
        frac = 0.3 * self.cfg.protocol_period
        if self.cfg.lifeguard:
            # LHA: an unhealthy node waits longer before fanning out
            frac *= 1.0 + self.lha / max(self.cfg.lha_max, 1)
        return min(frac, 0.9 * self.cfg.protocol_period)

    def _on_probe_timeout(self, seq: int) -> None:
        probe = self._probes.get(seq)
        if probe is None or probe.acked:
            return
        target_addr = self.members.addr(probe.target)
        if target_addr is None:
            return
        for proxy in self.members.random_members(
                self.cfg.k_indirect, {self.id, probe.target}):
            if probe.span is not None:
                probe.span.event(self.clock.now(), "ping-req")
            self._send(proxy, Message(kind=MsgKind.PING_REQ, sender=self.id,
                                      probe_seq=seq, target=probe.target,
                                      target_addr=target_addr))

    def _on_probe_period_end(self, seq: int) -> None:
        probe = self._probes.pop(seq, None)
        if probe is None:
            return
        ok = probe.acked
        if self.cfg.lifeguard:
            # Lifeguard LHA: clean round -1; failed round with zero feedback
            # +1; failed round where nacks proved our network path works: 0.
            delta = -1 if ok else (0 if probe.nacked else 1)
            self.lha = min(max(self.lha + delta, 0), self.cfg.lha_max)
        if probe.span is not None and self.trace is not None:
            self.trace.emit(probe.span.finish(self.clock.now(),
                                              "ack" if ok else "fail"))
        if ok:
            return
        self.stats["probe_failures"] += 1
        self._suspect(probe.target)

    # ----------------------------------------------------------- suspicion

    def _suspect(self, member: int) -> None:
        op = self.members.opinion(member)
        if op is None or op.status != Status.ALIVE:
            return
        new = Opinion(Status.SUSPECT, op.incarnation)
        self._apply_and_gossip(member, new)

    def _start_suspicion_timer(self, member: int, incarnation: int,
                               origin: int | None = None) -> None:
        old = self._suspicions.pop(member, None)
        if old is not None:
            old.timer.cancel()
            self._finish_suspicion(member, old, "superseded")
        timeout = self._suspicion_timeout(0)
        timer = self.clock.call_later(
            timeout, lambda: self._on_suspicion_expired(member))
        s = _Suspicion(incarnation, timer, self.clock.now())
        if origin is not None:
            s.confirmers.add(origin)
        if self.trace is not None:
            s.span = Span("suspicion", self.id, member, s.started)
        self._suspicions[member] = s
        self.stats["suspicions"] += 1

    def _finish_suspicion(self, member: int, s: _Suspicion,
                          outcome: str) -> None:
        """Record a suspicion's resolution (histogram + span)."""
        self.registry.observe("suspicion_duration_seconds",
                              self.clock.now() - s.started)
        if s.span is not None and self.trace is not None:
            self.trace.emit(s.span.finish(self.clock.now(), outcome))

    def _cancel_suspicion(self, member: int) -> None:
        """Drop a suspicion refuted/overridden by fresher gossip."""
        s = self._suspicions.pop(member, None)
        if s is None:
            return
        s.timer.cancel()
        self._finish_suspicion(member, s, "refuted")

    def _suspicion_timeout(self, confirmations: int) -> float:
        n = max(self.members.alive_count(), 2)
        base = self.cfg.suspicion_mult * log_n_of(n) * self.cfg.protocol_period
        if not (self.cfg.lifeguard and self.cfg.dynamic_suspicion):
            return base
        # Lifeguard: start high (benefit of the doubt), shrink toward the
        # vanilla floor as independent suspectors corroborate.
        max_t = base * self.cfg.suspicion_max_mult
        c_max = self.cfg.k_indirect + 1
        frac = math.log(confirmations + 1) / math.log(c_max + 1)
        return max(base, max_t - (max_t - base) * frac)

    def _confirm_suspicion(self, member: int, from_node: int,
                           incarnation: int) -> None:
        """Independent suspector seen → shrink the timer (Lifeguard).

        A claim about an older incarnation is refuted information and must
        not accelerate the current suspicion."""
        s = self._suspicions.get(member)
        if s is None or incarnation < s.incarnation \
                or from_node in s.confirmers:
            return
        s.confirmers.add(from_node)
        if s.span is not None:
            s.span.event(self.clock.now(), "confirm")
        if not (self.cfg.lifeguard and self.cfg.dynamic_suspicion):
            return
        elapsed = self.clock.now() - s.started
        # c = extra suspectors beyond the originator (docs/PROTOCOL.md §7:
        # a lone suspector waits the full max; matches rumor.py's filled-1)
        remain = self._suspicion_timeout(len(s.confirmers) - 1) - elapsed
        s.timer.cancel()
        s.timer = self.clock.call_later(
            max(remain, 0.0), lambda: self._on_suspicion_expired(member))

    def _on_suspicion_expired(self, member: int) -> None:
        s = self._suspicions.pop(member, None)
        if s is None:
            return
        op = self.members.opinion(member)
        if op is None or op.status != Status.SUSPECT:
            self._finish_suspicion(member, s, "superseded")
            return
        self.stats["deaths_declared"] += 1
        self._finish_suspicion(member, s, "confirmed")
        self._apply_and_gossip(member, Opinion(Status.DEAD, op.incarnation))

    # ------------------------------------------------------------- receive

    def _on_datagram(self, src: Address, payload: bytes) -> None:
        if not self._running:
            return
        self.stats["messages_in"] += 1
        try:
            msg = decode(payload)
        except DecodeError:
            self.stats["decode_errors"] += 1
            return
        self._merge_gossip(msg, src)
        handler = {
            MsgKind.PING: self._on_ping,
            MsgKind.PING_REQ: self._on_ping_req,
            MsgKind.ACK: self._on_ack,
            MsgKind.NACK: self._on_nack,
            MsgKind.JOIN: self._on_join,
            MsgKind.JOIN_REPLY: lambda m, a: None,  # gossip merge did it all
        }[msg.kind]
        handler(msg, src)

    def _note_and_gossip(self, member: int, addr: Address) -> None:
        """Register a directly-observed member; gossip the discovery if new
        so joins disseminate infection-style (O(log N) periods), not by
        O(N) direct contact."""
        if self.members.note_member(member, addr):
            self.gossip.enqueue(WireUpdate(member, Status.ALIVE, 0, addr,
                                           origin=self.id))

    def _on_ping(self, msg: Message, src: Address) -> None:
        self._note_and_gossip(msg.sender, src)
        self._send_to_addr(src, self._with_gossip(Message(
            kind=MsgKind.ACK, sender=self.id, probe_seq=msg.probe_seq,
            on_behalf=msg.on_behalf)))

    def _on_ping_req(self, msg: Message, src: Address) -> None:
        """Probe `msg.target` on the requester's behalf and relay the
        result."""
        self._note_and_gossip(msg.sender, src)
        sub_seq = next(self._seq)
        self._relays[sub_seq] = (src, msg.probe_seq, msg.target)
        self._send_to_addr(msg.target_addr, self._with_gossip(
            Message(kind=MsgKind.PING, sender=self.id, probe_seq=sub_seq,
                    on_behalf=msg.sender),
            forced=self._buddy(msg.target)))

        # reap the relay entry whether or not the sub-probe succeeds; under
        # Lifeguard additionally tell the requester we tried (nack)
        def expire_relay():
            if sub_seq in self._relays:
                requester, rseq, _ = self._relays.pop(sub_seq)
                if self.cfg.lifeguard:
                    self._send_to_addr(requester, self._with_gossip(Message(
                        kind=MsgKind.NACK, sender=self.id, probe_seq=rseq)))

        self.clock.call_later(self._probe_timeout(), expire_relay)

    def _on_ack(self, msg: Message, src: Address) -> None:
        relay = self._relays.pop(msg.probe_seq, None)
        if relay is not None:
            requester, rseq, _ = relay
            self._send_to_addr(requester, self._with_gossip(Message(
                kind=MsgKind.ACK, sender=self.id, probe_seq=rseq,
                on_behalf=msg.sender)))
            return
        probe = self._probes.get(msg.probe_seq)
        if probe is not None:
            if not probe.acked:
                self.registry.observe("probe_rtt_seconds",
                                      self.clock.now() - probe.started)
                if probe.span is not None:
                    probe.span.event(self.clock.now(), "ack")
            probe.acked = True

    def _on_nack(self, msg: Message, src: Address) -> None:
        # Lifeguard: feedback arrived though the probe failed — our network
        # path works, so this round must not raise local health's fail score.
        probe = self._probes.get(msg.probe_seq)
        if probe is not None:
            probe.nacked = True
            if probe.span is not None:
                probe.span.event(self.clock.now(), "nack")

    def _on_join(self, msg: Message, src: Address) -> None:
        self._note_and_gossip(msg.sender, src)
        snapshot = [
            WireUpdate(m.id, m.opinion.status, m.opinion.incarnation, m.addr,
                       origin=self.id)
            for m in self.members.members()]
        # the codec caps one gossip section at 255 updates: chunk large
        # snapshots across several JOIN_REPLY datagrams
        for i in range(0, len(snapshot), 200):
            self._send_to_addr(src, Message(
                kind=MsgKind.JOIN_REPLY, sender=self.id,
                gossip=tuple(snapshot[i:i + 200])))

    # -------------------------------------------------------------- gossip

    def _merge_gossip(self, msg: Message, src: Address) -> None:
        for u in msg.gossip:
            if u.member == self.id:
                self._handle_self_update(u)
                continue
            changed = self.members.apply(u.member, u.addr,
                                         Opinion(u.status, u.incarnation))
            if u.status == Status.SUSPECT:
                self._confirm_suspicion(u.member, u.origin, u.incarnation)
            if not changed:
                continue
            self.gossip.enqueue(u)
            if u.status == Status.SUSPECT:
                self._start_suspicion_timer(u.member, u.incarnation,
                                            origin=u.origin)
            else:
                self._cancel_suspicion(u.member)

    def _handle_self_update(self, u: WireUpdate) -> None:
        """Someone claims we are suspect/dead → refute if we can."""
        if u.status == Status.ALIVE:
            return
        if u.incarnation < self.members.incarnation and \
                u.status == Status.SUSPECT:
            return  # stale suspicion, already refuted
        if u.status == Status.DEAD:
            # sticky death cannot be refuted (docs/PROTOCOL.md §2); a real
            # deployment would rejoin with a fresh id. Keep running.
            return
        self.stats["refutations"] += 1
        new = self.members.refute()
        if self.cfg.lifeguard:
            self.lha = min(self.lha + 1, self.cfg.lha_max)
        self.gossip.enqueue(WireUpdate(self.id, new.status, new.incarnation,
                                       self.transport.local_address,
                                       origin=self.id))

    def _apply_and_gossip(self, member: int, op: Opinion) -> None:
        addr = self.members.addr(member) or ("", 0)
        if self.members.apply(member, addr, op):
            self.gossip.enqueue(WireUpdate(member, op.status, op.incarnation,
                                           addr, origin=self.id))
            if op.status == Status.SUSPECT:
                self._start_suspicion_timer(member, op.incarnation,
                                            origin=self.id)
            else:
                self._cancel_suspicion(member)

    # ---------------------------------------------------------------- wire

    def _buddy(self, target: int) -> WireUpdate | None:
        """Lifeguard buddy: when pinging a suspect, tell it so.

        Asserted from the membership table (with ourselves as origin — we do
        hold that belief), NOT from the piggyback queue: the queued entry's
        retransmit budget may be exhausted and gc'd long before the suspect
        is ever probed, and the buddy signal must survive that.
        """
        if not (self.cfg.lifeguard and self.cfg.buddy):
            return None
        op = self.members.opinion(target)
        if op is None or op.status != Status.SUSPECT:
            return None
        return WireUpdate(target, op.status, op.incarnation,
                          self.members.addr(target) or ("", 0),
                          origin=self.id)

    def _retransmit_limit(self) -> int:
        n = max(self.members.alive_count(), 2)
        return max(1, math.ceil(self.cfg.retransmit_mult * log_n_of(n)))

    def _with_gossip(self, msg: Message,
                     forced: WireUpdate | None = None) -> Message:
        sel = self.gossip.select(self._retransmit_limit())
        if forced is not None and all(u.member != forced.member
                                      for u in sel):
            kept = sel[:self.cfg.max_piggyback - 1]
            for displaced in sel[self.cfg.max_piggyback - 1:]:
                self.gossip.refund(displaced)  # charged but never sent
            sel = [forced] + kept
        return dataclasses.replace(msg, gossip=tuple(sel))

    def _send(self, member: int, msg: Message,
              forced: WireUpdate | None = None) -> None:
        addr = self.members.addr(member)
        if addr is None:
            return
        self._send_to_addr(addr, self._with_gossip(msg, forced))

    def _send_to_addr(self, addr: Address, msg: Message) -> None:
        self.stats["messages_out"] += 1
        self.transport.send(addr, encode(msg))
