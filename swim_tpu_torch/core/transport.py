"""The transport seam (port of `swim_tpu/core/transport.py`).

A datagram transport: fire-and-forget sends, one receiver callback.
Addresses are opaque `(host, port)` tuples; the in-process network uses
("sim", node_id).  Implementations:

  * `InProcessTransport` over a `SimNetwork`: a deterministic in-memory
    network for many nodes in one process, with injectable loss,
    partitions, per-link latency, duplication and stale replay, driven
    by a `SimClock`;
  * `UDPTransport`: asyncio datagrams for real clusters;
  * native/transport.py's `NativeUDPTransport`: the udppump datapath
    (the serving hub's frontend);
  * bridge/client.py's `BridgeTransport`: the lockstep bridge's wire.
"""
from __future__ import annotations

import abc
import random
from typing import Callable

from swim_tpu_torch.core.clock import SimClock

Address = tuple[str, int]
Receiver = Callable[[Address, bytes], None]


class Transport(abc.ABC):
    """Datagram-style message transport (unreliable, unordered is
    allowed)."""

    @abc.abstractmethod
    def send(self, to: Address, payload: bytes) -> None:
        """Fire-and-forget send; loss is legal and expected."""

    @abc.abstractmethod
    def set_receiver(self, receiver: Receiver) -> None:
        """Register the inbound callback (sender address, payload)."""

    @property
    @abc.abstractmethod
    def local_address(self) -> Address:
        ...

    def close(self) -> None:
        pass


class SimNetwork:
    """Shared medium for InProcessTransport endpoints.

    Delivery is scheduled on the SimClock (default latency 1 ms), so
    message interleavings are deterministic given the seed.
    """

    def __init__(self, clock: SimClock, seed: int = 0, loss: float = 0.0,
                 latency: float = 0.001, duplicate: float = 0.0,
                 replay: float = 0.0, replay_buffer: int = 256):
        self.clock = clock
        self.rng = random.Random(seed)
        self.loss = loss
        self.latency = latency
        # adversarial delivery (sim/scenario.py replay_storm): `duplicate`
        # is the probability a delivered datagram arrives twice; `replay`
        # the probability each transmit additionally re-delivers a random
        # STALE datagram (same src/dst as when first sent, old
        # incarnations included) from a bounded history.  Both ride the
        # same seeded rng and clock, so runs stay deterministic.  The
        # decode path must be idempotent under both (core/node.py merges
        # are monotone lattice joins).
        self.duplicate = duplicate
        self.replay = replay
        self._replay_buffer = replay_buffer
        self._history: list[tuple[Address, Address, bytes]] = []
        self._link_latency: dict[frozenset[Address], float] = {}
        self._endpoints: dict[Address, "InProcessTransport"] = {}
        self._cut: set[frozenset[Address]] = set()
        self._down: set[Address] = set()
        self.sent = 0
        self.delivered = 0
        self.duplicated = 0
        self.replayed = 0

    def attach(self, ep: "InProcessTransport") -> None:
        self._endpoints[ep.local_address] = ep

    def detach(self, addr: Address) -> None:
        """Remove an endpoint; traffic to it is dropped from now on."""
        self._endpoints.pop(addr, None)

    # -- fault injection ----------------------------------------------------

    def set_loss(self, loss: float) -> None:
        self.loss = loss

    def set_link_latency(self, a: Address, b: Address,
                         seconds: float) -> None:
        """Override the default latency for one (undirected) link, e.g. a
        slow WAN pair in an otherwise-LAN cluster."""
        self._link_latency[frozenset((a, b))] = seconds

    def cut(self, a: Address, b: Address) -> None:
        self._cut.add(frozenset((a, b)))

    def heal(self, a: Address, b: Address) -> None:
        self._cut.discard(frozenset((a, b)))

    def partition(self, group_a: list[Address], group_b: list[Address]):
        for a in group_a:
            for b in group_b:
                self.cut(a, b)

    def heal_all(self) -> None:
        self._cut.clear()

    def kill(self, addr: Address) -> None:
        """Crash-stop a node: its endpoint neither sends nor receives."""
        self._down.add(addr)

    # -- delivery -----------------------------------------------------------

    def transmit(self, src: Address, dst: Address, payload: bytes) -> None:
        self.sent += 1
        if self.replay and self._history:
            # stale replay rides on traffic: each transmit may re-deliver
            # one random datagram from the bounded history (possibly
            # carrying an out-of-date incarnation)
            if self.rng.random() < self.replay:
                rsrc, rdst, rpayload = self._history[
                    self.rng.randrange(len(self._history))]
                self.replayed += 1
                self._schedule(rsrc, rdst, rpayload)
        if src in self._down or dst in self._down:
            return
        if frozenset((src, dst)) in self._cut:
            return
        if self.loss and self.rng.random() < self.loss:
            return
        if self.duplicate or self.replay:
            self._history.append((src, dst, payload))
            if len(self._history) > self._replay_buffer:
                del self._history[:len(self._history) - self._replay_buffer]
        self._schedule(src, dst, payload)
        if self.duplicate and self.rng.random() < self.duplicate:
            self.duplicated += 1
            self._schedule(src, dst, payload)

    def _schedule(self, src: Address, dst: Address,
                  payload: bytes) -> None:
        if dst in self._down or frozenset((src, dst)) in self._cut:
            return
        ep = self._endpoints.get(dst)
        if ep is None:
            return

        def deliver():
            if dst in self._down:
                return
            self.delivered += 1
            if ep._receiver is not None:
                ep._receiver(src, payload)

        lat = self._link_latency.get(frozenset((src, dst)), self.latency)
        self.clock.call_later(lat, deliver)


class InProcessTransport(Transport):
    """Loopback transport instance backing multi-node single-process runs."""

    def __init__(self, network: SimNetwork, node_id: int):
        self._network = network
        self._addr: Address = ("sim", node_id)
        self._receiver: Receiver | None = None
        network.attach(self)

    def send(self, to: Address, payload: bytes) -> None:
        self._network.transmit(self._addr, to, payload)

    def set_receiver(self, receiver: Receiver) -> None:
        self._receiver = receiver

    @property
    def local_address(self) -> Address:
        return self._addr


class UDPTransport(Transport):
    """Real-network transport over asyncio UDP datagrams.

    Create with `await UDPTransport.create(host, port)` inside a running
    loop; pairs with core/clock.py's AsyncioClock.
    """

    def __init__(self, transport, local: Address):
        self._transport = transport
        self._local = local
        self._receiver: Receiver | None = None

    @classmethod
    async def create(cls, host: str = "127.0.0.1", port: int = 0):
        import asyncio

        loop = asyncio.get_running_loop()
        self_holder: dict = {}

        class _Proto(asyncio.DatagramProtocol):
            def datagram_received(_, data: bytes, addr):
                t = self_holder.get("t")
                if t is not None and t._receiver is not None:
                    t._receiver((addr[0], addr[1]), data)

        transport, _ = await loop.create_datagram_endpoint(
            _Proto, local_addr=(host, port))
        sock = transport.get_extra_info("sockname")
        t = cls(transport, (sock[0], sock[1]))
        self_holder["t"] = t
        return t

    def send(self, to: Address, payload: bytes) -> None:
        self._transport.sendto(payload, to)

    def set_receiver(self, receiver: Receiver) -> None:
        self._receiver = receiver

    @property
    def local_address(self) -> Address:
        return self._local

    def close(self) -> None:
        self._transport.close()
